"""WebHDFS-compatible REST gateway (HttpFS).

Port of `ozone_tpu/gateway/httpfs.py` (the reference's httpfsgateway,
HttpFSServerWebServer: a WebHDFS REST facade over the Ozone filesystem
adapter). Serves the standard `/webhdfs/v1/<path>?op=...` verbs over the
cluster-rooted filesystem (gateway/fs.py:RootedOzoneFileSystem):

  GET    OPEN (offset/length), GETFILESTATUS, LISTSTATUS,
         LISTSTATUS_BATCH (paged), GETCONTENTSUMMARY, GETFILECHECKSUM,
         GETXATTRS (text/hex/base64 encodings), LISTXATTRS,
         GETHOMEDIRECTORY, GETTRASHROOT, GETQUOTAUSAGE,
         GETFILEBLOCKLOCATIONS (?offset/?length range filtering)
  PUT    CREATE (two-step 307 redirect per the WebHDFS spec, or direct
         with ?data=true), MKDIRS, RENAME (destination=),
         SETPERMISSION, SETOWNER, SETTIMES, SETXATTR (CREATE/REPLACE
         flags), REMOVEXATTR
  POST   APPEND (two-step 307, read-modify-write re-put underneath:
         keys are immutable on the datapath), TRUNCATE (newlength=)
  DELETE DELETE (recursive=, skiptrash=)

  GET    GETACLSTATUS (the native ACL grants in Hadoop's AclEntry
         grammar), CHECKACCESS (?fsaction=rwx, the OM's authorizer)

Responses follow the WebHDFS JSON schema (FileStatus.type FILE/DIRECTORY,
modificationTime in ms, RemoteException envelope on errors). The verbs
that need snapshots (CREATESNAPSHOT, RENAMESNAPSHOT, DELETESNAPSHOT,
GETSNAPSHOTDIFF) answer 501 with an UnsupportedOperationException:
snapshots are not ported yet. Encrypted buckets (the KMS) and TLS are
the next slice.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, quote, unquote, urlparse

from ozone_tpu_torch.gateway.fs import FileStatus, RootedOzoneFileSystem
from ozone_tpu_torch.om.requests import OMError
from ozone_tpu_torch.storage.ids import StorageError

log = logging.getLogger(__name__)

PREFIX = "/webhdfs/v1"


def _child_name(st: FileStatus) -> str:
    """The one name-derivation rule: pathSuffix values clients echo
    back as startAfter must match what the paging filter compares."""
    return st.path.rstrip("/").rpartition("/")[2]


def _status_json(st: FileStatus, suffix_only: bool = False) -> dict:
    name = _child_name(st) if suffix_only else ""
    a = st.attrs or {}
    atime = a.get("atime", st.modification_time)
    return {
        "pathSuffix": name,
        "type": "DIRECTORY" if st.is_dir else "FILE",
        "length": st.length,
        "modificationTime": int(st.modification_time * 1000),
        "accessTime": int(atime * 1000),
        "blockSize": 16 * 1024 * 1024,
        "replication": 1,
        "permission": a.get("permission",
                            "755" if st.is_dir else "644"),
        "owner": a.get("owner", "ozone"),
        "group": a.get("group", "ozone"),
    }


class HttpFSGateway:
    def __init__(self, client, host: str = "127.0.0.1", port: int = 0,
                 replication: Optional[str] = None,
                 trash_interval_s: Optional[float] = None):
        self.fs = RootedOzoneFileSystem(client, replication=replication)
        #: trash emptier cadence (TrashPolicyOzone's fs.trash.interval):
        #: every interval, Current rotates into a checkpoint and
        #: checkpoints older than the interval are purged. None = the
        #: operator runs trash_checkpoint/trash_expunge manually.
        self.trash_interval_s = trash_interval_s
        self._trash_stop = threading.Event()
        self._trash_thread: Optional[threading.Thread] = None
        gateway = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                log.debug("httpfs: " + fmt, *args)

            def _reply(self, status: int, body: bytes = b"",
                       headers: Optional[dict] = None,
                       content_type: str = "application/json"):
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if body:
                    self.wfile.write(body)

            def _json(self, status: int, obj: dict):
                self._reply(status, json.dumps(obj).encode())

            def _body(self) -> bytes:
                n = int(self.headers.get("Content-Length", 0))
                return self.rfile.read(n) if n else b""

            def do_GET(self):
                gateway._route(self, "GET")

            def do_PUT(self):
                gateway._route(self, "PUT")

            def do_POST(self):
                gateway._route(self, "POST")

            def do_DELETE(self):
                gateway._route(self, "DELETE")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_port
        self.host = host
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="httpfs", daemon=True
        )
        self._thread.start()
        if self.trash_interval_s:
            self._trash_thread = threading.Thread(
                target=self._trash_loop, name="trash-emptier",
                daemon=True)
            self._trash_thread.start()

    def run_trash_emptier_once(self) -> list[str]:
        """One emptier tick (the loop body; tests drive this): rotate
        Current, purge checkpoints past the interval."""
        self.fs.trash_checkpoint()
        return self.fs.trash_expunge(self.trash_interval_s or 0)

    def _trash_loop(self) -> None:
        while not self._trash_stop.wait(self.trash_interval_s):
            try:
                self.run_trash_emptier_once()
            except Exception:
                log.exception("trash emptier tick failed; will retry")

    def stop(self) -> None:
        self._trash_stop.set()
        if self._trash_thread:
            self._trash_thread.join(timeout=2.0)
        self._httpd.shutdown()
        self._httpd.server_close()

    # ----------------------------------------------------------------- route
    @staticmethod
    def _exception(status: int, exc: str, msg: str) -> tuple[int, dict]:
        return status, {
            "RemoteException": {
                "exception": exc,
                "javaClassName": f"java.io.{exc}",
                "message": msg,
            }
        }

    #: verbs of a module not ported yet: snapshots
    UNSUPPORTED = {
        ("GET", "GETSNAPSHOTDIFF"), ("PUT", "CREATESNAPSHOT"),
        ("PUT", "RENAMESNAPSHOT"), ("DELETE", "DELETESNAPSHOT"),
    }

    def _route(self, h, method: str) -> None:
        u = urlparse(h.path)
        if not u.path.startswith(PREFIX):
            h._json(*self._exception(404, "FileNotFoundException", u.path))
            return
        path = unquote(u.path[len(PREFIX):]) or "/"
        q = parse_qs(u.query, keep_blank_values=True)
        op = q.get("op", [""])[0].upper()
        if (method, op) in self.UNSUPPORTED:
            h._json(*self._exception(
                501, "UnsupportedOperationException",
                f"{method} op={op} is not supported by this gateway"))
            return
        try:
            handler = getattr(self, f"_op_{method.lower()}_{op.lower()}",
                              None)
            if handler is None:
                h._json(*self._exception(
                    400, "UnsupportedOperationException",
                    f"{method} op={op}"))
                return
            handler(h, path, q)
        except FileNotFoundError as e:
            h._json(*self._exception(404, "FileNotFoundException", str(e)))
        except ValueError as e:
            # malformed numeric query params (newlength=abc) are client
            # errors, not server faults
            h._json(*self._exception(400, "IllegalArgumentException",
                                     str(e)))
        except (IsADirectoryError, OSError) as e:
            h._json(*self._exception(403, "IOException", str(e)))
        except (OMError, StorageError) as e:
            h._json(*self._exception(403, "IOException", str(e)))
        except Exception as e:  # noqa: BLE001
            log.exception("httpfs %s %s failed", method, h.path)
            h._json(*self._exception(500, "RuntimeException", str(e)))

    # ----------------------------------------------------------------- GET
    def _op_get_open(self, h, path: str, q) -> None:
        offset = int(q.get("offset", ["0"])[0])
        length = q.get("length", [None])[0]
        # positioned read: only the covering cells/chunks move (the
        # whole-file materialization is gone from the OPEN path)
        data = self.fs.read_range(
            path, offset, int(length) if length is not None else None)
        h._reply(200, data, content_type="application/octet-stream")

    def _op_get_getfilestatus(self, h, path: str, q) -> None:
        st = self.fs.get_file_status(path)
        h._json(200, {"FileStatus": _status_json(st)})

    def _op_get_liststatus(self, h, path: str, q) -> None:
        sts = self.fs.list_status(path)
        h._json(200, {
            "FileStatuses": {
                "FileStatus": [_status_json(s, suffix_only=True)
                               for s in sts]
            }
        })

    def _op_get_liststatus_batch(self, h, path: str, q) -> None:
        """Paged listing (WebHDFS LISTSTATUS_BATCH): resumes after
        ?startAfter=<childName> and reports how many entries remain —
        huge directories stream in bounded pages instead of one
        response."""
        batch = int(q.get("batchsize", ["1000"])[0])
        if batch <= 0:
            raise ValueError(f"batchsize must be positive: {batch}")
        start_after = q.get("startAfter", [""])[0]
        page, more = self.fs.list_status_page(
            path, start_after=start_after, limit=batch)
        h._json(200, {
            "DirectoryListing": {
                "partialListing": {
                    "FileStatuses": {
                        "FileStatus": [
                            _status_json(s, suffix_only=True)
                            for s in page
                        ]
                    }
                },
                # WebHDFS reports a remaining COUNT; computing it
                # exactly would walk the rest of the directory, so a
                # bounded server reports 1 as "more exist" (clients
                # only test for zero)
                "remainingEntries": 1 if more else 0,
            }
        })

    def _op_get_getcontentsummary(self, h, path: str, q) -> None:
        files = dirs = length = 0
        stack = [path]
        while stack:
            p = stack.pop()
            st = self.fs.get_file_status(p)
            if st.is_dir:
                dirs += 1
                stack.extend(
                    "/" + c.path for c in self.fs.list_status(p)
                )
            else:
                files += 1
                length += st.length
        h._json(200, {
            "ContentSummary": {
                "directoryCount": dirs,
                "fileCount": files,
                "length": length,
                "quota": -1,
                "spaceConsumed": length,
                "spaceQuota": -1,
            }
        })

    def _op_get_getfilechecksum(self, h, path: str, q) -> None:
        ck = self.fs.checksum(path)
        h._json(200, {
            "FileChecksum": {
                "algorithm": ck["algorithm"],
                "bytes": ck["checksum"],
                # WebHDFS: length of the checksum BLOB, not the file
                # (Hadoop FileChecksum deserialization depends on it)
                "length": len(ck["checksum"]) // 2,
            }
        })

    def _op_get_gethomedirectory(self, h, path: str, q) -> None:
        user = q.get("user.name", ["anonymous"])[0]
        h._json(200, {"Path": f"/user/{user}"})

    def _op_get_gettrashroot(self, h, path: str, q) -> None:
        """Per-bucket trash root (TrashPolicyOzone getTrashRoot:
        /<vol>/<bucket>/.Trash/<user>)."""
        user = q.get("user.name", ["anonymous"])[0]
        vol, bkt, _ = self.fs._resolve(path)
        if not (vol and bkt):
            raise OSError(f"no bucket in path {path!r}")
        h._json(200, {"Path": f"/{vol}/{bkt}/{self.fs.TRASH}/{user}"})

    def _op_get_getquotausage(self, h, path: str, q) -> None:
        """Bucket quota + usage counters (GETQUOTAUSAGE; the OM tracks
        used_bytes/key_count live on the bucket row)."""
        vol, bkt, _ = self.fs._resolve(path)
        if not (vol and bkt):
            raise OSError(f"no bucket in path {path!r}")
        b = self.fs.client.om.bucket_info(vol, bkt)
        h._json(200, {
            "QuotaUsage": {
                "fileAndDirectoryCount": int(b.get("key_count", 0)),
                "quota": int(b.get("quota_namespace", -1)),
                "spaceConsumed": int(b.get("used_bytes", 0)),
                "spaceQuota": int(b.get("quota_bytes", -1)),
            }
        })

    #: attrs-dict prefix holding user xattrs; the raw xattr name (which
    #: legally contains dots) survives verbatim after the prefix
    XATTR = "xattr:"

    def _xattrs_of(self, path: str) -> dict:
        st = self.fs.get_file_status(path)
        a = st.attrs or {}
        return {k[len(self.XATTR):]: v for k, v in a.items()
                if k.startswith(self.XATTR)}

    def _op_get_getxattrs(self, h, path: str, q) -> None:
        """GETXATTRS: all xattrs, or the ?xattr.name= selection. Values
        answer in the requested ?encoding= (text quotes them, hex/base64
        encode the bytes — the WebHDFS XAttr JSON contract)."""
        import base64

        xattrs = self._xattrs_of(path)
        names = q.get("xattr.name", [])
        if names:
            missing = [n for n in names if n not in xattrs]
            if missing:
                raise OSError(f"xattr not found: {missing}")
            xattrs = {n: xattrs[n] for n in names}
        enc = q.get("encoding", ["text"])[0].lower()

        def encode(v: str):
            raw = v.encode()
            if enc == "hex":
                return "0x" + raw.hex()
            if enc == "base64":
                return base64.b64encode(raw).decode()
            return json.dumps(v)  # text: quoted string

        h._json(200, {"XAttrs": [
            {"name": n, "value": encode(v)}
            for n, v in sorted(xattrs.items())
        ]})

    def _op_get_listxattrs(self, h, path: str, q) -> None:
        # WebHDFS quirk: XAttrNames is a JSON array SERIALIZED AS A
        # STRING inside the JSON response
        h._json(200, {
            "XAttrNames": json.dumps(sorted(self._xattrs_of(path)))
        })

    def _op_get_getaclstatus(self, h, path: str, q) -> None:
        """GETACLSTATUS: the native ACL grants of the key (or bucket at
        depth 2) rendered in the WebHDFS AclStatus shape. Entry strings
        follow Hadoop's AclEntry grammar: ACCESS scope has NO prefix,
        DEFAULT scope is 'default:'; entry types are limited to
        user/group/other (native WORLD grants map to 'other')."""
        st = self.fs.get_file_status(path)  # 404 on missing, first
        vol, bkt, rest = self.fs._resolve(path)
        om = self.fs.client.om
        if bkt and rest:
            acls = om.get_acls("key", vol, bkt, rest)
        elif bkt:
            acls = om.get_acls("bucket", vol, bkt)
        else:
            acls = om.get_acls("volume", vol)
        entries = []
        for g in acls:
            prefix = "default:" if g.get("scope") == "DEFAULT" else ""
            gtype = g.get("type", "user").lower()
            name = g.get("name", "")
            if gtype not in ("user", "group"):
                gtype, name = "other", ""  # WORLD and friends
            # native rights (r/w/l/...) condense to the rwx triad
            rights = "".join(g.get("rights", []))
            perm = ("r" if any(c in rights for c in "rl") else "-") + \
                   ("w" if any(c in rights for c in "wcd") else "-") + "-"
            entries.append(f"{prefix}{gtype}:{name}:{perm}")
        fj = _status_json(st)
        h._json(200, {"AclStatus": {
            "owner": fj["owner"],
            "group": fj["group"],
            "permission": fj["permission"],
            "stickyBit": False,
            "entries": entries,
        }})

    def _op_get_checkaccess(self, h, path: str, q) -> None:
        """CHECKACCESS (?fsaction=rwx): 200 when the caller holds the
        asked rights, AccessControlException otherwise."""
        action = q.get("fsaction", ["r--"])[0]
        user = q.get("user.name", [None])[0]
        vol, bkt, rest = self.fs._resolve(path)
        if not vol:
            raise OSError(f"no volume in path {path!r}")
        self.fs.get_file_status(path)  # 404 on missing
        om = self.fs.client.om
        try:
            wanted = []
            if "r" in action:
                wanted.append("READ")
            if "w" in action:
                wanted.append("WRITE")
            if "x" in action:
                wanted.append("LIST")
            for right in wanted:
                om.check_access(vol, bkt or None, rest or None, right,
                                user=user)
        except (OMError, StorageError) as e:
            # PERMISSION_DENIED locally; the same code rides the rpc
            # detail as a StorageError from a remote OM
            if "PERMISSION_DENIED" not in str(e):
                raise
            h._json(*self._exception(403, "AccessControlException",
                                     str(e)))
            return
        h._reply(200)

    def _op_get_getfileblocklocations(self, h, path: str, q) -> None:
        """GETFILEBLOCKLOCATIONS (?offset=&length=): the key's block
        groups intersecting the byte range, rendered as BlockLocations
        (hosts = the group's datanodes; EC groups list every unit
        holder). Range-aware clients (DistCp splits) pass offset/length
        per split."""
        st = self.fs.get_file_status(path)  # 404 on missing, first
        if st.is_dir:
            raise OSError(f"not a file path: {path!r}")
        vol, bkt, rest = self.fs._resolve(path)
        om = self.fs.client.om
        info = om.lookup_key(vol, bkt, rest)
        groups = om.key_block_groups(info)
        want_off = int(q.get("offset", ["0"])[0])
        length = q.get("length", [None])[0]
        want_end = (want_off + int(length)) if length is not None \
            else float("inf")
        locs = []
        offset = 0
        for g in groups:
            if offset < want_end and offset + g.length > want_off:
                hosts = [n for n in g.pipeline.nodes if n]
                locs.append({
                    "offset": offset,
                    "length": g.length,
                    "hosts": hosts,
                    "names": hosts,
                    "topologyPaths": [],
                    "corrupt": False,
                })
            offset += g.length
        h._json(200, {"BlockLocations": {"BlockLocation": locs}})

    # ----------------------------------------------------------------- PUT
    def _op_put_setxattr(self, h, path: str, q) -> None:
        """SETXATTR with the CREATE/REPLACE flag semantics of the
        WebHDFS contract: CREATE refuses an existing name, REPLACE
        refuses a missing one, no flag upserts. The flag check rides
        the request as a precondition evaluated inside the OM's
        serialized apply — a gateway-side read-then-write would race
        concurrent setters (even across httpfs daemons)."""
        name = q.get("xattr.name", [""])[0]
        if not name:
            raise OSError("xattr.name required")
        flag = q.get("flag", [""])[0].upper()
        preconds = ({self.XATTR + name: False} if flag == "CREATE"
                    else {self.XATTR + name: True} if flag == "REPLACE"
                    else None)
        value = q.get("xattr.value", [""])[0]
        self.fs.set_attrs(path, {self.XATTR + name: value},
                          preconds=preconds)
        h._reply(200)

    def _op_put_removexattr(self, h, path: str, q) -> None:
        name = q.get("xattr.name", [""])[0]
        if not name:
            raise OSError("xattr.name required")
        self.fs.set_attrs(path, {self.XATTR + name: None},
                          preconds={self.XATTR + name: True})
        h._reply(200)

    def _op_put_setpermission(self, h, path: str, q) -> None:
        import re

        perm = q.get("permission", ["755"])[0]
        # strictly octal: WebHDFS clients parse this as FsPermission and
        # a stored "999" would poison every later list/stat of the path
        if not re.fullmatch(r"[0-7]{3,4}", perm):
            raise OSError(f"bad permission {perm!r}")
        self.fs.set_attrs(path, {"permission": perm})
        h._reply(200)

    def _op_put_setowner(self, h, path: str, q) -> None:
        attrs = {}
        owner = q.get("owner", [""])[0]
        group = q.get("group", [""])[0]
        if owner:
            attrs["owner"] = owner
        if group:
            attrs["group"] = group
        if not attrs:
            raise OSError("owner or group required")
        self.fs.set_attrs(path, attrs)
        h._reply(200)

    def _op_put_settimes(self, h, path: str, q) -> None:
        # WebHDFS times are epoch millis; -1 means leave unchanged
        attrs = {}
        mtime = int(q.get("modificationtime", ["-1"])[0])
        atime = int(q.get("accesstime", ["-1"])[0])
        if mtime >= 0:
            attrs["mtime"] = mtime / 1000.0
        if atime >= 0:
            attrs["atime"] = atime / 1000.0
        if attrs:
            self.fs.set_attrs(path, attrs)
        h._reply(200)

    def _op_put_create(self, h, path: str, q) -> None:
        if q.get("data", ["false"])[0] != "true":
            # WebHDFS two-step: redirect the client to the data endpoint
            # (path was unquoted in _route; re-encode it for the header)
            loc = (f"http://{self.address}{PREFIX}{quote(path)}?op=CREATE&"
                   f"data=true&overwrite="
                   f"{q.get('overwrite', ['true'])[0]}")
            h._reply(307, headers={"Location": loc})
            return
        overwrite = q.get("overwrite", ["true"])[0] == "true"
        self.fs.create(path, h._body(), overwrite=overwrite)
        h._reply(201)

    def _op_put_mkdirs(self, h, path: str, q) -> None:
        self.fs.mkdirs(path)
        h._json(200, {"boolean": True})

    def _op_put_rename(self, h, path: str, q) -> None:
        dst = q.get("destination", [""])[0]
        if not dst:
            raise OSError("destination required")
        self.fs.rename(path, dst)
        h._json(200, {"boolean": True})

    # ----------------------------------------------------------------- POST
    def _op_post_append(self, h, path: str, q) -> None:
        if q.get("data", ["false"])[0] != "true":
            # WebHDFS two-step, same shape as CREATE
            loc = (f"http://{self.address}{PREFIX}{quote(path)}"
                   f"?op=APPEND&data=true")
            h._reply(307, headers={"Location": loc})
            return
        self.fs.append(path, h._body())
        h._reply(200)

    def _op_post_truncate(self, h, path: str, q) -> None:
        new_length = int(q.get("newlength", ["0"])[0])
        if new_length < 0:
            raise OSError("newlength must be >= 0")
        ok = self.fs.truncate(path, new_length)
        h._json(200, {"boolean": bool(ok)})

    # ----------------------------------------------------------------- DELETE
    def _op_delete_delete(self, h, path: str, q) -> None:
        if q.get("skiptrash", ["true"])[0] == "false":
            # fs -rm semantics without -skipTrash: move into the bucket
            # trash (TrashPolicyOzone); the emptier purges checkpoints
            dst = self.fs.trash_delete(
                path, user=q.get("user.name", ["anonymous"])[0],
                recursive=q.get("recursive", ["false"])[0] == "true")
            h._json(200, {"boolean": True, "trashPath": dst})
            return
        recursive = q.get("recursive", ["false"])[0] == "true"
        ok = self.fs.delete(path, recursive=recursive)
        h._json(200, {"boolean": bool(ok)})
