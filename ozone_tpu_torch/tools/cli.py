"""The port's CLI: daemons, shell, admin and freon.

Port of the part of `ozone_tpu/tools/cli.py` that runs and drives a
cluster of processes (the reference's `ozone sh` volume/bucket/key verbs,
`ozone admin` verbs, `ozone freon` generators and
the service starters). It talks to the metadata daemon over the port's
RPC (`net/`).

    python -m ozone_tpu_torch.tools scm-om --db /data/om.db --port 9860
    python -m ozone_tpu_torch.tools datanode --root /data/dn0 --scm 127.0.0.1:9860
    python -m ozone_tpu_torch.tools cluster --datanodes 10 --device cuda
    python -m ozone_tpu_torch.tools sh volume create /v --om 127.0.0.1:9860
    python -m ozone_tpu_torch.tools sh key put /v/b/k ./file --om 127.0.0.1:9860
    python -m ozone_tpu_torch.tools admin status --om 127.0.0.1:9860
    python -m ozone_tpu_torch.tools freon ockg -n 16 -s 16777216 --om 127.0.0.1:9860
    python -m ozone_tpu_torch.tools s3 getsecret alice --om 127.0.0.1:9860
    python -m ozone_tpu_torch.tools s3g --om 127.0.0.1:9860 --port 9878 --require-auth
    python -m ozone_tpu_torch.tools sh bucket set-smallobj /v/b --om 127.0.0.1:9860
    python -m ozone_tpu_torch.tools lifecycle set /v/b --target rs-6-3-1024k --om 127.0.0.1:9860
    python -m ozone_tpu_torch.tools lifecycle run-now --om 127.0.0.1:9860
    python -m ozone_tpu_torch.tools replication set /v/b --dest 10.0.0.2:9860 \
        [--prefix logs/] [--dest-bucket dr] [--scheme rs-3-2-1024k] [--append]
    python -m ozone_tpu_torch.tools replication get|clear /v/b --om 127.0.0.1:9860
    python -m ozone_tpu_torch.tools replication run-now|status --om 127.0.0.1:9860
    python -m ozone_tpu_torch.tools freon geo -n 12 --dest 10.0.0.2:9860 --om ...
    python -m ozone_tpu_torch.tools scm-om --db /data/m0/om.db --port 9860 \
        --ha-id m0 --peer m0=127.0.0.1:9860 --peer m1=127.0.0.1:9861 \
        --peer m2=127.0.0.1:9862
    python -m ozone_tpu_torch.tools admin ring-status --om 127.0.0.1:9861
    python -m ozone_tpu_torch.tools admin ring-transfer m1 \
        --om 127.0.0.1:9860,127.0.0.1:9861,127.0.0.1:9862
    python -m ozone_tpu_torch.tools sh bucket create /v/fs --layout FILE_SYSTEM_OPTIMIZED
    python -m ozone_tpu_torch.tools fs mkdir /v/fs/a/b --om 127.0.0.1:9860
    python -m ozone_tpu_torch.tools fs ls /v/fs/a --om 127.0.0.1:9860
    python -m ozone_tpu_torch.tools sh key checksum /v/fs/a/b/f --om 127.0.0.1:9860
    python -m ozone_tpu_torch.tools admin om list-open-files /v/fs --om 127.0.0.1:9860
    python -m ozone_tpu_torch.tools httpfs --om 127.0.0.1:9860 --port 14000
    python -m ozone_tpu_torch.tools csi --om 127.0.0.1:9860 --port 9899
    python -m ozone_tpu_torch.tools scm-om --db /data/om.db --port 9860 \
        --block-tokens --insecure-secrets --acl-enabled
    python -m ozone_tpu_torch.tools acl bucket add /v/b -a user:alice:rwl
    python -m ozone_tpu_torch.tools tenant create acme --om 127.0.0.1:9860
    python -m ozone_tpu_torch.tools tenant assign acme --user alice
    python -m ozone_tpu_torch.tools sh token get --renewer yarn --token t.json
    python -m ozone_tpu_torch.tools scm-om --db /data/om.db --port 9860 \
        --secure --enroll-port 9861 --enrollment-secret S --block-tokens
    python -m ozone_tpu_torch.tools datanode --root /data/dn0 \
        --scm 127.0.0.1:9860 --ca 127.0.0.1:9861 --enrollment-secret S
    OZONE_TPU_CERT_DIR=~/.ozone-certs OZONE_TPU_ENROLL=127.0.0.1:9861 \
        OZONE_TPU_ENROLL_SECRET=S python -m ozone_tpu_torch.tools \
        admin kms create-key mk1 --om 127.0.0.1:9860
    python -m ozone_tpu_torch.tools sh bucket create /v/enc \
        --encryption-key mk1 --om 127.0.0.1:9860   # or --gdpr
    python -m ozone_tpu_torch.tools admin cert list --om 127.0.0.1:9860
    python -m ozone_tpu_torch.tools admin cert revoke <serial> --om ...
    python -m ozone_tpu_torch.tools cluster --datanodes 9 --secure
    python -m ozone_tpu_torch.tools datanode --root /data/dn0 --volumes 2 \
        --volume-policy capacity --rack /rack1 --scm 127.0.0.1:9860
    python -m ozone_tpu_torch.tools admin datanode decommission dn3 --om ...
    python -m ozone_tpu_torch.tools admin datanode maintenance|recommission dn3
    python -m ozone_tpu_torch.tools admin pipeline list|close <id> --om ...
    python -m ozone_tpu_torch.tools admin balancer start --threshold 0.1 \
        --max-moves 5 --max-size 10737418240 --om 127.0.0.1:9860
    python -m ozone_tpu_torch.tools admin balancer status|stop --om ...
    python -m ozone_tpu_torch.tools admin replicationmanager --om ...
    python -m ozone_tpu_torch.tools admin safemode enter|exit|status --om ...
    python -m ozone_tpu_torch.tools sh snapshot create /v/b --name s1 --om ...
    python -m ozone_tpu_torch.tools sh key get /v/b/.snapshot/s1/k out --om ...
    python -m ozone_tpu_torch.tools sh snapshot diff /v/b --name s1 --to s2 \
        [--page-size 100] --om ...
    python -m ozone_tpu_torch.tools sh snapshot list|info|rename|delete /v/b ...
    python -m ozone_tpu_torch.tools sh bucket setquota /v/b --quota 10MB \
        [--namespace-quota 1000] --om ...
    python -m ozone_tpu_torch.tools sh volume update /v --user alice --om ...
    python -m ozone_tpu_torch.tools admin om prepare|cancelprepare|status --om ...

Every command whose process runs the codec takes `--device` ("cuda" by
default; "cpu" runs the plain PyTorch versions): `datanode`, `sh key
put/get/cat/cp/rewrite`, `freon`, `s3g`, `httpfs`, `scm-om` (its
lifecycle sweep, slab compaction and geo ship cycles code there) and
`cluster`, which passes it to its children. Without CUDA, "cuda" is an
error that names CUDA (for `scm-om`, at its first sweep or ship cycle
with work). The namespace, `fs`, admin, lifecycle, replication and
`csi` verbs, and `sh key checksum` (it reads chunk metadata, no data),
import no torch, so they start in about a second.
Against a metadata ring, `--om` takes the replicas as a comma-separated
list; the clients follow the leader. On a token-enforcing cluster
(`scm-om --block-tokens --insecure-secrets`) the clients read the
posture from the SCM's status and fetch operator tokens for their
dn-direct verbs (`AdminTokenFetcher`); the `acl`, `tenant` and
`sh token` verbs act as the login user. On a mutual-TLS cluster
(`scm-om --secure`; `cluster --secure` runs one with block tokens) every
client command presents the certificate under OZONE_TPU_CERT_DIR, which
it enrolls at OZONE_TPU_ENROLL (with OZONE_TPU_ENROLL_SECRET) on first
use; without it the mutual-TLS plane refuses the command's connections.
Clients read replicas nearest-first from OZONE_TPU_CLIENT_LOCATION (a
topology path such as /dc1/rack2) when it is set.
Errors print as `error CODE: message` and exit 1.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import secrets
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

from ozone_tpu_torch.storage.ids import StorageError

#: the repository root, put on the children's PYTHONPATH by `cluster`
REPO = Path(__file__).resolve().parents[2]


def _device(args) -> str:
    """The codec device the command asked for; CUDA must be present unless
    it asked for the CPU."""
    from ozone_tpu_torch.codec.fused import resolve_device

    try:
        resolve_device(args.device)
    except RuntimeError:
        raise StorageError("CUDA_UNAVAILABLE",
                           "CUDA is not available; pass --device cpu to run "
                           "the plain PyTorch path") from None
    return args.device


_TLS: list = []


def _client_tls():
    """This process's client identity on a mutual-TLS cluster (the
    reference's environment): the certificate under OZONE_TPU_CERT_DIR,
    enrolled on first use at OZONE_TPU_ENROLL with OZONE_TPU_ENROLL_SECRET;
    None without OZONE_TPU_CERT_DIR (plaintext)."""
    if _TLS:
        return _TLS[0]
    cert_dir = os.environ.get("OZONE_TPU_CERT_DIR")
    if not cert_dir:
        return None
    from ozone_tpu_torch.utils.ca import CertificateClient

    cc = CertificateClient(Path(cert_dir).expanduser(), "client-cli")
    if not cc.enrolled:
        enroll = os.environ.get("OZONE_TPU_ENROLL")
        if not enroll:
            raise StorageError(
                "NOT_ENROLLED", "OZONE_TPU_CERT_DIR is set but holds no "
                "certificate; set OZONE_TPU_ENROLL to the enrollment "
                "address")
        cc.enroll_remote(enroll,
                         secret=os.environ.get("OZONE_TPU_ENROLL_SECRET"))
    _TLS.append(cc.tls())
    return _TLS[0]


class _Session:
    """A remote OM client and the datanode factory it feeds, closed on
    exit; `client(device)` is an OzoneClient over them."""

    def __init__(self, om_address: str):
        from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
        from ozone_tpu_torch.net.om_service import RemoteOmClient
        from ozone_tpu_torch.net.scm_service import RemoteScmClient

        tls = _client_tls()
        self.clients = DatanodeClientFactory()
        self.clients.tls = tls
        # this client's place in the topology: reads go nearest-first
        self.clients.location = os.environ.get("OZONE_TPU_CLIENT_LOCATION")
        self.om = RemoteOmClient(om_address, clients=self.clients, tls=tls)
        self.scm = RemoteScmClient(om_address, tls=tls)

    def learn_cluster(self) -> None:
        """Learn the datanodes up front (ecrd and repairs dial nodes no
        allocation named) and the token posture: on a token-enforcing
        cluster the dn-direct verbs take operator tokens from the SCM."""
        from ozone_tpu_torch.net.scm_service import AdminTokenFetcher

        addresses, locations = self.scm.node_topology()
        for dn_id, addr in addresses.items():
            self.clients.register_remote(dn_id, addr)
        self.clients.learn_locations(locations)
        if self.scm.status().get("block_tokens"):
            self.clients.tokens.issuer = AdminTokenFetcher(self.scm)

    def client(self, device: str):
        from ozone_tpu_torch.client.ozone_client import OzoneClient

        self.learn_cluster()
        return OzoneClient(self.om, self.clients, device=device)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.om.close()
        self.scm.close()
        self.clients.close()


def _serve(stop_fn) -> int:
    """Run a daemon until SIGTERM or SIGINT, then stop it cleanly."""
    done = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: done.set())
    try:
        while not done.wait(3600):
            pass
    finally:
        stop_fn()
    return 0


def _parse_path(path: str) -> list[str]:
    return [p for p in path.strip("/").split("/") if p]


def _emit(obj) -> None:
    print(json.dumps(obj, indent=2, default=str))


def _usage(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return 2


# ---------------------------------------------------------------------- sh
_SH_VERBS = {
    "volume": {"create", "delete", "info", "list", "setquota", "update"},
    "bucket": {"create", "delete", "info", "list", "setquota", "link",
               "set-replication", "set-smallobj"},
    "key": {"put", "get", "info", "list", "delete", "rename", "checksum",
            "cat", "cp", "rewrite"},
    "snapshot": {"create", "list", "info", "delete", "diff", "rename"},
    "token": {"get", "renew", "cancel", "print"},
}


def _quota_arg(v: str):
    """'10MB' or '1073741824' -> bytes; '' -> None (unchanged);
    'clear' -> -1 (unlimited)."""
    from ozone_tpu_torch.utils.config import parse_size

    if not v:
        return None
    if v == "clear":
        return -1
    return int(parse_size(v))


def _sh_snapshot(om, args, verb: str, vol: str, bucket: str) -> int:
    """`ozone sh snapshot create|list|info|delete|diff|rename`; a diff
    with --page-size runs as a paged job and streams its entries as JSON
    lines."""
    if verb == "list":
        _emit(om.list_snapshots(vol, bucket))
        return 0
    if not args.name:
        return _usage(f"snapshot {verb} requires --name")
    if verb == "diff" and args.page_size:
        job = om.snapshot_diff_submit(vol, bucket, args.name,
                                      args.to or None)
        deadline = time.time() + 300
        while job["status"] == "IN_PROGRESS" and time.time() < deadline:
            time.sleep(0.1)
            job = om.snapshot_diff_submit(vol, bucket, args.name,
                                          args.to or None)
        if job["status"] != "DONE":
            _emit(job)
            return 1
        token = ""
        while True:
            page = om.snapshot_diff_page(job["job_id"], token,
                                         args.page_size)
            for e in page["entries"]:
                print(json.dumps(e))
            token = page["next_token"]
            if not token:
                break
        print(json.dumps({"job_id": job["job_id"], "total": page["total"],
                          "mode": page["mode"]}), file=sys.stderr)
    elif verb == "diff":
        _emit(om.snapshot_diff(vol, bucket, args.name, args.to or None))
    elif verb == "create":
        _emit(om.create_snapshot(vol, bucket, args.name))
    elif verb == "rename":
        if not args.to:
            return _usage("snapshot rename requires --to")
        _emit(om.rename_snapshot(vol, bucket, args.name, args.to))
    elif verb == "info":
        _emit(om.snapshot_info(vol, bucket, args.name))
    else:
        om.delete_snapshot(vol, bucket, args.name)
        print(f"deleted snapshot {args.name}")
    return 0


def _sh_token(args, verb: str) -> int:
    """`ozone sh token get|renew|cancel|print`: delegation tokens as
    portable JSON files (--token FILE; --renewer on get). The caller is
    the login user, as the reference binds its principal; the OM refuses
    an anonymous remote renew or cancel."""
    import getpass

    from ozone_tpu_torch.net.om_service import RemoteOmClient

    def read_token():
        if not args.token:
            print("error: --token FILE required", file=sys.stderr)
            return None
        try:
            return json.loads(Path(args.token).read_text())
        except (OSError, ValueError) as e:
            print(f"error: cannot read token file {args.token}: {e}",
                  file=sys.stderr)
            return None

    if verb == "print":
        tok = read_token()
        if tok is None:
            return 2
        _emit(tok)
        return 0
    om = RemoteOmClient(args.om, tls=_client_tls())
    try:
        if verb == "get":
            if not args.renewer:
                return _usage("--renewer required")
            with om.user_context(getpass.getuser()):
                tok = om.get_delegation_token(args.renewer)
            if args.token:
                Path(args.token).write_text(json.dumps(tok))
                print(f"token written to {args.token}")
            else:
                _emit(tok)
            return 0
        tok = read_token()
        if tok is None:
            return 2
        with om.user_context(getpass.getuser()):
            if verb == "renew":
                _emit({"expiry": om.renew_delegation_token(tok)})
            else:
                om.cancel_delegation_token(tok)
                print("token cancelled")
    finally:
        om.close()
    return 0


def cmd_sh(args) -> int:
    kind, verb = args.object, args.verb
    if verb not in _SH_VERBS[kind]:
        return _usage(f"'{verb}' is not a {kind} verb (expected one of "
                      f"{sorted(_SH_VERBS[kind])})")
    if kind == "token":
        return _sh_token(args, verb)
    parts = _parse_path(args.path)
    with _Session(args.om) as s:
        om = s.om
        if kind == "volume":
            if verb == "list":
                _emit(om.list_volumes())
                return 0
            (vol,) = parts
            if verb == "create":
                om.create_volume(vol)
            elif verb == "delete":
                om.delete_volume(vol)
            elif verb == "setquota":
                _emit(om.set_quota(vol, quota_bytes=_quota_arg(args.quota),
                                   quota_namespace=args.namespace_quota))
            elif verb == "update":
                if not args.user:
                    return _usage("volume update requires --user NEWOWNER")
                _emit(om.set_volume_owner(vol, args.user))
            else:
                _emit(om.volume_info(vol))
        elif kind == "bucket":
            if verb == "list":
                (vol,) = parts
                _emit(om.list_buckets(vol))
                return 0
            vol, bucket = parts
            if verb == "create":
                om.create_bucket(vol, bucket,
                                 args.replication or "rs-6-3-1024k",
                                 args.layout,
                                 encryption_key=args.encryption_key,
                                 gdpr=args.gdpr)
            elif verb == "link":
                if not args.to:
                    return _usage("bucket link requires --to /volume/bucket")
                dvol, dbkt = _parse_path(args.to)
                om.create_bucket_link(vol, bucket, dvol, dbkt)
                print(f"linked /{dvol}/{dbkt} -> /{vol}/{bucket}")
            elif verb == "delete":
                om.delete_bucket(vol, bucket)
            elif verb == "set-smallobj":
                _emit(om.set_bucket_smallobj(vol, bucket))
            elif verb == "setquota":
                _emit(om.set_quota(vol, bucket,
                                   quota_bytes=_quota_arg(args.quota),
                                   quota_namespace=args.namespace_quota))
            elif verb == "set-replication":
                if not args.replication:
                    return _usage("set-replication requires --replication")
                b = om.set_bucket_replication(vol, bucket, args.replication)
                _emit({"bucket": f"/{vol}/{bucket}",
                       "replication": b["replication"]})
            else:
                _emit(om.bucket_info(vol, bucket))
        elif kind == "snapshot":
            vol, bucket = parts
            return _sh_snapshot(om, args, verb, vol, bucket)
        else:
            if verb == "list":
                vol, bucket = parts
                _emit(om.list_keys(vol, bucket, args.prefix))
                return 0
            vol, bucket, *rest = parts
            key = "/".join(rest)
            if verb == "info":
                _emit(om.lookup_key(vol, bucket, key))
            elif verb == "delete":
                om.delete_key(vol, bucket, key)
            elif verb == "rename":
                if not args.to:
                    return _usage("key rename requires --to <new key name>")
                om.rename_key(vol, bucket, key, args.to)
            elif verb == "checksum":
                # chunk metadata only: no codec, no torch
                from ozone_tpu_torch.client.file_checksum import file_checksum

                _emit(file_checksum(s, vol, bucket, key))
            else:
                if verb == "cp" and len(_parse_path(args.to)) < 3:
                    return _usage("cp needs --to /volume/bucket/key, got "
                                  f"{args.to!r}")
                if verb == "rewrite" and not args.replication:
                    return _usage("rewrite requires --replication")
                oz = s.client(_device(args))
                b = oz.get_volume(vol).get_bucket(bucket)
                if verb == "cat":
                    sys.stdout.buffer.write(b.read_key(key).tobytes())
                elif verb == "cp":
                    dv, db_, *drest = _parse_path(args.to)
                    b.copy_key(key, oz.get_volume(dv).get_bucket(db_),
                               "/".join(drest),
                               replication=args.replication or None)
                    print(f"copied {args.path} to {args.to}")
                elif verb == "rewrite":
                    b.rewrite_key(key, args.replication)
                    print(f"rewrote {args.path} as {args.replication}")
                elif verb == "put":
                    data = Path(args.file).read_bytes()
                    b.write_key(key, np.frombuffer(data, np.uint8),
                                args.replication or None)
                    print(f"wrote {len(data)} bytes to {args.path}")
                else:
                    data = b.read_key(key)
                    if args.file:
                        Path(args.file).write_bytes(data.tobytes())
                        print(f"read {data.size} bytes to {args.file}")
                    else:
                        sys.stdout.buffer.write(data.tobytes())
    return 0


# ---------------------------------------------------------------- acl/tenant
def cmd_acl(args) -> int:
    """Native ACL verbs (`ozone sh volume|bucket|key|prefix
    addacl|removeacl|setacl|getacl`), as the login user."""
    import getpass

    from ozone_tpu_torch.net.om_service import RemoteOmClient

    parts = _parse_path(args.path)
    vol = parts[0]
    bucket = parts[1] if len(parts) > 1 else ""
    path = "/".join(parts[2:]) if len(parts) > 2 else ""
    om = RemoteOmClient(args.om, tls=_client_tls())
    try:
        with om.user_context(getpass.getuser()):
            if args.verb == "get":
                _emit(om.get_acls(args.object, vol, bucket, path))
            else:
                changed = om.modify_acl(args.object, vol, bucket, path,
                                        args.verb, args.acl)
                print("changed" if changed else "unchanged")
    finally:
        om.close()
    return 0


def cmd_tenant(args) -> int:
    """Tenant admin verbs (`ozone tenant create|delete|list` and `ozone
    tenant user assign|revoke|list`), as the login user."""
    import getpass

    from ozone_tpu_torch.net.om_service import RemoteOmClient

    om = RemoteOmClient(args.om, tls=_client_tls())
    try:
        with om.user_context(getpass.getuser()):
            if args.verb == "create":
                om.create_tenant(args.tenant)
                print(f"tenant {args.tenant} created")
            elif args.verb == "delete":
                om.delete_tenant(args.tenant)
                print(f"tenant {args.tenant} deleted")
            elif args.verb == "list":
                _emit(om.list_tenants())
            elif args.verb == "assign":
                _emit(om.tenant_assign_user(args.tenant, args.user,
                                            args.access_id))
            elif args.verb == "revoke":
                om.tenant_revoke_access(args.access_id)
                print(f"revoked {args.access_id}")
            else:
                _emit(om.list_tenant_users(args.tenant))
    finally:
        om.close()
    return 0


# ---------------------------------------------------------------------- fs
def cmd_fs(args) -> int:
    """Filesystem verbs against FSO buckets (`ozone fs`: mkdir, ls, stat,
    rm, recover-lease)."""
    from ozone_tpu_torch.net.om_service import RemoteOmClient

    om = RemoteOmClient(args.om, tls=_client_tls())
    try:
        vol, bucket, *rest = _parse_path(args.path)
        path = "/".join(rest)
        if args.verb == "mkdir":
            om.create_directory(vol, bucket, path)
            print(f"created directory /{vol}/{bucket}/{path}")
        elif args.verb == "ls":
            _emit(om.list_status(vol, bucket, path))
        elif args.verb == "stat":
            _emit(om.get_file_status(vol, bucket, path))
        elif args.verb == "rm":
            st = om.get_file_status(vol, bucket, path)
            if st["type"] == "DIRECTORY":
                om.delete_directory(vol, bucket, path,
                                    recursive=args.recursive)
            else:
                om.delete_key(vol, bucket, path)
            print(f"deleted /{vol}/{bucket}/{path}")
        else:  # recover-lease
            _emit(om.recover_lease(vol, bucket, path))
    finally:
        om.close()
    return 0


# -------------------------------------------------------------------- admin
def cmd_admin(args) -> int:
    from ozone_tpu_torch.net.scm_service import RemoteScmClient

    scm = RemoteScmClient(args.om, tls=_client_tls())
    try:
        subject, verb, target = args.subject, args.verb, args.target
        if subject == "status":
            _emit(scm.status())
        elif subject == "om":
            if verb not in (None, "status", "prepare", "cancelprepare",
                            "list-open-files"):
                return _usage(f"unknown om verb {verb!r} (expected "
                              "prepare|cancelprepare|status|"
                              "list-open-files)")
            from ozone_tpu_torch.net.om_service import RemoteOmClient

            om = RemoteOmClient(args.om, tls=_client_tls())
            try:
                if verb == "prepare":
                    _emit(om.prepare())
                elif verb == "cancelprepare":
                    om.cancel_prepare()
                    _emit({"prepared": False})
                elif verb == "list-open-files":
                    parts = _parse_path(target or "")
                    _emit(om.list_open_files(
                        parts[0] if parts else "",
                        parts[1] if len(parts) > 1 else "",
                        prefix=args.prefix, start_after=args.start_after,
                        limit=args.limit if args.limit is not None
                        else 100))
                else:
                    _emit(om.prepare_status())
            finally:
                om.close()
        elif subject == "cert":
            # the CA's lifecycle, answered by the replica that hosts it
            if verb in (None, "list"):
                _emit(scm.admin("cert-list", None))
            elif verb == "revoke":
                if not target:
                    return _usage("cert revoke needs the certificate serial")
                _emit(scm.admin("cert-revoke", target))
            else:
                return _usage(f"unknown cert verb {verb!r} "
                              "(expected list|revoke <serial>)")
        elif subject == "kms":
            # the TDE master keys (ozone admin + the KMS's keyadmin)
            from ozone_tpu_torch.net.om_service import RemoteOmClient

            om = RemoteOmClient(args.om, tls=_client_tls())
            try:
                if verb in ("create-key", "rotate-key", "info") \
                        and not target:
                    return _usage(f"kms {verb} needs a key name")
                if verb == "create-key":
                    _emit(om.kms_create_key(target))
                elif verb == "rotate-key":
                    _emit(om.kms_create_key(target, rotate=True))
                elif verb in (None, "list"):
                    _emit(om.kms_list_keys())
                elif verb == "info":
                    _emit(om.kms_key_info(target))
                else:
                    return _usage(f"unknown kms verb {verb!r} (expected "
                                  "create-key|rotate-key|list|info)")
            finally:
                om.close()
        elif subject == "safemode":
            if verb in ("enter", "exit"):
                _emit(scm.admin(f"safemode-{verb}"))
            elif verb in (None, "status"):
                _emit(scm.admin("safemode-status"))
            else:
                return _usage(f"unknown safemode verb {verb!r} "
                              "(expected enter|exit|status)")
        elif subject == "datanode":
            if verb in ("decommission", "recommission", "maintenance"):
                if not target:
                    return _usage(f"datanode {verb} needs a datanode id")
                _emit(scm.admin(verb, target))
            elif verb in (None, "list"):
                _emit(scm.status()["nodes"])
            else:
                return _usage(f"unknown datanode verb {verb!r} (expected "
                              "list|decommission|recommission|maintenance)")
        elif subject == "pipeline":
            if verb == "close":
                if not target:
                    return _usage("pipeline close requires a pipeline id")
                _emit(scm.admin("close-pipeline", target))
            elif verb in (None, "list"):
                _emit(scm.admin("pipelines"))
            else:
                return _usage(f"unknown pipeline verb {verb!r} "
                              "(expected list|close)")
        elif subject == "balancer":
            if verb not in (None, "status", "start", "stop"):
                return _usage(f"unknown balancer verb {verb!r} "
                              "(expected start|stop|status)")
            cfg = {}
            if args.threshold is not None:
                cfg["threshold"] = args.threshold
            if args.max_moves is not None:
                cfg["max_moves_per_iteration"] = args.max_moves
            if args.max_size is not None:
                cfg["max_size_per_iteration"] = args.max_size
            if cfg and verb != "start":
                # the config applies at start only: dropping it silently
                # would leave the operator believing it took
                return _usage("balancer config flags require the 'start' "
                              "verb")
            _emit(scm.admin(f"balancer-{verb or 'status'}", cfg or None))
        elif subject == "replicationmanager":
            _emit(scm.admin("replication-status"))
        elif subject.startswith("ring-"):
            # the metadata ring; status is answered by any replica
            target = verb  # ring-<op> <target>
            if subject == "ring-add" and (not target or "=" not in target):
                return _usage("ring-add needs <id>=<host:port>")
            if subject in ("ring-remove", "ring-transfer") and not target:
                return _usage(f"{subject} needs the replica id")
            _emit(scm.admin(subject, target))
        else:  # container
            if verb in (None, "list"):
                _emit(scm.list_containers())
            elif verb in ("info", "close"):
                if not target:
                    return _usage(f"container {verb} requires a container id")
                _emit(scm.admin(f"container-{verb}" if verb == "info"
                                else "close-container", target))
            else:
                return _usage(f"unknown container verb {verb!r} "
                              "(expected list|info <id>|close <id>)")
    finally:
        scm.close()
    return 0


# -------------------------------------------------------------------- freon
def cmd_freon(args) -> int:
    from ozone_tpu_torch.tools import freon

    if args.generator == "s3kg":
        # an HTTP client of the gateway: no codec in this process
        secret = None
        if args.access_id:
            with _Session(args.om) as s:
                secret = s.om.get_s3_secret(args.access_id)
        _emit(freon.s3kg(args.endpoint, n_keys=args.num, size=args.size,
                         threads=args.threads, validate=args.validate,
                         access_id=args.access_id or None,
                         secret=secret).summary())
        return 0
    if args.generator == "swarm":
        # closed-loop multi-tenant swarm against the S3 gateway, with
        # anonymous tenants (signed tenants need OM-provisioned secrets)
        tenants = [{"name": f"tenant-{i}", "rate": 0.0}
                   for i in range(max(1, args.threads))]
        _emit(freon.swarm(args.endpoint, tenants, duration_s=args.duration,
                          n_keys=args.num, tiny=args.tiny).summary())
        return 0
    device = _device(args)
    with _Session(args.om) as s:
        oz = s.client(device)
        repl = args.replication or None
        if args.generator == "ockg":
            _emit(freon.ockg(oz, n_keys=args.num, size=args.size,
                             threads=args.threads,
                             replication=repl).summary())
        elif args.generator == "ockr":
            _emit(freon.ockr(oz, args.num, threads=args.threads).summary())
        elif args.generator == "ockv":
            _emit(freon.ockv(oz, n_keys=args.num, size=args.size,
                             threads=args.threads).summary())
        elif args.generator == "mpug":
            _emit(freon.mpug(oz, n_uploads=args.num, part_size=args.size,
                             threads=args.threads,
                             replication=repl).summary())
        elif args.generator == "lcg":
            _emit(freon.lcg(oz, n_keys=args.num, size=args.size,
                            threads=args.threads,
                            replication=repl or "RATIS/THREE",
                            target=args.target).summary())
        elif args.generator == "tinyg":
            _emit(freon.tinyg(oz, n_keys=args.num, size=args.size,
                              threads=args.threads,
                              replication=repl or "rs-3-2-4096",
                              packer=not args.no_packer, mix=args.tiny,
                              validate=args.validate).summary())
        elif args.generator == "fskg":
            _emit(freon.fskg(oz, n_files=args.num, size=args.size,
                             depth=args.depth, threads=args.threads,
                             replication=repl).summary())
        elif args.generator == "fsg":
            _emit(freon.fsg(oz, n_files=args.num, size=args.size,
                            threads=args.threads,
                            replication=repl).summary())
        elif args.generator == "geo":
            if not args.dest:
                return _usage("freon geo needs --dest HOST:PORT (the "
                              "destination cluster's endpoint)")
            _emit(freon.geo(oz, args.dest, n_keys=args.num, size=args.size,
                            threads=args.threads,
                            replication=repl or "RATIS/THREE",
                            scheme=args.scheme).summary())
        else:  # ecrd
            _emit(freon.ecrd(oz, s.scm, size=args.size, rounds=args.num,
                             replication=repl or "rs-6-3-1048576"))
    return 0


# ---------------------------------------------------------------- lifecycle
def cmd_lifecycle(args) -> int:
    """Bucket lifecycle admin (`lifecycle set|get|clear|run-now|status|
    compact-slabs`): age-based replicated->EC tiering and TTL expiry
    rules, enforced by the metadata daemon's sweeper."""
    from ozone_tpu_torch.net.om_service import RemoteOmClient

    om = RemoteOmClient(args.om, tls=_client_tls())
    try:
        verb = args.verb
        if verb == "run-now":
            _emit(om.run_lifecycle_once(args.max_keys))
            return 0
        if verb == "compact-slabs":
            _emit(om.run_slab_compaction_once())
            return 0
        if verb == "status":
            _emit(om.lifecycle_status())
            return 0
        if not args.path:
            return _usage(f"lifecycle {verb} needs a /volume/bucket path")
        parts = _parse_path(args.path)
        if len(parts) != 2:
            return _usage(f"expected /volume/bucket, got {args.path!r}")
        vol, bucket = parts
        if verb == "get":
            _emit(om.get_bucket_lifecycle(vol, bucket))
        elif verb == "clear":
            om.delete_bucket_lifecycle(vol, bucket)
            print(f"lifecycle cleared on /{vol}/{bucket}")
        else:  # set
            action = {"transition": "TRANSITION_TO_EC",
                      "expire": "EXPIRE"}.get(args.action)
            if action is None:
                return _usage(f"unknown action {args.action!r} "
                              "(expected transition|expire)")
            rules = (om.get_bucket_lifecycle(vol, bucket)
                     if args.append else [])
            rule = {"id": args.id or f"rule-{len(rules)}",
                    "prefix": args.prefix, "age_days": args.age_days,
                    "action": action, "enabled": True}
            if action == "TRANSITION_TO_EC":
                rule["target"] = args.target
            _emit(om.set_bucket_lifecycle(
                vol, bucket, [*rules, rule]).get("lifecycle", []))
    finally:
        om.close()
    return 0


# ------------------------------------------------------------- replication
def cmd_replication(args) -> int:
    """Geo replication admin (`replication set|get|clear|run-now|status`):
    a bucket's cross-cluster rules, enforced by the metadata daemon's
    shipper."""
    from ozone_tpu_torch.net.om_service import RemoteOmClient

    om = RemoteOmClient(args.om, tls=_client_tls())
    try:
        verb = args.verb
        if verb == "run-now":
            _emit(om.run_geo_once(args.max_entries))
            return 0
        if verb == "status":
            _emit(om.geo_status())
            return 0
        if not args.path:
            return _usage(f"replication {verb} needs a /volume/bucket path")
        parts = _parse_path(args.path)
        if len(parts) != 2:
            return _usage(f"expected /volume/bucket, got {args.path!r}")
        vol, bucket = parts
        if verb == "get":
            _emit(om.get_bucket_geo_replication(vol, bucket))
        elif verb == "clear":
            om.delete_bucket_geo_replication(vol, bucket)
            print(f"replication cleared on /{vol}/{bucket}")
        else:  # set
            if not args.dest:
                return _usage("replication set needs --dest HOST:PORT (the "
                              "destination cluster's endpoint)")
            rules = (om.get_bucket_geo_replication(vol, bucket)
                     if args.append else [])
            rule = {"id": args.id or f"rule-{len(rules)}",
                    "endpoint": args.dest, "prefix": args.prefix,
                    "bucket": args.dest_bucket, "volume": args.dest_volume,
                    "scheme": args.scheme, "enabled": True}
            _emit(om.set_bucket_geo_replication(
                vol, bucket, [*rules, rule]).get("geo_replication", []))
    finally:
        om.close()
    return 0


# ---------------------------------------------------------------------- s3
def cmd_s3(args) -> int:
    """S3 secret management (`ozone s3 getsecret` / `revokesecret`)."""
    with _Session(args.om) as s:
        if args.verb == "getsecret":
            _emit({"access_id": args.access_id,
                   "secret": s.om.get_s3_secret(args.access_id)})
        else:
            s.om.revoke_s3_secret(args.access_id)
            _emit({"access_id": args.access_id, "revoked": True})
    return 0


def cmd_s3g(args) -> int:
    """The S3 gateway daemon in front of a remote OM (`ozone s3g`). On
    stop it prints the fused kernel's launches and the codec service's
    dispatches of its PUTs and GETs."""
    device = _device(args)
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.codec import service as codec_service
    from ozone_tpu_torch.gateway.s3 import S3Gateway

    logging.basicConfig(level=logging.INFO)
    with _Session(args.om) as s:
        oz = s.client(device)
        gw = S3Gateway(oz, port=args.port, replication=args.replication,
                       require_auth=args.require_auth,
                       domain=args.domain or None)
        gw.start()
        print(f"s3 gateway serving on {gw.address}, om={args.om}, "
              f"device={oz.device}", flush=True)
        rc = _serve(gw.stop)
    print(f"s3 gateway stopped; kernel launches {fused_kernel.launches.count}, "
          f"service dispatches "
          f"{codec_service.METRICS.counter('dispatches').value}", flush=True)
    return rc


def cmd_httpfs(args) -> int:
    """The WebHDFS-compatible HttpFS gateway daemon (`ozone httpfs`). On
    stop it prints the fused kernel's launches, as `s3g` does."""
    device = _device(args)
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.gateway.httpfs import HttpFSGateway

    logging.basicConfig(level=logging.INFO)
    with _Session(args.om) as s:
        oz = s.client(device)
        gw = HttpFSGateway(oz, port=args.port,
                           replication=args.replication or None,
                           trash_interval_s=args.trash_interval or None)
        gw.start()
        print(f"httpfs gateway serving on {gw.address}, om={args.om}, "
              f"device={oz.device}", flush=True)
        rc = _serve(gw.stop)
    print(f"httpfs gateway stopped; kernel launches "
          f"{fused_kernel.launches.count}", flush=True)
    return rc


def cmd_csi(args) -> int:
    """The CSI driver daemon (`ozone csi`): volumes are buckets of the S3
    volume; it runs no codec."""
    from ozone_tpu_torch.gateway.csi import CsiServer

    logging.basicConfig(level=logging.INFO)
    with _Session(args.om) as s:
        srv = CsiServer(s, s3_endpoint=args.s3_endpoint, port=args.port,
                        replication=args.replication or None)
        srv.start()
        print(f"csi driver serving on {srv.address}, om={args.om}",
              flush=True)
        return _serve(srv.stop)


# ------------------------------------------------------------------ daemons
def cmd_datanode(args) -> int:
    device = _device(args)  # before anything binds or registers
    from ozone_tpu_torch.net.daemons import DatanodeDaemon

    logging.basicConfig(level=logging.INFO)
    dn_id = args.id or Path(args.root).name
    d = DatanodeDaemon(Path(args.root), dn_id, args.scm, port=args.port,
                       rack=args.rack,
                       heartbeat_interval_s=args.heartbeat_interval,
                       scan_interval_s=args.scan_interval, device=device,
                       ca_address=args.ca or None,
                       enrollment_secret=args.enrollment_secret or None,
                       num_volumes=args.volumes,
                       volume_policy=args.volume_policy,
                       replication_bandwidth_mbps=(
                           args.replication_bandwidth_mbps))
    d.start()
    lane = d.advertise()
    native = f"{lane['port']} uds={lane['uds']}" if lane else "off"
    print(f"datanode {dn_id} serving on {d.address}, scm={args.scm}, "
          f"native datapath={native}, device={d.device}"
          + (", mutual TLS" if d.tls is not None else ""), flush=True)
    rc = _serve(d.stop)
    print(f"datanode {dn_id} stopped; chunk streams by lane: "
          f"{json.dumps(d.lane_counts())}", flush=True)
    return rc


def cmd_scm_om(args) -> int:
    from ozone_tpu_torch.net.daemons import ScmOmDaemon

    logging.basicConfig(level=logging.INFO)
    ha_peers = None
    if args.peer:
        ha_peers = dict(p.split("=", 1) for p in args.peer)
        if not args.ha_id or args.ha_id not in ha_peers:
            print("--ha-id must name one of the --peer entries",
                  file=sys.stderr)
            return 1
    try:
        d = ScmOmDaemon(Path(args.db), port=args.port,
                        min_datanodes=args.min_datanodes, device=args.device,
                        ha_id=args.ha_id if ha_peers else None,
                        ha_peers=ha_peers, block_tokens=args.block_tokens,
                        insecure_secrets=args.insecure_secrets,
                        acl_enabled=args.acl_enabled, secure=args.secure,
                        enroll_port=args.enroll_port,
                        enrollment_secret=args.enrollment_secret or None,
                        ca_address=args.ca or None)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    d.start()
    print(f"scm+om serving on {d.address}"
          + (f" as HA node {args.ha_id}" if ha_peers else "")
          + (" [block tokens]" if args.block_tokens else "")
          + (" [acls]" if args.acl_enabled else "")
          + (f" [mutual TLS, enrollment on {d.enroll_address}]"
             if d.enroll_address else
             " [mutual TLS]" if args.secure else ""), flush=True)
    return _serve(d.stop)


def _wait(what: str, fn, timeout_s: float, check=None, poll_s: float = 0.25):
    """Poll fn() until it returns a true value; raise after timeout_s.
    check(), when given, runs first on every poll and may raise."""
    t_end = time.monotonic() + timeout_s
    while True:
        if check is not None:
            check()
        try:
            out = fn()
            if out:
                return out
        except StorageError:
            pass
        if time.monotonic() > t_end:
            raise StorageError("TIMEOUT", f"{what} after {timeout_s:.0f} s")
        time.sleep(poll_s)


def cmd_cluster(args) -> int:
    """One-command local cluster: an scm-om child and N datanode children
    under one supervisor (spawned together with fork and exec), up when
    every datanode registered; serves until SIGTERM or SIGINT, then stops every
    child. With --device cuda the supervisor builds every kernel and host
    library first (on the CPU, the native datapath's), so the datanodes
    load them instead of each compiling them at once."""
    from ozone_tpu_torch import cuda_build
    from ozone_tpu_torch.client import native_dn
    from ozone_tpu_torch.net.scm_service import RemoteScmClient

    device = _device(args)
    if device != "cpu":
        cuda_build.build_all()
    elif native_dn.enabled():
        cuda_build.load("datapath")
    root = Path(args.root or tempfile.mkdtemp(prefix="ozone-cluster-"))
    root.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs: list[subprocess.Popen] = []

    def spawn(argv, log_name):
        with open(root / log_name, "w") as log_file:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "ozone_tpu_torch.tools", *argv],
                stdout=log_file, stderr=subprocess.STDOUT, env=env,
                stdin=subprocess.DEVNULL))

    def teardown():
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    def children_alive():
        for p in procs:
            if p.poll() is not None:
                raise StorageError(
                    "CHILD_EXITED", f"{' '.join(p.args[3:5])} exited with "
                    f"{p.returncode} (see the logs in {root})")

    om = f"127.0.0.1:{args.port}"
    enroll = f"127.0.0.1:{args.port + 1}"
    secret = args.enrollment_secret or (
        secrets.token_hex(16) if args.secure else "")
    scm = None
    try:
        # all at once (a datanode that comes up before the metadata server
        # registers on a later heartbeat), but for the enrollment below
        if args.secure:
            # mutual TLS with block tokens: the keys ride only the mTLS
            # plane, and the datanodes enroll with the cluster's secret
            security = ["--block-tokens", "--secure", "--enroll-port",
                        str(args.port + 1), "--enrollment-secret", secret]
            dn_security = ["--ca", enroll, "--enrollment-secret", secret]
        else:
            security = (["--block-tokens", "--insecure-secrets"]
                        if args.block_tokens else [])
            dn_security = []
        if args.acl_enabled:
            security.append("--acl-enabled")
        spawn(["scm-om", "--db", str(root / "om.db"), "--port",
               str(args.port), "--device", device, *security], "scm-om.log")
        tls = None
        if args.secure:
            # the supervisor's own client certificate (the one the "cluster
            # up" line hands to the user's commands), enrolled before the
            # datanodes start: they enroll at construction
            from ozone_tpu_torch.utils.ca import CertificateClient

            cc = CertificateClient(root / "client-certs", "client-cli")
            _wait("the enrollment endpoint did not answer",
                  lambda: cc.enroll_remote(enroll, secret=secret) or True,
                  120, children_alive)
            tls = cc.tls()
        for i in range(args.datanodes):
            spawn(["datanode", "--root", str(root / f"dn{i}"), "--scm", om,
                   "--id", f"dn{i}", "--device", device, *dn_security],
                  f"dn{i}.log")
        scm = RemoteScmClient(om, tls=tls)
        _wait("the datanodes did not register",
              lambda: len(scm.status()["nodes"]) >= args.datanodes, 120,
              children_alive)
    except BaseException:
        teardown()
        raise
    finally:
        if scm is not None:
            scm.close()
    print(f"cluster up: om={om} datanodes={args.datanodes} device={device} "
          f"root={root} pids={[p.pid for p in procs]}"
          + (f" secure: enroll={enroll} secret={secret} "
             f"cert_dir={root / 'client-certs'}" if args.secure else ""),
          flush=True)
    return _serve(teardown)


# -------------------------------------------------------------------- main
def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="ozone_tpu_torch.tools")
    sub = ap.add_subparsers(dest="command", required=True)

    def device_flag(p):
        p.add_argument("--device", default="cuda",
                       help="where the codec runs: cuda (default) or cpu")

    sh = sub.add_parser("sh", help="object store shell (ozone sh)")
    sh.add_argument("object", choices=sorted(_SH_VERBS))
    sh.add_argument("verb", choices=sorted(set().union(*_SH_VERBS.values())))
    sh.add_argument("path", nargs="?", default="/",
                    help="/volume[/bucket[/key]]")
    sh.add_argument("file", nargs="?", help="local file of key put/get")
    sh.add_argument("--om", default="127.0.0.1:9860")
    sh.add_argument("--replication", default="")
    sh.add_argument("--prefix", default="", help="key list: name prefix")
    sh.add_argument("--to", default="",
                    help="key rename: new name; key cp: /volume/bucket/key; "
                         "bucket link: the link's /volume/bucket; snapshot "
                         "rename: new name; snapshot diff: the to-snapshot "
                         "(default: the live bucket)")
    sh.add_argument("--name", default="",
                    help="snapshot verbs: snapshot name (diff: the "
                         "from-snapshot)")
    sh.add_argument("--page-size", type=int, default=0,
                    help="snapshot diff: run as a paged job, streaming "
                         "entries as JSON lines (0 = one report)")
    sh.add_argument("--user", default="",
                    help="volume update: the new owner")
    sh.add_argument("--quota", default="",
                    help="setquota: space quota (e.g. 10MB; 'clear' for "
                         "unlimited)")
    sh.add_argument("--namespace-quota", type=int, default=None,
                    help="setquota: the most keys (-1 clears; omitted "
                         "leaves it as it is)")
    sh.add_argument("--layout", default="OBJECT_STORE",
                    choices=["OBJECT_STORE", "FILE_SYSTEM_OPTIMIZED",
                             "LEGACY"],
                    help="bucket create: the bucket layout")
    sh.add_argument("--encryption-key", default="",
                    help="bucket create: TDE under this KMS master key "
                         "(admin kms create-key first)")
    sh.add_argument("--gdpr", action="store_true",
                    help="bucket create: a GDPR bucket (each key's secret "
                         "is destroyed when the key is deleted)")
    sh.add_argument("--token", default="",
                    help="token get/renew/cancel/print: the token's file")
    sh.add_argument("--renewer", default="",
                    help="token get: the renewer principal")
    device_flag(sh)
    sh.set_defaults(fn=cmd_sh)

    ad = sub.add_parser("admin", help="cluster admin (ozone admin)")
    ad.add_argument("subject", choices=["status", "safemode", "container",
                                        "datanode", "pipeline", "balancer",
                                        "replicationmanager",
                                        "om", "ring-status", "ring-add",
                                        "ring-remove", "ring-transfer",
                                        "cert", "kms"])
    ad.add_argument("verb", nargs="?", default=None,
                    help="container: list|info <id>|close <id>; safemode: "
                         "enter|exit|status; datanode: list|decommission|"
                         "recommission|maintenance <id>; pipeline: list|"
                         "close <id>; balancer: start|stop|status; om: "
                         "prepare|cancelprepare|status|list-open-files "
                         "[/volume[/bucket]]; ring-add: "
                         "<id>=<host:port>; ring-remove, ring-transfer: <id>; "
                         "cert: list|revoke <serial>; kms: create-key|"
                         "rotate-key|info <name>, list")
    ad.add_argument("target", nargs="?", default=None)
    ad.add_argument("--om", default="127.0.0.1:9860")
    ad.add_argument("--prefix", default="",
                    help="om list-open-files: key-name prefix filter")
    ad.add_argument("--start-after", default="",
                    help="om list-open-files: resume after this row "
                         "(the previous page's continuation)")
    ad.add_argument("--limit", type=int, default=None,
                    help="om list-open-files: page size")
    ad.add_argument("--threshold", type=float, default=None,
                    help="balancer start: utilization band around the "
                         "cluster mean (e.g. 0.1)")
    ad.add_argument("--max-moves", type=int, default=None,
                    help="balancer start: moves per iteration")
    ad.add_argument("--max-size", type=int, default=None,
                    help="balancer start: bytes moved per iteration")
    ad.set_defaults(fn=cmd_admin)

    fs = sub.add_parser("fs", help="file-system verbs on FSO buckets "
                                   "(ozone fs)")
    fs.add_argument("verb", choices=["mkdir", "ls", "stat", "rm",
                                     "recover-lease"])
    fs.add_argument("path", help="/volume/bucket[/dir/path]")
    fs.add_argument("-r", "--recursive", action="store_true")
    fs.add_argument("--om", default="127.0.0.1:9860")
    fs.set_defaults(fn=cmd_fs)

    acl = sub.add_parser("acl", help="native ACL grants (ozone sh "
                                     "addacl/removeacl/setacl/getacl)")
    acl.add_argument("object", choices=["volume", "bucket", "key", "prefix"])
    acl.add_argument("verb", choices=["add", "remove", "set", "get"])
    acl.add_argument("path", help="/volume[/bucket[/key-or-prefix]]")
    acl.add_argument("-a", "--acl", action="append", default=[],
                     help="a grant like user:alice:rwl[DEFAULT] (repeat)")
    acl.add_argument("--om", default="127.0.0.1:9860")
    acl.set_defaults(fn=cmd_acl)

    tn = sub.add_parser("tenant", help="multi-tenant admin (ozone tenant)")
    tn.add_argument("verb", choices=["create", "delete", "list", "assign",
                                     "revoke", "users"])
    tn.add_argument("tenant", nargs="?", default="")
    tn.add_argument("--user", default="")
    tn.add_argument("--access-id", default="")
    tn.add_argument("--om", default="127.0.0.1:9860")
    tn.set_defaults(fn=cmd_tenant)

    fr = sub.add_parser("freon", help="load generators")
    fr.add_argument("generator",
                    choices=["ockg", "ockr", "ockv", "ecrd", "mpug", "s3kg",
                             "lcg", "tinyg", "fskg", "fsg", "swarm", "geo"])
    fr.add_argument("-n", "--num", type=int, default=100)
    fr.add_argument("-s", "--size", type=int, default=10240)
    fr.add_argument("-t", "--threads", type=int, default=4)
    fr.add_argument("--om", default="127.0.0.1:9860")
    fr.add_argument("--replication", default="")
    fr.add_argument("--validate", action="store_true",
                    help="s3kg, tinyg: GET each key back and compare")
    fr.add_argument("--target", default="rs-3-2-4096",
                    help="lcg: the EC scheme the lifecycle rule tiers to")
    fr.add_argument("--no-packer", action="store_true",
                    help="tinyg: every key down the per-key stripe path "
                         "(the small-object before/after baseline)")
    fr.add_argument("--tiny", action="store_true",
                    help="tinyg: sizes from the tiny-key mix instead of "
                         "--size")
    fr.add_argument("--depth", type=int, default=3,
                    help="fskg: directory depth of each file")
    fr.add_argument("--duration", type=float, default=4.0,
                    help="swarm: seconds to drive load")
    fr.add_argument("--endpoint", default="127.0.0.1:9878",
                    help="s3kg, swarm: S3 gateway host:port")
    fr.add_argument("--access-id", default="",
                    help="s3kg: sign every request with this access id's "
                         "secret, fetched from --om (default: unsigned)")
    fr.add_argument("--dest", default="",
                    help="geo: the destination cluster's OM endpoint")
    fr.add_argument("--scheme", default="",
                    help="geo: the destination's replication scheme "
                         "(default: keep the source key's)")
    device_flag(fr)
    fr.set_defaults(fn=cmd_freon)

    hf = sub.add_parser("httpfs", help="run the WebHDFS-compatible gateway")
    hf.add_argument("--om", default="127.0.0.1:9860")
    hf.add_argument("--port", type=int, default=14000)
    hf.add_argument("--replication", default="",
                    help="replication of buckets that mkdirs creates")
    hf.add_argument("--trash-interval", type=float, default=0.0,
                    help="fs.trash.interval seconds: rotate and purge trash "
                         "checkpoints on this cadence (0 = off)")
    device_flag(hf)
    hf.set_defaults(fn=cmd_httpfs)

    csi = sub.add_parser("csi", help="run the CSI driver daemon")
    csi.add_argument("--om", default="127.0.0.1:9860")
    csi.add_argument("--port", type=int, default=9899)
    csi.add_argument("--s3-endpoint", default="")
    csi.add_argument("--replication", default="")
    csi.set_defaults(fn=cmd_csi)

    s3g = sub.add_parser("s3g", help="run the S3 gateway daemon")
    s3g.add_argument("--om", default="127.0.0.1:9860")
    s3g.add_argument("--port", type=int, default=9878)
    s3g.add_argument("--replication", default="rs-6-3-1024k")
    s3g.add_argument("--domain", default="",
                     help="serve virtual-host-style addressing for "
                          "Host: <bucket>.<domain>")
    s3g.add_argument("--require-auth", action="store_true",
                     help="enforce SigV4 signatures")
    device_flag(s3g)
    s3g.set_defaults(fn=cmd_s3g)

    s3 = sub.add_parser("s3", help="s3 secret management")
    s3.add_argument("verb", choices=["getsecret", "revokesecret"])
    s3.add_argument("access_id")
    s3.add_argument("--om", default="127.0.0.1:9860")
    s3.set_defaults(fn=cmd_s3)

    dn = sub.add_parser("datanode", help="run a datanode daemon")
    dn.add_argument("--root", required=True)
    dn.add_argument("--scm", required=True)
    dn.add_argument("--id", default="")
    dn.add_argument("--port", type=int, default=0)
    dn.add_argument("--rack", default="/default-rack")
    dn.add_argument("--volumes", type=int, default=1,
                    help="storage volumes under --root (hdds.datanode.dir)")
    dn.add_argument("--volume-policy", default="round-robin",
                    choices=["round-robin", "capacity"],
                    help="volume chooser for new containers")
    dn.add_argument("--heartbeat-interval", type=float, default=1.0)
    dn.add_argument("--scan-interval", type=float, default=300.0,
                    help="seconds between background scrubs (0: none)")
    dn.add_argument("--ca", default="",
                    help="the CA's enrollment address (host:port): enroll, "
                         "then serve and dial everything over mutual TLS")
    dn.add_argument("--enrollment-secret", default="",
                    help="the shared bootstrap secret of CSR signing")
    dn.add_argument("--replication-bandwidth-mbps", type=float,
                    default=None,
                    help="cap on this datanode's replication traffic, "
                         "MiB/s (exports served and pulled; default "
                         "unlimited)")
    device_flag(dn)
    dn.set_defaults(fn=cmd_datanode)

    so = sub.add_parser("scm-om", help="run the SCM+OM metadata server")
    so.add_argument("--db", required=True)
    so.add_argument("--port", type=int, default=9860)
    so.add_argument("--min-datanodes", type=int, default=1)
    so.add_argument("--ha-id", default="",
                    help="this replica's id on the metadata ring")
    so.add_argument("--peer", action="append", default=[],
                    help="a ring member as ID=host:port (repeat for each, "
                         "this replica included)")

    def security_flags(p):
        p.add_argument("--block-tokens", action="store_true",
                       help="enforce HMAC block and container tokens on "
                            "every datanode lane (hdds.block.token.enabled)")
        p.add_argument("--acl-enabled", action="store_true",
                       help="check native ACLs on OM verbs "
                            "(ozone.acl.enabled)")

    security_flags(so)
    so.add_argument("--insecure-secrets", action="store_true",
                    help="hand the token keys out on Register and "
                         "Heartbeat in the clear (tests only; --secure "
                         "sends them over mutual TLS)")
    so.add_argument("--secure", action="store_true",
                    help="host the cluster CA and serve over mutual TLS "
                         "(hdds.grpc.tls.enabled)")
    so.add_argument("--enroll-port", type=int, default=0,
                    help="the plaintext certificate-enrollment port "
                         "(secure mode)")
    so.add_argument("--enrollment-secret", default="",
                    help="the shared bootstrap secret that gates CSR "
                         "signing (required with --secure --block-tokens)")
    so.add_argument("--ca", default="",
                    help="the primordial metadata server's enrollment "
                         "address (a secure HA replica enrolls there)")
    device_flag(so)
    so.set_defaults(fn=cmd_scm_om)

    lc = sub.add_parser("lifecycle",
                        help="bucket lifecycle: age-based tiering "
                             "(replicated->EC) and TTL expiry")
    lc.add_argument("verb", choices=["set", "get", "clear", "run-now",
                                     "status", "compact-slabs"])
    lc.add_argument("path", nargs="?", default="",
                    help="/volume/bucket (set, get, clear)")
    lc.add_argument("--om", default="127.0.0.1:9860")
    lc.add_argument("--prefix", default="",
                    help="set: key-name prefix filter")
    lc.add_argument("--age-days", type=float, default=0.0,
                    help="set: minimum age before the action applies")
    lc.add_argument("--action", default="transition",
                    help="set: transition (replicated->EC) or expire")
    lc.add_argument("--target", default="rs-6-3-1024k",
                    help="set: EC scheme of a transition rule")
    lc.add_argument("--id", default="", help="set: rule id (rule-<n>)")
    lc.add_argument("--append", action="store_true",
                    help="set: append to the bucket's rules instead of "
                         "replacing them")
    lc.add_argument("--max-keys", type=int, default=None,
                    help="run-now: bound the sweep's scan")
    lc.set_defaults(fn=cmd_lifecycle)

    geo = sub.add_parser("replication",
                         help="cross-cluster asynchronous bucket "
                              "replication")
    geo.add_argument("verb", choices=["set", "get", "clear", "run-now",
                                      "status"])
    geo.add_argument("path", nargs="?", default="",
                     help="/volume/bucket (set, get, clear)")
    geo.add_argument("--om", default="127.0.0.1:9860")
    geo.add_argument("--dest", default="",
                     help="set: the destination cluster's OM endpoint "
                          "HOST:PORT (comma-separated for a ring)")
    geo.add_argument("--prefix", default="",
                     help="set: key-name prefix filter")
    geo.add_argument("--dest-bucket", default="",
                     help="set: destination bucket (default: the source's "
                          "name)")
    geo.add_argument("--dest-volume", default="",
                     help="set: destination volume (default: the source's "
                          "name)")
    geo.add_argument("--scheme", default="",
                     help="set: destination replication scheme (default: "
                          "the source key's; an EC scheme re-encodes)")
    geo.add_argument("--id", default="", help="set: rule id (rule-<n>)")
    geo.add_argument("--append", action="store_true",
                     help="set: append to the bucket's rules instead of "
                          "replacing them")
    geo.add_argument("--max-entries", type=int, default=None,
                     help="run-now: bound the journal scan")
    geo.set_defaults(fn=cmd_replication)

    cl = sub.add_parser("cluster",
                        help="one-command local cluster: scm-om + N datanodes")
    cl.add_argument("--datanodes", type=int, default=5)
    cl.add_argument("--port", type=int, default=9860)
    cl.add_argument("--root", default="",
                    help="data directory (default: a fresh temporary one)")
    security_flags(cl)
    cl.add_argument("--secure", action="store_true",
                    help="mutual TLS with block tokens: the scm-om hosts "
                         "the CA (enrollment on --port + 1), the datanodes "
                         "enroll, and a client certificate is enrolled "
                         "under <root>/client-certs")
    cl.add_argument("--enrollment-secret", default="",
                    help="--secure: the bootstrap secret (default: a "
                         "random one, printed)")
    device_flag(cl)
    cl.set_defaults(fn=cmd_cluster)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except StorageError as e:
        print(f"error {e.code}: {e.msg}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
