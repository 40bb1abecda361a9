"""The port's CLI: daemons, shell, admin and freon.

Port of the part of `ozone_tpu/tools/cli.py` that runs and drives a
cluster of processes (the reference's `ozone sh` volume/bucket/key verbs,
`ozone admin` status and container verbs, `ozone freon` generators and
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
    python -m ozone_tpu_torch.tools scm-om --db /data/m0/om.db --port 9860 \
        --ha-id m0 --peer m0=127.0.0.1:9860 --peer m1=127.0.0.1:9861 \
        --peer m2=127.0.0.1:9862
    python -m ozone_tpu_torch.tools admin ring-status --om 127.0.0.1:9861
    python -m ozone_tpu_torch.tools admin ring-transfer m1 \
        --om 127.0.0.1:9860,127.0.0.1:9861,127.0.0.1:9862

Every command whose process runs the codec takes `--device` ("cuda" by
default; "cpu" runs the plain PyTorch versions): `datanode`, `sh key
put/get`, `freon`, `s3g`, `scm-om` (its lifecycle sweep and slab
compaction encode there) and `cluster`, which passes it to its children.
Without CUDA, "cuda" is an error that names CUDA (for `scm-om`, at its
first sweep with work). The namespace, admin and lifecycle verbs import
no torch, so they start in about a second. Against a metadata ring,
`--om` takes the replicas as a comma-separated list; the clients follow
the leader. Errors print as
`error CODE: message` and exit 1.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
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


class _Session:
    """A remote OM client and the datanode factory it feeds, closed on
    exit; `client(device)` is an OzoneClient over them."""

    def __init__(self, om_address: str):
        from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
        from ozone_tpu_torch.net.om_service import RemoteOmClient
        from ozone_tpu_torch.net.scm_service import RemoteScmClient

        self.clients = DatanodeClientFactory()
        self.om = RemoteOmClient(om_address, clients=self.clients)
        self.scm = RemoteScmClient(om_address)

    def client(self, device: str):
        from ozone_tpu_torch.client.ozone_client import OzoneClient

        # learn the datanodes up front: ecrd and repairs dial nodes no
        # allocation named
        addresses, locations = self.scm.node_topology()
        for dn_id, addr in addresses.items():
            self.clients.register_remote(dn_id, addr)
        self.clients.learn_locations(locations)
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
    "volume": {"create", "delete", "info", "list"},
    "bucket": {"create", "delete", "info", "list", "set-smallobj"},
    "key": {"put", "get", "info", "list", "delete"},
}


def cmd_sh(args) -> int:
    kind, verb = args.object, args.verb
    if verb not in _SH_VERBS[kind]:
        return _usage(f"'{verb}' is not a {kind} verb (expected one of "
                      f"{sorted(_SH_VERBS[kind])})")
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
                                 args.replication or "rs-6-3-1024k")
            elif verb == "delete":
                om.delete_bucket(vol, bucket)
            elif verb == "set-smallobj":
                _emit(om.set_bucket_smallobj(vol, bucket))
            else:
                _emit(om.bucket_info(vol, bucket))
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
            else:
                oz = s.client(_device(args))
                b = oz.get_volume(vol).get_bucket(bucket)
                if verb == "put":
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


# -------------------------------------------------------------------- admin
def cmd_admin(args) -> int:
    from ozone_tpu_torch.net.scm_service import RemoteScmClient

    scm = RemoteScmClient(args.om)
    try:
        subject, verb, target = args.subject, args.verb, args.target
        if subject == "status":
            _emit(scm.status())
        elif subject == "safemode":
            if verb not in (None, "status"):
                return _usage(f"unknown safemode verb {verb!r} "
                              "(expected status)")
            _emit(scm.admin("safemode-status"))
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

    om = RemoteOmClient(args.om)
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


# ------------------------------------------------------------------ daemons
def cmd_datanode(args) -> int:
    device = _device(args)  # before anything binds or registers
    from ozone_tpu_torch.net.daemons import DatanodeDaemon

    logging.basicConfig(level=logging.INFO)
    dn_id = args.id or Path(args.root).name
    d = DatanodeDaemon(Path(args.root), dn_id, args.scm, port=args.port,
                       rack=args.rack,
                       heartbeat_interval_s=args.heartbeat_interval,
                       scan_interval_s=args.scan_interval, device=device)
    d.start()
    lane = d.advertise()
    native = f"{lane['port']} uds={lane['uds']}" if lane else "off"
    print(f"datanode {dn_id} serving on {d.address}, scm={args.scm}, "
          f"native datapath={native}, device={d.device}", flush=True)
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
    d = ScmOmDaemon(Path(args.db), port=args.port,
                    min_datanodes=args.min_datanodes, device=args.device,
                    ha_id=args.ha_id if ha_peers else None,
                    ha_peers=ha_peers)
    d.start()
    print(f"scm+om serving on {d.address}"
          + (f" as HA node {args.ha_id}" if ha_peers else ""), flush=True)
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
    scm = RemoteScmClient(om)
    try:
        # all at once: a datanode that comes up before the metadata server
        # registers on a later heartbeat
        spawn(["scm-om", "--db", str(root / "om.db"), "--port",
               str(args.port), "--device", device], "scm-om.log")
        for i in range(args.datanodes):
            spawn(["datanode", "--root", str(root / f"dn{i}"), "--scm", om,
                   "--id", f"dn{i}", "--device", device], f"dn{i}.log")
        _wait("the datanodes did not register",
              lambda: len(scm.status()["nodes"]) >= args.datanodes, 120,
              children_alive)
    except BaseException:
        teardown()
        raise
    finally:
        scm.close()
    print(f"cluster up: om={om} datanodes={args.datanodes} device={device} "
          f"root={root} pids={[p.pid for p in procs]}", flush=True)
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
    device_flag(sh)
    sh.set_defaults(fn=cmd_sh)

    ad = sub.add_parser("admin", help="cluster admin (ozone admin)")
    ad.add_argument("subject", choices=["status", "safemode", "container",
                                        "ring-status", "ring-add",
                                        "ring-remove", "ring-transfer"])
    ad.add_argument("verb", nargs="?", default=None,
                    help="container: list|info <id>|close <id>; ring-add: "
                         "<id>=<host:port>; ring-remove, ring-transfer: <id>")
    ad.add_argument("target", nargs="?", default=None)
    ad.add_argument("--om", default="127.0.0.1:9860")
    ad.set_defaults(fn=cmd_admin)

    fr = sub.add_parser("freon", help="load generators")
    fr.add_argument("generator",
                    choices=["ockg", "ockr", "ockv", "ecrd", "mpug", "s3kg",
                             "lcg", "tinyg"])
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
    fr.add_argument("--endpoint", default="127.0.0.1:9878",
                    help="s3kg: S3 gateway host:port")
    fr.add_argument("--access-id", default="",
                    help="s3kg: sign every request with this access id's "
                         "secret, fetched from --om (default: unsigned)")
    device_flag(fr)
    fr.set_defaults(fn=cmd_freon)

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
    dn.add_argument("--heartbeat-interval", type=float, default=1.0)
    dn.add_argument("--scan-interval", type=float, default=300.0,
                    help="seconds between background scrubs (0: none)")
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

    cl = sub.add_parser("cluster",
                        help="one-command local cluster: scm-om + N datanodes")
    cl.add_argument("--datanodes", type=int, default=5)
    cl.add_argument("--port", type=int, default=9860)
    cl.add_argument("--root", default="",
                    help="data directory (default: a fresh temporary one)")
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
