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

Every command whose process runs the codec takes `--device` ("cuda" by
default; "cpu" runs the plain PyTorch versions): `datanode`, `sh key
put/get`, `freon` and `cluster`, which passes it to its datanodes.
Without CUDA, "cuda" is an error that names CUDA. `scm-om` holds no codec.
The namespace and admin verbs import no torch, so they start in about a
second. Errors print as `error CODE: message` and exit 1.
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
    "bucket": {"create", "delete", "info", "list"},
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
        else:  # ecrd
            _emit(freon.ecrd(oz, s.scm, size=args.size, rounds=args.num,
                             replication=repl or "rs-6-3-1048576"))
    return 0


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
    d = ScmOmDaemon(Path(args.db), port=args.port,
                    min_datanodes=args.min_datanodes)
    d.start()
    print(f"scm+om serving on {d.address}", flush=True)
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
               str(args.port)], "scm-om.log")
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
    ad.add_argument("subject", choices=["status", "safemode", "container"])
    ad.add_argument("verb", nargs="?", default=None,
                    help="container: list|info <id>|close <id>")
    ad.add_argument("target", nargs="?", default=None)
    ad.add_argument("--om", default="127.0.0.1:9860")
    ad.set_defaults(fn=cmd_admin)

    fr = sub.add_parser("freon", help="load generators")
    fr.add_argument("generator", choices=["ockg", "ockr", "ockv", "ecrd"])
    fr.add_argument("-n", "--num", type=int, default=100)
    fr.add_argument("-s", "--size", type=int, default=10240)
    fr.add_argument("-t", "--threads", type=int, default=4)
    fr.add_argument("--om", default="127.0.0.1:9860")
    fr.add_argument("--replication", default="")
    device_flag(fr)
    fr.set_defaults(fn=cmd_freon)

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
    so.set_defaults(fn=cmd_scm_om)

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
