"""shardd: run one shard of the sharded metadata plane as a process.

Port of `ozone_tpu/tools/shardd.py`. One `shardd` process per shard
ring member, each carrying its slice of the namespace and the replicated
`system/shard_config` ownership row, with the full address book baked
into the shard map it serves to routing clients (GetShardMap is answered
by any shard, so a client bootstraps from whichever address it was
given):

    python -m ozone_tpu_torch.tools.shardd \\
        --base /var/ozone/s0 --shard-id s0 \\
        --shards s0=10.0.0.1:9860,s1=10.0.0.2:9860 --epoch 1

Every process must be started with the same --shards book and --epoch,
or the rings disagree about slot ownership (the per-request `check_shard`
gate turns that misconfiguration into SHARD_MOVED rejections rather than
silent misplacement). One process per ring is the only configuration in
which CPython shows horizontal metadata scaling: a single interpreter
serializes all rings on the GIL.

A shard does no coding on its metadata path. `--device` ("cuda" by
default, "cpu" for the plain PyTorch versions) is where its OM's
lifecycle sweep and geo ship cycles would code, as for `scm-om`; the
process does not touch CUDA until such a cycle has work. It exits 0 on
SIGTERM or SIGINT, within half a second whichever thread the signal
reaches.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="shardd", description="one shard of the sharded OM plane")
    ap.add_argument("--base", required=True,
                    help="data directory for this shard's OM/SCM state")
    ap.add_argument("--shard-id", required=True,
                    help="this process's shard id (must appear in --shards)")
    ap.add_argument("--shards", required=True,
                    help="full address book: sid=host:port,sid=host:port")
    ap.add_argument("--epoch", type=int, default=1)
    ap.add_argument("--slot-count", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the OM's background sweeps code")
    args = ap.parse_args(argv)

    book: dict[str, str] = {}
    for part in args.shards.split(","):
        sid, _, addr = part.partition("=")
        if not sid or not addr:
            ap.error(f"bad --shards entry {part!r} (want sid=host:port)")
        book[sid] = addr
    if args.shard_id not in book:
        ap.error(f"--shard-id {args.shard_id!r} not in --shards")

    from ozone_tpu_torch.net.daemons import ScmOmDaemon
    from ozone_tpu_torch.om.sharding.shardmap import SLOT_COUNT, ShardMap

    m = ShardMap.uniform(list(book), epoch=args.epoch, addresses=book,
                         slot_count=args.slot_count or SLOT_COUNT)
    daemon = ScmOmDaemon(
        Path(args.base) / "om.db",
        port=int(book[args.shard_id].rsplit(":", 1)[1]),
        stale_after_s=1000.0,
        dead_after_s=2000.0,
        background_interval_s=0.5,
        device=args.device,
        shard_config={
            "epoch": m.epoch,
            "shard_id": args.shard_id,
            "slot_count": m.slot_count,
            "owned": m.owned_slots(args.shard_id),
        },
        shard_map=m.to_json(),
    )
    daemon.start()
    print(f"shardd {args.shard_id} serving {book[args.shard_id]} "
          f"(epoch {m.epoch}, "
          f"{len(m.owned_slots(args.shard_id))}/{m.slot_count} slots)",
          flush=True)

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    # a timed wait, where the reference waits without one: Python runs a
    # signal's handler on the main thread only, and a signal the kernel
    # hands to one of the daemon's threads does not wake a main thread
    # blocked without a timeout, so the process would never stop
    while not stop.wait(0.5):
        pass
    daemon.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
