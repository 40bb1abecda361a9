"""OM metadata at scale: the operations that must stay flat as the
namespace grows.

Port of `ozone_tpu/tools/om_scale.py`. Writes an N-key OM store with the
port's `freon.dbgen` (the reference's freon GeneratorOm, which it uses
to build billion-key databases), then measures on the port's store and
OM:

- point lookup (OmMetadataManager getKeyTable().get);
- a paged list under a prefix (one listKeys page of 1000 rows);
- open and commit of NEW keys on the populated store;
- the paged quota repair's wall time and the worst stall of a writer
  running beside it;
- snapshot create and an incremental snapdiff of 10 changes.

Usage:  python -m ozone_tpu_torch.tools.om_scale --keys 1000000 \
            --db DIR/omscale.db [--skip-snapshot]

`--db` is the store's path, which the caller gives (any file there is
replaced). Metadata only: no datanode, no codec, no torch. Prints one
JSON object.
"""

from __future__ import annotations

import argparse
import json
import random
import statistics
import sys
import threading
import time
from pathlib import Path


def _pct(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * p))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--keys", type=int, default=1_000_000)
    ap.add_argument("--db", required=True,
                    help="the store's path (replaced if it exists)")
    ap.add_argument("--lookups", type=int, default=2000)
    ap.add_argument("--commits", type=int, default=2000)
    ap.add_argument("--skip-snapshot", action="store_true")
    args = ap.parse_args(argv)

    from ozone_tpu_torch.om.metadata import OMMetadataStore, key_key
    from ozone_tpu_torch.om.om import OzoneManager
    from ozone_tpu_torch.scm.scm import StorageContainerManager
    from ozone_tpu_torch.tools import freon

    out: dict = {"keys": args.keys}
    db = Path(args.db)
    if db.exists():
        db.unlink()

    t0 = time.monotonic()
    rep = freon.dbgen(db, n_keys=args.keys)
    out["dbgen_s"] = round(time.monotonic() - t0, 2)
    out["dbgen_keys_per_s"] = round(args.keys / max(out["dbgen_s"], 1e-3))
    print(f"# dbgen: {args.keys} keys in {out['dbgen_s']}s "
          f"({out['dbgen_keys_per_s']}/s), failures={rep.failures}",
          file=sys.stderr)

    t0 = time.monotonic()
    store = OMMetadataStore(db)
    out["open_s"] = round(time.monotonic() - t0, 2)

    # ---- point lookups over random existing keys
    rng = random.Random(7)
    ids = [rng.randrange(args.keys) for _ in range(args.lookups)]
    lat = []
    for i in ids:
        kk = key_key("genvol", "genbucket", f"gen/{i // 1000}/key-{i}")
        t0 = time.perf_counter()
        row = store.get("keys", kk)
        lat.append((time.perf_counter() - t0) * 1e6)
        assert row is not None, kk
    out["lookup_us_p50"] = round(statistics.median(lat), 1)
    out["lookup_us_p99"] = round(_pct(lat, 0.99), 1)

    # ---- paged listing under a prefix (1000-row pages, the listKeys
    # backend), from starts spread across the namespace
    lat = []
    for i in range(50):
        pfx = f"/genvol/genbucket/gen/{rng.randrange(args.keys // 1000)}/"
        t0 = time.perf_counter()
        rows = store.iterate_range("keys", pfx, limit=1000)
        lat.append((time.perf_counter() - t0) * 1e3)
        assert rows
    out["list_page_ms_p50"] = round(statistics.median(lat), 2)
    out["list_page_ms_p99"] = round(_pct(lat, 0.99), 2)
    store.close()

    # ---- OM on top of the populated store: new-key open+commit
    scm = StorageContainerManager(stale_after_s=1e6, dead_after_s=2e6)
    for i in range(5):
        scm.register_datanode(f"dn{i}")
    om = OzoneManager(db, scm, device="cpu")  # no key data: no codec
    t0 = time.monotonic()
    for i in range(args.commits):
        s = om.open_key("genvol", "genbucket", f"fresh/key-{i}")
        om.commit_key(s, [], 0)
    dt = time.monotonic() - t0
    out["commit_ops_per_s"] = round(args.commits / dt)

    # ---- paged quota repair + worst concurrent-writer stall
    stalls = []
    stop = threading.Event()

    def writer():
        n = 0
        while not stop.is_set():
            t0 = time.perf_counter()
            s = om.open_key("genvol", "genbucket", f"during/key-{n}")
            om.commit_key(s, [], 0)
            stalls.append(time.perf_counter() - t0)
            n += 1
            time.sleep(0.005)

    th = threading.Thread(target=writer, daemon=True)
    th.start()
    t0 = time.monotonic()
    rep = om.repair_quota("genvol")
    out["repair_quota_s"] = round(time.monotonic() - t0, 2)
    stop.set()
    th.join(timeout=10)
    out["repair_writer_stall_ms_max"] = round(max(stalls) * 1e3, 1)
    out["repair_key_count"] = rep["volume_key_count"]

    # ---- snapshots: create + incremental diff of 10 changes
    if not args.skip_snapshot:
        t0 = time.monotonic()
        om.create_snapshot("genvol", "genbucket", "s1")
        out["snapshot_create_s"] = round(time.monotonic() - t0, 2)
        for i in range(10):
            s = om.open_key("genvol", "genbucket", f"diff/key-{i}")
            om.commit_key(s, [], 0)
        om.create_snapshot("genvol", "genbucket", "s2")
        t0 = time.monotonic()
        diff = om.snapshot_diff("genvol", "genbucket", "s1", "s2")
        out["snapdiff_10changes_s"] = round(time.monotonic() - t0, 2)
        out["snapdiff_mode"] = diff.get("mode")
        out["snapdiff_entries"] = (
            len(diff.get("added", [])) + len(diff.get("deleted", []))
            + len(diff.get("modified", [])) + len(diff.get("renamed", [])))
    om.close()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
