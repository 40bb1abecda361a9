"""The fused kernel's share of its roofline in the decode form: the least
time the window's submissions need on an H100 (`roofline.fused_bound` of
each completed submission's [B, k, C] survivors, its erased units and
their CRC words) over the kernel's summed device time."""

from portbench.harness.roofline import fused_bound


def read(w):
    kernels = w.kernels("fused_encode_crc_kernel")
    t = sum(e["end"] - e["start"] for e in kernels)
    cfg, tr = w.cell.config, w.cell.traffic
    done = w.ops("decode")
    e = len(tr.get("erased_units", ()))
    if not kernels or t <= 0 or not done or not e:
        return None
    need, _ = fused_bound(int(tr["batch_stripes"]), cfg["data_units"], e,
                          cfg["cell_bytes"], cfg["bytes_per_checksum"], rows=e)
    return 100.0 * need * len(done) / t
