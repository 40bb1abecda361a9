"""The fused encode kernel's share of its roofline: the least time the
window's encodes need on an H100 (`roofline.fused_bound` of each completed
submission's [B, k, C] batch) over the kernel's summed device time."""

from portbench.harness.roofline import fused_bound


def read(w):
    kernels = w.kernels("fused_encode_crc_kernel")
    t = sum(e["end"] - e["start"] for e in kernels)
    cfg, tr = w.cell.config, w.cell.traffic
    done = w.ops("encode")
    if not kernels or t <= 0 or not done:
        return None
    need, _ = fused_bound(int(tr["batch_stripes"]), cfg["data_units"],
                          cfg["parity_units"], cfg["cell_bytes"],
                          cfg["bytes_per_checksum"])
    return 100.0 * need * len(done) / t
