"""The fused kernel's share of its roofline in the degraded GETs' decodes:
the least time the window's GETs need (`roofline.fused_bound` of one
stripe per group with its erased data units, read from k survivors; a
lane's zero padding is not work the inputs need) over the kernel's summed
device time."""

from portbench.harness.roofline import fused_bound


def read(w):
    kernels = w.kernels("fused_encode_crc_kernel")
    t = sum(e["end"] - e["start"] for e in kernels)
    cfg = w.cell.config
    k, cell = cfg["data_units"], cfg["cell_bytes"]
    need = 0.0
    for op in w.ops("get"):
        for erased in op.extra.get("erased", ()):
            e = sum(1 for u in erased if u < k)
            if e:
                stripes = -(-op.nbytes // (k * cell))
                need += fused_bound(stripes, k, e, cell,
                                    cfg["bytes_per_checksum"], rows=e)[0]
    if not kernels or t <= 0 or need <= 0:
        return None
    return 100.0 * need / t
