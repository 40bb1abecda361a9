"""Time in the EC reader's chunk reads from the datanodes, host CRC32C
checks included (spans `net:read_chunk`, one per cell, and
`net:read_chunks`, one per unit and batch of two or more stripes; summed
over the reader's threads) per GET of the window."""


def read(w):
    gets = w.ops("get")
    total = w.span_total_s("net:read_chunk", "net:read_chunks")
    if not gets or not total:
        return None
    return 1e3 * total / len(gets)
