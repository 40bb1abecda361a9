"""Client-side time in the OM's open and commit (spans `om:open_key` and
`om:commit`) per PUT of the window."""


def read(w):
    puts = w.ops("put")
    total = w.span_total_s("om:open_key", "om:commit")
    if not puts or not total:
        return None
    return 1e3 * total / len(puts)
