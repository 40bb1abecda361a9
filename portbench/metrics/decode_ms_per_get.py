"""Time the degraded reads' decodes spent in the codec service, queued and
dispatched (spans `codec:queue_wait` and `codec:dispatch` of decode
lanes, which the service records in each reader's trace), per GET of the
window. `ec:decode_from_parity` marks only the hedge's width-1 decode, so
it is not read here."""


def _decode(s):
    return "'decode'" in str(s["tags"].get("lane", ""))


def read(w):
    gets = w.ops("get")
    total = w.span_total_s("codec:queue_wait", "codec:dispatch", where=_decode)
    if not gets or not total:
        return None
    return 1e3 * total / len(gets)
