"""Data bytes of the codec submissions whose parity and CRC32C words reached
their submitters inside the window, over the window's length."""


def read(w):
    done = w.done_in_window("encode")
    if not done:
        return None
    return sum(o.nbytes for o in done) / w.seconds / 2**30
