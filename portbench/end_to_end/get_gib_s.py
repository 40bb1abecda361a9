"""User bytes returned by the GETs that completed inside the window, over
the window's length."""


def read(w):
    gets = w.done_in_window("get")
    if not gets:
        return None
    return sum(o.nbytes for o in gets) / w.seconds / 2**30
