"""End to end: the whole window over the frames displayed in it (host
clock)."""


def read(rec):
    return rec["window_s"] * 1e3 / rec["displays"] if rec["displays"] else None
