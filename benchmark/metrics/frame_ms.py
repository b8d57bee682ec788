"""End to end: the whole window, from the first launch to the final film on
the host, over the spp frames completed in it (host clock)."""


def read(rec):
    return rec["window_s"] * 1e3 / rec["frames"] if rec["frames"] else None
