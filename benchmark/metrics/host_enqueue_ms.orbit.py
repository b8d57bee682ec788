"""Renderer: the host's time from a displayed frame's input to the return of
its ``step_many`` (the harness's ``input`` and ``step`` spans), mean over
the traced displays, in ms."""


def read(rec):
    if not rec["displays"]:
        return None
    ns = sum(e - s for name, s, e in rec["spans"] if name in ("input", "step"))
    return ns / 1e6 / rec["displays"]
