"""Device: the share of the traced window in which no kernel, copy or fill
ran on the device, in % (1 - the union of their intervals over the
window)."""

from tracing import idle_pct


def read(rec):
    return idle_pct(rec)
