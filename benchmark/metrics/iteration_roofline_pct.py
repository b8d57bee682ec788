"""Kernels: the iteration kernel's share of its roofline, in %: the least
time the card could take for one spp iteration (``work.iteration_work``,
the benchmark's own count of the film's bytes and the operations from the
frame's alive counts, against the published peaks of ``work.py``) over the
device time of ``ptt_iteration_kernel`` per spp frame traced.  Nothing to
read where that kernel did not run."""

from tracing import device_ms, kernel_name
from work import bound_ms


def read(rec):
    if "work" not in rec or not rec["frames"]:
        return None
    ms = device_ms(rec, lambda name: kernel_name(name) == "ptt_iteration_kernel")
    if ms <= 0.0:
        return None
    return 100.0 * bound_ms(*rec["work"])[0] / (ms / rec["frames"])
