"""Kernels: device time of the port's hand-written kernels (``ptt_*``,
``csrc/*.cu``), in ms over the spp frames traced."""

from tracing import device_ms, is_program_kernel


def read(rec):
    return device_ms(rec, is_program_kernel) / rec["frames"] if rec["frames"] else None
