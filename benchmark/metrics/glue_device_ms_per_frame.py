"""Bounce glue: device time of every activity that is not one of the port's
hand-written kernels (``ptt_*``): torch kernels, copies and fills, in ms
over the spp frames traced."""

from tracing import device_ms, is_program_kernel


def read(rec):
    if not rec["frames"]:
        return None
    return device_ms(rec, lambda name: not is_program_kernel(name)) / rec["frames"]
