"""Renderer: device activities (kernels, copies, fills) in the traced window
over the spp frames traced."""


def read(rec):
    return len(rec["device"]) / rec["frames"] if rec["frames"] else None
