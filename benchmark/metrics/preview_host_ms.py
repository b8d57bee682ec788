"""Renderer: host time inside the port's ``renderer.preview`` spans less
the part inside its ``read.*`` spans (the image's copy to the host and the
grid's copies to the device, which wait for the device), in ms over the
frames displayed in the traced window.  Nothing to read without the
program's spans (``program_trace.py``)."""

from program_trace import self_ms


def read(rec):
    if "program_spans" not in rec or not rec["displays"]:
        return None
    return self_ms(rec, lambda name: name == "renderer.preview") / rec["displays"]
