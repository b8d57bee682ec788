"""Renderer: host time inside the port's ``renderer.orbit_camera`` spans
(the rig, the camera and the film reset), in ms over the frames displayed
in the traced window, still ones included.  Nothing to read without the
program's spans (``program_trace.py``)."""

from program_trace import covered_ns, named


def read(rec):
    if "program_spans" not in rec or not rec["displays"]:
        return None
    spans = named(rec, lambda name: name == "renderer.orbit_camera")
    return covered_ns(spans) / 1e6 / rec["displays"]
