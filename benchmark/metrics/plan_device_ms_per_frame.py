"""Bounce glue: device time of the activities launched inside the port's
``mesh.plan`` spans (root cull, plan rays, packet bins and their reads,
the streamed fallback's plan), in ms over the spp frames traced.  Nothing
to read without the program's spans (``program_trace.py``)."""

from program_trace import launched_inside_ms


def read(rec):
    if "program_spans" not in rec or not rec["frames"]:
        return None
    return launched_inside_ms(rec, lambda name: name == "mesh.plan") / rec["frames"]
