"""Bounce glue: host time inside the port's ``mesh.*`` spans less the part
inside its ``read.*`` spans, in ms over the spp frames traced: the Python
and the launches of the mesh bounces, without their waits.  Nothing to
read without the program's spans (``program_trace.py``)."""

from program_trace import self_ms


def read(rec):
    if "program_spans" not in rec or not rec["frames"]:
        return None
    return self_ms(rec, lambda name: name.startswith("mesh.")) / rec["frames"]
