"""Bounce glue: device time of the activities launched inside the port's
``mesh.sort`` spans (the coherence key or the carried key's argsort, and
the permutation of the path state), in ms over the spp frames traced.
Nothing to read without the program's spans (``program_trace.py``)."""

from program_trace import launched_inside_ms


def read(rec):
    if "program_spans" not in rec or not rec["frames"]:
        return None
    return launched_inside_ms(rec, lambda name: name == "mesh.sort") / rec["frames"]
