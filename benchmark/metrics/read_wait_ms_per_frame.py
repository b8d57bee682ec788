"""Bounce glue: host time inside the port's ``read.*`` spans (each a
synchronizing read) within the harness's ``step`` spans, in ms over the
spp frames traced: the host blocked on the device.  Nothing to read
without the program's spans (``program_trace.py``)."""

from program_trace import named, overlap_ns


def read(rec):
    if "program_spans" not in rec or not rec["frames"]:
        return None
    steps = [(s, e) for name, s, e in rec["spans"] if name == "step"]
    reads = named(rec, lambda name: name.startswith("read."))
    return overlap_ns(reads, steps) / 1e6 / rec["frames"]
