"""The port's own spans in a traced run: the record and the breakdown
widened to what the program marks inside itself, and the arithmetic of the
readers that read them.

* ``ProgramProfiled`` is ``tracing.Profiled`` that also keeps the port's
  ``ptt.`` host spans (``utils/timers.py``: ``span``, ``host_read``) and,
  parallel to ``device``, the host time of the runtime call that launched
  each device activity (matched by the profiler's correlation id; None
  where no call is found); ``program_record`` gives the record's two new
  keys from it, ``program_spans`` (``(name, start, end)``, as ``spans``
  has them) and ``launched_ns``;
* ``idle_gaps_program`` is the breakdown's idle time by the innermost
  program span open at the middle of each gap, else by the harness span;
* the interval helpers serve the readers ``metrics/plan_device_ms_per_frame``,
  ``sort_device_ms_per_frame``, ``read_wait_ms_per_frame``,
  ``dispatch_host_ms_per_frame``, ``camera_host_ms`` and ``preview_host_ms``,
  which read None from a record without ``program_spans``.

Nothing here changes what the harness already reads: the program's spans
are host annotations, never device activities.  ``loops`` does not yet
use ``ProgramProfiled`` nor ``program_record``, and ``BENCHMARK.json``
does not yet list the six metrics, so ``run.py`` reports none of them.
"""

from __future__ import annotations

import bisect

import tracing

PROGRAM_PREFIX = "ptt."
RUNTIME_KINDS = ("cuda_runtime", "cuda_driver")


def is_runtime_call(e) -> bool:
    """A host call into CUDA's API (a launch, a copy, a synchronize), which
    shares its correlation id with the device activity it starts.  Where the
    profiler names no activity kinds (torch before 2.13), by its name."""
    if e.device_type() != tracing._CPU:
        return False
    if hasattr(e, "activity_type"):
        return e.activity_type() in RUNTIME_KINDS
    return e.name().startswith("cu")


class ProgramProfiled(tracing.Profiled):
    """``tracing.Profiled`` that also keeps the program's host spans
    (``program``) and each device activity's launch time (``launched``,
    parallel to ``device``)."""

    def __init__(self):
        super().__init__()
        self.program, self.launched = [], []

    def _ready(self, prof) -> None:
        super()._ready(prof)
        events = list(prof.profiler.kineto_results.events())
        calls = {}
        for e in events:
            if is_runtime_call(e):
                calls[e.correlation_id()] = e.start_ns()
        for e in events:
            name = e.name()
            if tracing.is_device_activity(e, name):
                self.launched.append(calls.get(e.correlation_id()))
            elif name.startswith(PROGRAM_PREFIX) and e.device_type() == tracing._CPU:
                self.program.append((name[len(PROGRAM_PREFIX):], e.start_ns(), e.end_ns()))


def program_record(rec: dict, prof: ProgramProfiled) -> dict:
    """The record's new keys: the program's spans and, for the device
    activities the record kept, their launch times, in its order."""
    lo, hi = tracing.window(rec)
    launched = [t for d, t in zip(prof.device, prof.launched) if lo <= d[1] < hi]
    return {"program_spans": prof.program, "launched_ns": launched}


def _merged(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return out


def covered_ns(intervals) -> int:
    """Length of the union of ``intervals``."""
    return sum(e - s for s, e in _merged(intervals))


def overlap_ns(a, b) -> int:
    """Length of (the union of ``a``) ∩ (the union of ``b``)."""
    a, b = _merged(a), _merged(b)
    total = i = j = 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def named(rec, keep) -> list:
    """``(start, end)`` of the program spans whose name ``keep`` accepts."""
    return [(s, e) for name, s, e in rec["program_spans"] if keep(name)]


def launched_inside_ms(rec, keep) -> float:
    """Device time, in ms, of the activities launched while a program span
    that ``keep`` accepts was open (its children's launches included)."""
    spans = _merged(named(rec, keep))
    starts = [s for s, _ in spans]
    total = 0
    for (_, s, e), t in zip(rec["device"], rec["launched_ns"]):
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        if i >= 0 and t < spans[i][1]:
            total += e - s
    return total / 1e6


def self_ms(rec, keep) -> float:
    """Host time, in ms, inside the spans ``keep`` accepts, less the part of
    it inside ``read.*`` spans: the host's own work there, not its waits."""
    spans = named(rec, keep)
    reads = named(rec, lambda n: n.startswith("read."))
    return (covered_ns(spans) - overlap_ns(spans, reads)) / 1e6


def idle_gaps_program(rec, top: int = 10) -> list:
    """The device's idle time, in seconds, by the innermost program span
    open at the middle of each gap, else by the innermost harness span."""
    lo, hi = tracing.window(rec)
    idle = {}
    for s, e in tracing.gaps([(s, e) for _, s, e in rec["device"]], lo, hi):
        mid = (s + e) // 2
        key = tracing.open_span(rec["program_spans"], mid)
        if key == "none":
            key = tracing.open_span(rec["spans"], mid)
        idle[key] = idle.get(key, 0) + (e - s)
    return [[k, v / 1e9] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:top]]
