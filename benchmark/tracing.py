"""The traced run's record: device activities and the harness's host spans
from one ``torch.profiler`` window, and the arithmetic the per-layer
readers and the breakdown share.

Every time here is in nanoseconds on the profiler's clock, on which the
host spans and the device activities are aligned.  Only kernels, copies and
fills are device activities: the profiler's own step span, which it also
draws on the device's timeline, is not work.
"""

from __future__ import annotations

import contextlib

import torch

SPAN_PREFIX = "bench."
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def span(name: str):
    """A host span of the harness, named ``bench.<name>``."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


_CPU = torch.autograd.DeviceType.CPU
_CUDA = torch.autograd.DeviceType.CUDA


def is_device_activity(e, name: str) -> bool:
    """A kernel, copy or fill on the device.  Where the profiler names an
    event's activity, that decides; otherwise a device event that is not a
    span mirrored onto the device's timeline (the profiler's steps, the
    harness's spans)."""
    if hasattr(e, "activity_type"):
        return e.activity_type() in DEVICE_KINDS
    if e.device_type() != _CUDA or name.startswith(("ProfilerStep#", SPAN_PREFIX)):
        return False
    return not (hasattr(e, "is_user_annotation") and e.is_user_annotation())


class Profiled:
    """A profiler with one warm-up step, then the traced step.  Once the
    traced step has ended, ``device`` holds its device activities
    ``(name, start, end)`` and ``spans`` the harness's host spans."""

    def __init__(self):
        self.device, self.spans = [], []
        sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts, schedule=sched,
                                            on_trace_ready=self._ready)

    def _ready(self, prof) -> None:
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if is_device_activity(e, name):
                self.device.append((name, e.start_ns(), e.end_ns()))
            elif name.startswith(SPAN_PREFIX) and e.device_type() == _CPU:
                self.spans.append((name[len(SPAN_PREFIX):], e.start_ns(), e.end_ns()))

    def __enter__(self):
        self._prof.__enter__()
        return self

    def step(self) -> None:
        self._prof.step()

    def __exit__(self, *exc):
        return self._prof.__exit__(*exc)


class HostReads:
    """Counts the synchronizing device-to-host reads made inside
    ``counting()`` (``torch.cuda.set_sync_debug_mode("warn")``), while
    ``recording()`` is open.  ``counting()`` only switches the mode, so it
    costs the host a few microseconds a call; the warnings are gathered
    once, around the whole stretch."""

    def __init__(self):
        self.count = 0

    @contextlib.contextmanager
    def recording(self):
        import warnings

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
        self.count += sum(1 for w in caught if "synchroniz" in str(w.message))

    @contextlib.contextmanager
    def counting(self):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)


def _clipped(intervals, lo: int, hi: int) -> list:
    return sorted((max(s, lo), min(e, hi)) for s, e in intervals if min(e, hi) > max(s, lo))


def union_ns(intervals, lo: int, hi: int) -> int:
    """Length of the union of ``(start, end)`` intervals clipped to
    ``[lo, hi]``; overlapping intervals count once."""
    total, reach = 0, lo
    for s, e in _clipped(intervals, lo, hi):
        if e <= reach:
            continue
        total += e - max(s, reach)
        reach = e
    return total


def gaps(intervals, lo: int, hi: int) -> list:
    """The idle stretches ``(start, end)`` of ``[lo, hi]`` that no interval
    covers."""
    out, reach = [], lo
    for s, e in _clipped(intervals, lo, hi):
        if s > reach:
            out.append((reach, s))
        reach = max(reach, e)
    if reach < hi:
        out.append((reach, hi))
    return out


def window(rec) -> tuple:
    return rec["window"][0], rec["window"][1]


def device_busy_ns(rec) -> int:
    lo, hi = window(rec)
    return union_ns([(s, e) for _, s, e in rec["device"]], lo, hi)


def idle_pct(rec) -> float:
    lo, hi = window(rec)
    return 100.0 * (1.0 - device_busy_ns(rec) / (hi - lo))


def device_ms(rec, keep) -> float:
    """Summed device time, in ms, of the activities whose name ``keep``
    accepts."""
    return sum(e - s for name, s, e in rec["device"] if keep(name)) / 1e6


def kernel_name(name: str) -> str:
    """A kernel's function name: without ``void ``, anonymous namespaces,
    template arguments and arguments."""
    name = name[5:] if name.startswith("void ") else name
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].strip()


def is_program_kernel(name: str) -> bool:
    """A hand-written kernel of the port (``csrc/*.cu``, named ``ptt_*``)."""
    return kernel_name(name).startswith("ptt_")


def open_span(spans, t: int) -> str:
    """The innermost harness span open at ``t`` ("none" outside them)."""
    best = None
    for name, s, e in spans:
        if s <= t < e and (best is None or s >= best[1]):
            best = (name, s)
    return best[0] if best else "none"


def breakdown(rec, top: int = 10) -> dict:
    """The device operations that took most time, by kernel name, and the
    idle time of the device by what the host was doing (the innermost
    harness span open at the middle of each gap), in seconds."""
    ops = {}
    for name, s, e in rec["device"]:
        key = kernel_name(name)
        ops[key] = ops.get(key, 0) + (e - s)
    lo, hi = window(rec)
    idle = {}
    for s, e in gaps([(s, e) for _, s, e in rec["device"]], lo, hi):
        key = open_span(rec["spans"], (s + e) // 2)
        idle[key] = idle.get(key, 0) + (e - s)
    rank = lambda d: [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(ops), "idle_gaps": rank(idle)}
