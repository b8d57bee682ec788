"""Performance timing utilities.

Counterpart of ``StreamCompaction::Common::PerformanceTimer``
(``stream_compaction/common.h:46-130``) and the ImGui ms/frame readout
(``src/main.cpp:288``) that is the source of all reference benchmark numbers.

The JAX package brackets work with a ``device_sync`` that fetches one scalar
to the host, because ``block_until_ready`` did not wait on its remote TPU
backend.  PyTorch on CUDA has no such gap: a pair of ``torch.cuda.Event`` on
the current stream times the device work itself, without a host round trip
inside the timed region, so ``device_sync`` is not ported.

``span`` and ``host_read`` mark the program's layers for ``torch.profiler``:
each is a ``record_function`` span named ``ptt.<name>`` (``ptt.read.<site>``
for a synchronizing device-to-host read) while a profiler is running, so the
spans land in the profiler's trace on the clock of its device activities,
and one shared no-op behind one flag test otherwise.  The trace is their
only store: the number of ``ptt.read.<site>`` spans counts that site's
reads, and their durations are the host's wait there.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import List

import torch
import torch.autograd.profiler as _autograd_profiler

SPAN_PREFIX = "ptt."
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A span ``ptt.<name>`` around a layer's work while a torch profiler
    records; the shared no-op otherwise.  Nesting on the host thread gives
    a span its parent, and order its index: the k-th ``mesh.bounce`` of a
    step is bounce k (the trace keeps no ``record_function`` string args)."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return _NO_SPAN


def host_read(site: str):
    """``span("read.<site>")``: wrap one synchronizing device-to-host read
    (``int``, ``bool``, ``.item()``, ``.tolist()``, ``.cpu()`` of a CUDA
    tensor) or host-to-device copy that waits for the device."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(SPAN_PREFIX + "read." + site)
    return _NO_SPAN


class PerformanceTimer:
    """start/stop timer: CUDA events on a CUDA device, the host clock on the
    CPU (where PyTorch runs synchronously)."""

    def __init__(self, device="cpu") -> None:
        self.device = torch.device(device)
        self._t0 = None
        self.elapsed_ms = 0.0

    def start(self) -> None:
        if self._t0 is not None:
            raise RuntimeError("timer already started")
        if self.device.type == "cuda":
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self._t0 is None:
            raise RuntimeError("timer not started")
        if self.device.type == "cuda":
            t1 = torch.cuda.Event(enable_timing=True)
            t1.record()
            t1.synchronize()
            self.elapsed_ms = self._t0.elapsed_time(t1)
        else:
            self.elapsed_ms = (time.perf_counter() - self._t0) * 1e3
        self._t0 = None
        return self.elapsed_ms


@dataclass
class FrameStats:
    """Running ms/frame average (the reference's perf oracle)."""

    times_ms: List[float] = field(default_factory=list)

    def add(self, ms: float) -> None:
        self.times_ms.append(ms)

    @property
    def mean_ms(self) -> float:
        return sum(self.times_ms) / max(1, len(self.times_ms))

    @property
    def fps(self) -> float:
        m = self.mean_ms
        return 1000.0 / m if m > 0 else 0.0

    def mrays_per_s(self, rays_per_frame: float) -> float:
        m = self.mean_ms
        return rays_per_frame / (m * 1e3) if m > 0 else 0.0
