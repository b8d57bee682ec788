"""The traffic generator: one closed loop that drives the program through a
measured window, shaped by the parameters of a traffic file.

A step applies the user's input, traces ``spp_per_step`` spp
(``Renderer.step_many(..., sync=False)``) and, where the mix displays each
step, brings the preview of the whole frame to the host; the next step is
issued once the last has been issued, or once its image is on the host, so
the load follows the system and no rate is set.  With ``display`` "end" the
whole film comes to the host once, after the last step, inside the window:
the image an offline render hands its user.

The input alternates drags of ``drag_frames`` steps, each an orbit of the
camera (which resets the accumulation) in a direction drawn from the seed
with a per-step angle in ``[step_min, step_max]`` radians, and
``still_frames`` steps of no input.  With ``drag_frames`` 0 the camera is
fixed.

``window`` returns the window's ``clock`` (its length on the host clock,
the work done in it, each displayed step's latency), the ``out`` that the
output check reads and, in a traced run, the profiler's ``trace``.  A
traced run runs the window's first ``seconds - trace_seconds`` untraced,
then starts the profiler, gives it one warm-up step, and traces
``trace_seconds`` more (so its window is longer by the profiler's start and
warm-up).
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np

from tracing import HostReads, Profiled, span

DEFAULTS = {
    "why": "",
    "spp_per_step": None,  # None: the configuration's spp_per_launch
    "display": "end",  # "each": the preview to the host after every step
    "drag_frames": 0, "still_frames": 0,
    "step_min": 0.0, "step_max": 0.0, "phi_span": 0.0, "theta_span": 0.0,
    "warmup_steps": 2,
    "trace_seconds": 1.0,
    "check_pixels": 512,  # pixels of each compared image, drawn from the seed
    "check_drag_frames": 0, "check_still_frames": 0,  # displayed steps compared
}


def params(traffic: dict) -> dict:
    """The traffic file's parameters over the defaults; an unknown key or
    display is an error, not a silent default."""
    unknown = set(traffic) - set(DEFAULTS)
    if unknown:
        raise ValueError(f"unknown traffic parameters {sorted(unknown)}")
    out = dict(DEFAULTS, **traffic)
    if out["display"] not in ("each", "end"):
        raise ValueError(f"display is 'each' or 'end', not {out['display']!r}")
    return out


class InputPlan:
    """The input, step by step, drawn from ``rng``: each cycle is a drag in
    one direction with a step per frame in ``[step_min, step_max]``
    radians, then still frames.  A drag step that would take the rig beyond
    ``phi_span`` / ``theta_span`` of where it began turns back, so the
    camera keeps looking into the scene."""

    def __init__(self, traffic: dict, rng: np.random.Generator):
        self.t = traffic
        self.rng = rng
        self.moves = []  # one (dphi, dtheta) or None per step drawn so far
        self.phi = self.theta = 0.0  # offsets from the start

    def move(self, step: int):
        if not self.t["drag_frames"]:
            return None
        while len(self.moves) <= step:
            self._cycle()
        return self.moves[step]

    def _cycle(self) -> None:
        t = self.t
        angle = self.rng.uniform(0.0, 2.0 * math.pi)
        steps = self.rng.uniform(t["step_min"], t["step_max"], t["drag_frames"])
        for s in steps:
            dphi, dtheta = s * math.cos(angle), s * math.sin(angle)
            if abs(self.phi - dphi) > t["phi_span"]:
                dphi = -dphi
            if abs(self.theta - dtheta) > t["theta_span"]:
                dtheta = -dtheta
            self.phi -= dphi
            self.theta -= dtheta
            self.moves.append((float(dphi), float(dtheta)))
        self.moves.extend([None] * t["still_frames"])


def _sync():
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def spp_per_step(traffic: dict, spp_per_launch: int) -> int:
    """The spp a step traces: the mix's, or the configuration's launch."""
    return int(traffic["spp_per_step"] or max(1, spp_per_launch))


def warmup(r, traffic: dict) -> None:
    """The shapes of the window: ``warmup_steps`` steps, every other one
    after an input where the mix has any, each displayed where the mix
    displays; then the film is reset."""
    spp = spp_per_step(traffic, r.cfg.spp_per_launch)
    h, w = r.static.height, r.static.width
    for i in range(traffic["warmup_steps"]):
        if traffic["drag_frames"] and i % 2 == 0:
            r.orbit_camera(0.0, 0.0)
        r.step_many(spp, sync=False)
        if traffic["display"] == "each":
            r.preview_image(h, w)
    _sync()
    r.reset()


def _record(prof, frames: int, displays: int, host_reads) -> dict:
    """The traced part's record, which the per-layer readers read: the
    device activities that started inside it (the device was drained when
    it began) and the harness's spans."""
    lo, hi = [(s, e) for name, s, e in prof.spans if name == "traced"][0]
    return {"frames": frames, "displays": displays, "window": [lo, hi],
            "device": [d for d in prof.device if lo <= d[1] < hi],
            "spans": prof.spans, "host_reads": host_reads}


def window(r, traffic: dict, seconds: float, traced: bool, rng, pixels) -> dict:
    """The measured window.  The check reads, at ``pixels`` (flat ids of
    the image the host gets), each displayed image or the final film, the
    input that led to it, and the last iteration's alive counts."""
    plan = InputPlan(traffic, rng)
    spp = spp_per_step(traffic, r.cfg.spp_per_launch)
    each = traffic["display"] == "each"
    h, w = r.static.height, r.static.width
    latencies, outputs = [], {}
    reads = HostReads()
    done = [0]  # steps issued

    def step(sp, count_reads=False):
        ta = time.perf_counter()
        with sp("input"):
            move = plan.move(done[0])
            if move is not None:
                r.orbit_camera(*move)
        with sp("step"), (reads.counting() if count_reads else contextlib.nullcontext()):
            r.step_many(spp, sync=False)
        if each:
            with sp("preview"):
                img = r.preview_image(h, w)
            latencies.append(time.perf_counter() - ta)
            outputs[done[0]] = img.reshape(-1, 3)[pixels]
        done[0] += 1

    def readback(sp):
        if not each:
            with sp("readback"):
                outputs[done[0] - 1] = r.image().reshape(-1, 3)[pixels]

    quiet = lambda name: contextlib.nullcontext()  # noqa: E731
    _sync()
    t0 = time.perf_counter()
    plain_until = t0 + (max(0.0, seconds - traffic["trace_seconds"]) if traced else seconds)
    while True:
        step(quiet)
        if time.perf_counter() >= plain_until:
            break
    record = None
    if not traced:
        readback(quiet)
    else:
        with Profiled() as prof:
            step(quiet)  # the profiler's warm-up step
            prof.step()
            _sync()
            s0 = done[0]
            until = time.perf_counter() + traffic["trace_seconds"]
            with span("traced"), reads.recording():
                while True:
                    step(span, count_reads=True)
                    if time.perf_counter() >= until:
                        break
                readback(span)
            steps = done[0] - s0
            prof.step()
        record = _record(prof, steps * spp, steps if each else 0,
                         reads.count / (steps * spp))
    t1 = time.perf_counter()
    return {"clock": {"window_s": t1 - t0, "frames": done[0] * spp,
                      "displays": done[0] if each else 0, "latencies_s": latencies},
            "out": {"pixels": pixels, "outputs": outputs, "steps": done[0], "spp": spp,
                    "display": traffic["display"], "moves": [plan.move(i) for i in range(done[0])],
                    "alive": r._alive_counts.copy()},
            "trace": record}
