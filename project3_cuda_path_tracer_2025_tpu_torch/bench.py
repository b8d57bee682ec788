"""The headline benchmark of the port: ``scenes/cornell.json`` at 800x800,
depth 8, ms/frame on one NVIDIA GPU (the port of the repo's ``bench.py``).

    python bench_torch.py          # from the repo root; one JSON line

Prints ONE JSON line with ``bench.py``'s keys: ``metric``, ``value``
(ms/frame of the batched window), ``unit``, ``vs_baseline`` (42.204 ms /
``value``: the reference's closest published proxy, a diffuse scene with
stream compaction on an RTX 3060 Laptop, reference README.md:133-136),
``baseline_ms``, ``mrays_per_s``, ``frames_timed``, ``spp_per_launch``,
``unbatched_ms_per_frame`` (32 pipelined ``step(sync=False)``, one
synchronize), ``unbatched_sync_ms_per_frame`` (8 synced ``step()``, CUDA
events), ``device_compute_ms_per_frame`` and ``dispatch_overhead_ms`` (the
K/2K control), ``film_finite``, ``device`` (``nvidia-smi``'s name and power
limit) and ``mesh_roofline`` (``scripts/torch_roofline_mesh.py``'s line, or
an ``error`` note).  ``BENCH_BATCH`` (64), ``BENCH_WARMUP`` (2),
``BENCH_REPS`` (4) and ``BENCH_MESH`` ("1") set it up, as for ``bench.py``.

The K/2K control times one ``step_many(K)`` and one ``step_many(2K)``
window, each closed by a synchronize; their difference over K is the
per-frame cost with the fixed part of a window cancelled.  ``step_many(k)``
is k host dispatches here (one in the JAX package), so that slope is the
per-frame cost of whichever of the host or the device sets the pace.

Without a CUDA device it prints the error-shaped line (``value`` null, an
``error``) and exits 1: there is no CPU run and no fallback.  ``measure``
is the body, which the tests run on the CPU at a small size.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from .config import RenderConfig
from .models import Renderer
from .scene import load_scene, set_resolution
from .utils.measure import card_label
from .utils.timers import FrameStats

ROOT = pathlib.Path(__file__).resolve().parents[1]
METRIC = "cornell.json 800x800 depth-8 ms/frame"
BASELINE_MS = 42.204  # reference README.md:133-136
# The line's keys, bench.py's (``mesh_roofline`` only with BENCH_MESH on).
KEYS = ("metric", "value", "unit", "vs_baseline", "baseline_ms", "mrays_per_s",
        "frames_timed", "spp_per_launch", "unbatched_ms_per_frame",
        "unbatched_sync_ms_per_frame", "device_compute_ms_per_frame",
        "dispatch_overhead_ms", "film_finite", "device", "mesh_roofline")
# A stand-in for the reference tracer's cornell.json: scenes/cornell_dof.json
# with a pinhole camera (APERTURE 0).  The port reads nothing outside its
# checkout, so this is the scene wherever the reference's file may be.
SCENE = ROOT / "scenes" / "cornell.json"
ROOFLINE = ROOT / "scripts" / "torch_roofline_mesh.py"
ROOFLINE_TIMEOUT_S = 600


def _window_ms(device, fn) -> float:
    """Host-clock ms of ``fn()``, the device idle at the start and drained at
    the end (``torch.cuda.synchronize``: the JAX bench's ``device_sync``)."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    return (time.perf_counter() - t0) * 1e3


def mesh_roofline(device) -> dict:
    """``scripts/torch_roofline_mesh.py``'s JSON line from a bounded
    subprocess; any failure becomes ``{"error": ...}``, never the
    headline's."""
    try:
        out = subprocess.run(
            [sys.executable, str(ROOFLINE), "--device", device.type],
            capture_output=True, text=True, timeout=ROOFLINE_TIMEOUT_S, cwd=str(ROOT),
        )
    except Exception as e:  # noqa: BLE001
        return {"error": str(e)[:200]}
    rec = None
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
    if rec is None or out.returncode != 0:
        tail = (out.stderr or out.stdout).strip().splitlines()
        return {"error": tail[-1][:200] if tail else f"exit {out.returncode}, no output"}
    return rec


def measure(device="cuda", scene=SCENE, res=None, batch: int = 64, warmup: int = 2,
            reps: int = 4, mesh: bool = True) -> dict:
    """The bench line's record on ``device`` (``res``: a square frame in
    place of the scene's own).  The warm-up batches build the kernels; no
    timed window holds a build or a host read of the alive counts."""
    device = torch.device(device)
    host_scene = load_scene(str(scene))
    if res is not None:
        host_scene = set_resolution(host_scene, res, res)
    r = Renderer(host_scene, RenderConfig(spp_per_launch=batch), device=device)

    for _ in range(warmup):
        r.step_many(batch)
    dt = _window_ms(device, lambda: [r.step_many(batch, sync=False) for _ in range(reps)])
    frames = reps * batch
    ms_per_frame = dt / frames
    rays_per_frame = float(r._alive_counts.sum() + r.static.pixel_count)  # a host read
    mrays = rays_per_frame / (ms_per_frame * 1e3)

    # K/2K control (bench.py:84-98): the 2K batch runs once outside the
    # windows, then one window at K and one at 2K.
    k1, k2 = batch, 2 * batch
    r.step_many(k2)
    t1 = _window_ms(device, lambda: r.step_many(k1, sync=False))
    t2 = _window_ms(device, lambda: r.step_many(k2, sync=False))
    device_compute_ms = max(0.0, (t2 - t1) / (k2 - k1))
    dispatch_overhead_ms = max(0.0, t1 - k1 * device_compute_ms)

    # Unbatched: 32 pipelined steps and one synchronize; 8 synced steps.
    r.step()
    n_pipe = 32
    unbatched_ms = _window_ms(device, lambda: [r.step(sync=False) for _ in range(n_pipe)]) / n_pipe
    r.stats = FrameStats()
    for _ in range(8):
        r.step()
    unbatched_sync_ms = r.stats.mean_ms

    finite = bool(np.isfinite(r.image_normalized()).all())
    roofline = mesh_roofline(device) if mesh else None
    return {
        "metric": METRIC,
        "value": round(ms_per_frame, 3),
        "unit": "ms/frame",
        "vs_baseline": round(BASELINE_MS / ms_per_frame, 3),
        "baseline_ms": BASELINE_MS,
        "mrays_per_s": round(mrays, 1),
        "frames_timed": frames,
        "spp_per_launch": batch,
        "unbatched_ms_per_frame": round(unbatched_ms, 3),
        "unbatched_sync_ms_per_frame": round(unbatched_sync_ms, 3),
        "device_compute_ms_per_frame": round(device_compute_ms, 3),
        "dispatch_overhead_ms": round(dispatch_overhead_ms, 3),
        "film_finite": finite,
        "device": card_label(device),
        **({"mesh_roofline": roofline} if roofline else {}),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print(json.dumps({
            "metric": METRIC, "value": None, "unit": "ms/frame", "vs_baseline": None,
            "error": "torch.cuda.is_available() is false: the bench needs a CUDA GPU",
        }))
        return 1
    print(json.dumps(measure(
        "cuda",
        batch=int(os.environ.get("BENCH_BATCH", "64")),
        warmup=int(os.environ.get("BENCH_WARMUP", "2")),
        reps=int(os.environ.get("BENCH_REPS", "4")),
        mesh=os.environ.get("BENCH_MESH", "1") == "1",
    )))
    return 0


if __name__ == "__main__":
    sys.exit(main())
