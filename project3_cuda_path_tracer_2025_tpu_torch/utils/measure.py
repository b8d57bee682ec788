"""What the measuring scripts (``scripts/torch_*.py``) share: the device
argument, the card's label, CUDA-event timing and JSON result lines.

A time comes from CUDA events on a CUDA device and from nowhere else: on
the CPU the scripts run the plain versions to check control flow and
results, and report ``None`` for every time.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

# The card's published peaks (H100 SXM data sheet, at 700 W): HBM bytes/s
# and float32 operations/s outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12

# Float32 operations of the mono walk's device functions (csrc/mesh_path.cuh;
# an fma counts two), which ``mono_work`` and the walk bounds of
# ``chip_smoke.py`` count: lower bounds.
OPS_MONO_RAY = 60  # features, reciprocal direction, root cull
OPS_MONO_TILE = 35  # member slab of one tile
OPS_MONO_PAIR = 41  # 19 fma, division, t, the acceptance tests


def add_device_argument(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--device", default="cuda",
        help="torch device (default: cuda; 'cpu' runs the kernels' plain "
        "versions at a small size and times nothing)",
    )


def open_device(name: str) -> torch.device:
    """The device a script runs on; a CUDA device that is not there raises
    (no fallback to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name} needs a CUDA device; pass --device cpu to "
                           "run the plain versions on the CPU")
    return device


def card_label(device) -> str:
    """``nvidia-smi``'s name and power limit of the card, to stand beside
    every number measured on it; "cpu" for the CPU."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` over ``reps`` back-to-back calls, by CUDA
    events on the current stream."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def timed_ms(device, fn, reps: int):
    """``event_ms`` after one warm-up call on a CUDA device; on the CPU one
    call of ``fn`` (so the path is exercised) and None."""
    fn()
    if torch.device(device).type != "cuda":
        return None
    torch.cuda.synchronize()
    return event_ms(fn, reps)


def bound_ms(nbytes: float, ops: float) -> tuple:
    """The least time the card could take: (ms, "bytes" | "operations")."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def mono_work(args) -> tuple:
    """The work one mono launch (``mono_intersect(*args)``) must do: the
    rays and the tables read once, (t, tri) written; the features and root
    cull of every ray, the member slab of every tile for each root-hitting
    ray, and 1,024 triangles for each (ray, tile) pair whose slab entry is
    no farther than the ray's hit (the kernel's own result).  Returns
    (bytes, operations, pairs, root-hitting rays mask)."""
    from ..ops import intersect_mxu as mxu

    tabs, _, ro, rd, active, tl, _ = args
    n, ct = ro.x.shape[0], tabs.tile_aabb.shape[0]
    act = active & mxu.root_hit_mask(tabs.tile_aabb, tabs.center, *ro, *rd, tl)
    osv = type(ro)(ro.x - tabs.center[0], ro.y - tabs.center[1], ro.z - tabs.center[2])
    inv = mxu._inv_dir(rd)
    hit_t = mxu.mono_intersect(*args)[0]  # the pairs past the hit are not needed
    pairs = 0
    for row in tabs.tile_aabb.tolist():
        member, s_tlo, _ = mxu._member_slab(row, osv, inv, tl)
        pairs += int((member & act & (s_tlo <= hit_t)).sum())
    return (n * (6 * 4 + 1 + 4 + 8) + tabs.coef.numel() * 4 + tabs.tile_aabb.numel() * 4,
            n * OPS_MONO_RAY + int(act.sum()) * ct * OPS_MONO_TILE
            + pairs * mxu.TRI_TILE * OPS_MONO_PAIR, pairs, act)


def emit(record: dict) -> dict:
    """Print one JSON result line; returns the record."""
    print(json.dumps(record), flush=True)
    return record


def advance_population(r, cfg, bounces: int, iteration: int = 1):
    """The measuring scripts' ray population: the camera rays of
    ``iteration`` of the renderer ``r``, advanced ``bounces`` bounces
    through ``intersect_scene`` + ``shade`` (the unfused path, under
    ``cfg``).  Returns the ``PathState``."""
    from ..ops import camera as camera_ops
    from ..ops import shade as shade_ops
    from ..ops.intersect import intersect_scene
    from . import prng

    n = r.static.pixel_count
    ikey = prng.iteration_key(r._base_key, iteration)
    cam_u = prng.uniforms(prng.stage_key(ikey, 0, 0), n, 4, device=r.device)
    paths = camera_ops.generate_camera_rays(
        r._cam_state, r.static.width, r.static.height, r.static.trace_depth, cam_u)
    for d in range(bounces):
        isect = intersect_scene(r.dev, r.static, paths, cfg)
        su = prng.uniforms_at(prng.stage_key(ikey, d, 1), paths.pixel, 3, n)
        paths = shade_ops.shade(r.dev, r.static, paths, isect, su, cfg)
    return paths


def stage_records(script: str, device, stages: dict, k: int, only=None, **common) -> list:
    """Time each stage (name -> zero-argument function) over ``k``
    back-to-back calls after a warm-up call and emit one JSON line each;
    ``only``: comma-separated substrings of the names to take."""
    card = card_label(device)
    out = []
    for name, fn in stages.items():
        if only and not any(s in name for s in only.split(",")):
            continue
        ms = timed_ms(device, fn, k)
        if ms is not None:
            print(f"{name:36s} {ms:9.3f} ms", flush=True)
        out.append(emit(dict(script=script, stage=name, ms=ms, k=k, device=str(device),
                             card=card, **common)))
    return out
