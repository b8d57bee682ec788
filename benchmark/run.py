"""Run one cell of the benchmark once, on the NVIDIA GPU of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The run loads the cell's configuration into
the program (the PyTorch and CUDA port), warms up the shapes of the cell's
traffic, measures for ``--seconds`` on the host clock, checks what the
window produced against the plain reference, and prints one JSON line last
on standard output: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
metrics), ``device``, with ``--trace 1`` ``breakdown``, and last ``check``:
each number compared with its limit, which the last lines on standard
error repeat.

Without a CUDA device, or with fewer than the cell asks for, it exits with
code 2 and prints no result; a run that finds JAX or the JAX package loaded
once the window has closed exits with code 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import numpy as np  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "project3_cuda_path_tracer_2025_tpu")
SEED_STREAMS = 4  # the program's seed, the pixel sample, the input, the checked frames


def one_core() -> int:
    """Load from one process on one core with one intra-op thread: a host
    loop that the scheduler moves between cores, or that shares them with
    the pool's spinning threads, reads its host-clock metrics far wider.

    The core is the highest of the CPU affinity set the run is started
    with, which whoever starts it owns: runs started side by side on one
    host each need a set of their own (``taskset -c``, a cpuset), or they
    share that core and time each other's load."""
    import os

    core = max(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {core})
    return core


def _card_label(device: str) -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    import subprocess

    if device != "cuda":
        return device
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def _peaks(device: str) -> str:
    """The peaks a roofline share is read against, and the card it ran on."""
    import work

    return (f"against {work.PEAK_F32_S:.3g} float32 operations/s and {work.PEAK_BYTES_S:.3g} "
            f"bytes/s (H100 SXM at 700 W); this card: {_card_label(device)}")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that a run may not load: compared
    whole, since the port's name begins with the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def seed_streams(seed: int):
    """(the program's 31-bit seed, [generators for the sample, the input and
    the checked frames]), all from ``--seed``."""
    children = np.random.SeedSequence(seed % 2**64).spawn(SEED_STREAMS)
    program_seed = int(children[0].generate_state(1)[0]) & 0x7FFFFFFF
    return program_seed, [np.random.default_rng(c) for c in children[1:]]


def run_cell(spec, cell: dict, seed: int, seconds: float, traced: bool, device: str = "cuda",
             res: tuple = None, t_start: float = None, phases: dict = None) -> tuple:
    """One run of ``cell``: returns (result line, [(name, value, limit)]).
    ``res`` = (width, height) replaces the configuration's resolution (the
    tests' small runs on the CPU); ``phases``: set-up phases timed before
    the call, in seconds from ``t_start``."""
    import torch

    import check
    import loops
    import tracing
    import work
    from reference import scene as ref_scene
    from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer
    from project3_cuda_path_tracer_2025_tpu_torch.scene import set_resolution
    from project3_cuda_path_tracer_2025_tpu_torch.scene.loader import scene_from_dict

    t_start = time.perf_counter() if t_start is None else t_start
    config = spec.config(cell["config"])
    traffic = loops.params(spec.traffic(cell["traffic"]))
    limits = spec.limits(cell["name"])
    program_seed, (pixel_rng, input_rng, frame_rng) = seed_streams(seed)

    phases = dict(phases or {}, imports=time.perf_counter() - t_start)
    host_scene = scene_from_dict(config["scene"], config["dir"])
    if res is not None:
        host_scene = set_resolution(host_scene, *res)
    phases["scene"] = time.perf_counter() - t_start
    r = Renderer(host_scene, RenderConfig(**config.get("render", {})), seed=program_seed,
                 device=device)
    phases["renderer"] = time.perf_counter() - t_start
    n = r.static.pixel_count
    pixels = check.sample(pixel_rng, n, traffic["check_pixels"])
    loops.warmup(r, traffic)
    setup_s = time.perf_counter() - t_start
    phases["warmup"] = setup_s
    print("setup, seconds from the start at the end of each phase: "
          + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()), file=sys.stderr)

    win = loops.window(r, traffic, seconds, traced, input_rng, pixels)
    clock = dict(win["clock"], setup_s=setup_s)
    rec = win["trace"]
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name() if device == "cuda" else device,
           "count": 1,
           "memory_peak_bytes": torch.cuda.max_memory_allocated() if device == "cuda" else 0}
    if rec is not None:
        dev["busy_s"] = tracing.device_busy_ns(rec) / 1e9
        dev["window_s"] = (rec["window"][1] - rec["window"][0]) / 1e9
    out = win["out"]
    del r, win
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    scene = check.load_scene(config, res)
    tracer = check.Tracer(scene, program_seed, device)
    numbers = check.judge(scene, tracer, out, traffic, frame_rng, set(limits))
    if rec is not None and not scene.meshes:
        boxes = sum(p.kind == ref_scene.CUBE for p in scene.prims)
        lobes = None
        if scene.lobes - {"diffuse"}:
            t_lobes = time.perf_counter()
            lobes = check.lobe_counts(scene, tracer, out)
            print(f"lobes: the last iteration's scatters a bounce by lobe {json.dumps(lobes)}; "
                  f"counted in {time.perf_counter() - t_lobes:.3f} s", file=sys.stderr)
        rec["work"] = work.iteration_work(n, boxes, len(scene.prims) - boxes, out["alive"],
                                          lobes)
    correct, rows = check.decide(numbers, limits)
    print(f"check: the reference took {time.perf_counter() - t_check:.3f} s; every number "
          f"{json.dumps(numbers)}", file=sys.stderr)
    if rec is not None and "work" in rec:
        ms, by = work.bound_ms(*rec["work"])
        print(f"roofline: one iteration's bound {ms!r} ms, set by {by}, {_peaks(device)}",
              file=sys.stderr)
    if rec is not None and scene.meshes:
        t_walk = time.perf_counter()
        walk = check.walk_counts(scene, tracer, out)
        nbytes, ops = rec["walk_work"] = work.walk_work(walk)
        ms, by = work.bound_ms(nbytes, ops)
        print(f"walk roofline: the last iteration's mesh walks' bound {ms!r} ms, set by {by} "
              f"({nbytes} bytes, {ops} operations), {_peaks(device)}; a bounce's [rays alive "
              f"before, (ray, triangle) pairs, triangles entered]: {json.dumps(walk)}; counted "
              f"in {time.perf_counter() - t_walk:.3f} s",
              file=sys.stderr)

    specs = spec.per_layer(cell) if traced else spec.end_to_end(cell)
    source = rec if traced else clock
    metrics = {}
    for m in specs:
        value = spec.reader(m["name"])(source)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = clock["displays"] or clock["frames"]
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": 0,
              "metrics": metrics, "device": dev}
    if traced:
        result["breakdown"] = tracing.breakdown(rec)
    result["check"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return result, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from spec import Spec, SpecError

    try:
        spec = Spec.load()
        cell = spec.cell(args.workload)
    except SpecError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    core = one_core()
    print(f"pinned to core {core} of the affinity set", file=sys.stderr)
    import torch

    phases = {"torch": time.perf_counter() - T_START}
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA device(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    phases["cuda"] = time.perf_counter() - T_START
    result, rows = run_cell(spec, cell, args.seed, args.seconds, bool(args.trace),
                            t_start=T_START, phases=phases)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
