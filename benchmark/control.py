"""The output check's control: the plain reference put in the program's
place, computed in a lower precision than the configuration states
(bfloat16 for its float32), judged by the same comparison as a run.  Every
number a cell compares has to come out above its limit here on some seed,
or the check could not tell that precision from the program's.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 --steps <n>

``--steps``: the steps (``step_many`` calls; in a displayed mix, the frames
displayed) a run of the cell completes, so the control compares as much as
a run does.
One JSON line a seed.  No window is timed, and the program is not run.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def control_numbers(spec, cell: dict, seed: int, steps: int, device: str, dtype,
                    res: tuple = None) -> dict:
    """The numbers a run of ``cell`` under ``seed`` that completes
    ``steps`` steps would compare, with the reference in ``dtype`` in the
    program's place."""
    import numpy as np
    import torch

    import check
    import loops
    from run import seed_streams

    from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig

    config = spec.config(cell["config"])
    traffic = loops.params(spec.traffic(cell["traffic"]))
    limits = spec.limits(cell["name"])
    program_seed, (pixel_rng, input_rng, frame_rng) = seed_streams(seed)
    scene = check.load_scene(config, res)
    pixels = check.sample(pixel_rng, scene.pixel_count, traffic["check_pixels"])
    low = check.Tracer(scene, program_seed, device, dtype)
    ref = check.Tracer(scene, program_seed, device)
    plan = loops.InputPlan(traffic, input_rng)
    spp = loops.spp_per_step(traffic, RenderConfig(**config.get("render", {})).spp_per_launch)
    shown = range(steps) if traffic["display"] == "each" else [steps - 1]
    out = {"pixels": pixels, "steps": steps, "spp": spp, "display": traffic["display"],
           "moves": [plan.move(i) for i in range(steps)], "outputs": dict.fromkeys(shown)}
    _, (_, _, pick_rng) = seed_streams(seed)
    chosen = check.checked_steps(out, pick_rng, traffic)
    blank = np.zeros((len(pixels), 3), np.float32)
    out["outputs"] = {s: blank for s in shown}
    out["outputs"].update(zip(chosen, check.reference_images(scene, low, out, chosen)))
    if "alive_gap" in limits:
        cameras, counts = check.replay(scene, out["moves"], [steps - 1], spp)
        n = scene.pixel_count
        out["alive"] = low.radiance(cameras, torch.arange(n), torch.full((n,), counts[0]))[1]
        out["alive"] = out["alive"].numpy()
    return check.judge(scene, ref, out, traffic, frame_rng, set(limits))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--steps", type=int, required=True)
    ap.add_argument("--dtype", default="bfloat16", help="the control's precision")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from spec import Spec

    spec = Spec.load()
    cell = spec.cell(args.workload)
    limits = spec.limits(cell["name"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        numbers = control_numbers(spec, cell, seed, args.steps, args.device,
                                  getattr(torch, args.dtype))
        fails = sorted(k for k, v in numbers.items() if k in limits
                       and not v <= float(limits[k]["limit"]))
        print(json.dumps({"workload": args.workload, "seed": seed, "steps": args.steps,
                          "dtype": args.dtype, "numbers": numbers, "over_limit": fails,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
