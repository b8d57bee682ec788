"""Benchmark a set of scenes on the PyTorch/CUDA port (the port's
counterpart of ``scripts/bench_scenes.py``); one JSON line per config, then
a summary.

Each config runs in its OWN subprocess (this file with ``--worker``), so a
device fault ends that config only and the environment switches a config
names (``PTT_PLAN_IMPL``, ``PTT_STREAM_SUPER``) are its own.  The scenes are
the in-repo ones the port is timed on (``PERF.md``, section 4).

    python scripts/torch_bench_scenes.py                 # the scene list + A/B configs
    python scripts/torch_bench_scenes.py --quick         # the scene list only
    python scripts/torch_bench_scenes.py --traversals    # every mxu_traversal x PTT_PLAN_IMPL
                                                         # on every mesh scene
    python scripts/torch_bench_scenes.py --device cpu --res 8 --spp 1 --batch 1 \
        --scenes scenes/cornell_dof.json                 # plain versions, no times
    python scripts/torch_bench_scenes.py --quick --root build/parent   # the package of
                                                         # another checkout (an A/B of two
                                                         # trees on one card, back to back)

Times are CUDA events around ``--spp`` frames after a warm-up batch; on the
CPU nothing is timed (``ms_per_frame`` is null).
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SCENES = (
    "scenes/cornell_dof.json",
    "scenes/cornell_mesh_5k.json",
    "scenes/cornell_mesh_20k.json",
    "scenes/cornell_mesh_textured_local.json",
    "scenes/cornell_mesh_textured_bump_local.json",
    "scenes/cornell_prim_textured_local.json",  # precomputed-surface fused bounce
    "scenes/cornell_mesh_80k.json",  # streamed walk
    "scenes/cornell_mesh_200k.json",  # binned band
    "scenes/cornell_mesh_500k.json",
)
MESH_SCENES = tuple(f"scenes/cornell_mesh_{k}.json" for k in ("5k", "20k", "80k", "200k", "500k"))
AB_CONFIGS = (
    ("scenes/cornell_mesh_5k.json", {"ray_sorting": "off"}),
    ("scenes/cornell_mesh_200k.json", {"mxu_traversal": "streamed"}),
    ("scenes/cornell_dof.json", {"fused_bounce": "off"}),
    ("scenes/cornell_dof.json", {"integrator": "wavefront"}),
    ("scenes/cornell_dof.json", {"integrator": "wavefront", "stream_compaction": True}),
    ("scenes/cornell_dof.json", {"integrator": "wavefront", "material_sorting": True}),
)
TRAVERSALS = ("auto", "sweep", "planned", "streamed", "binned", "mono")


def worker(spec: dict) -> dict:
    """One config, in this process: warm-up batch, then ``spp`` frames timed
    by CUDA events (one synchronisation at the end)."""
    import importlib.util

    import numpy as np

    root = os.path.abspath(spec.get("root") or REPO)
    sys.path.insert(0, root)  # the package of that checkout, ahead of this one's
    from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer
    from project3_cuda_path_tracer_2025_tpu_torch.scene import load_scene, set_resolution
    from project3_cuda_path_tracer_2025_tpu_torch.utils.timers import PerformanceTimer

    # The helpers of this checkout (another one may predate them); the file
    # imports nothing of the package when it is loaded.
    mspec = importlib.util.spec_from_file_location("ptt_measure", os.path.join(
        REPO, "project3_cuda_path_tracer_2025_tpu_torch", "utils", "measure.py"))
    measure = importlib.util.module_from_spec(mspec)
    mspec.loader.exec_module(measure)

    device = measure.open_device(spec["device"])
    scene = load_scene(os.path.join(REPO, spec["scene"]))
    if spec["res"]:
        set_resolution(scene, spec["res"], spec["res"])
    batch, spp = spec["batch"], spec["spp"]
    r = Renderer(scene, RenderConfig(spp_per_launch=batch, **spec["cfg"]), device=device)
    r.step_many(batch)  # build + warm-up
    timer = PerformanceTimer(device)
    timer.start()
    done = 0
    while done < spp:
        r.step_many(batch, sync=False)
        done += batch
    ms = timer.stop() / done if device.type == "cuda" else None
    rays = float(r._alive_counts.sum() + r.static.pixel_count)
    return dict(
        script="torch_bench_scenes", scene=os.path.basename(spec["scene"]),
        tris=r.static.num_triangles, res=[r.static.width, r.static.height],
        ms_per_frame=ms, mrays_per_s=None if ms is None else rays / (ms * 1e3),
        depth_alive=[int(c) for c in r._alive_counts],
        finite=bool(np.isfinite(r.image()).all()), spp=done, batch=batch,
        device=str(device), card=measure.card_label(device), env=spec["env"],
        root=os.path.relpath(root, REPO), **spec["cfg"],
    )


def bench_scene(path, cfg_kw, spp=32, batch=16, res=None, device="cuda", env=None,
                timeout=1200, root=None) -> dict:
    """Run one config in a subprocess; returns its record or raises with the
    last line of what the subprocess said.  ``root``: the checkout whose
    package renders (default: this file's)."""
    spec = dict(scene=path, cfg=cfg_kw, spp=spp, batch=batch, res=res, device=device,
                env=env or {}, root=root)
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--worker", json.dumps(spec)],
        capture_output=True, text=True, timeout=timeout, env={**os.environ, **(env or {})},
    )
    for line in out.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    tail = (out.stderr or out.stdout).strip().splitlines()
    raise RuntimeError(tail[-1][:300] if tail else "no output")


def traversal_runs(scenes) -> list:
    """Every ``mxu_traversal`` under both ``PTT_PLAN_IMPL`` values on every
    mesh scene (the sweep builds no plan and "mono" exists up to 8 tiles,
    the 5k mesh, so those run once), and the super-tile walk with each plan
    for "streamed" beyond 32 tiles."""
    runs = []
    for path in scenes:
        small = path.endswith("_5k.json")
        for mode in TRAVERSALS:
            if mode == "mono" and not small:
                continue
            for impl in ("xla",) if mode in ("sweep", "mono") else ("xla", "pallas"):
                cfg = {"mxu_traversal": mode, "mesh_intersector": "mxu"}
                runs.append((path, cfg, {"PTT_PLAN_IMPL": impl}))
                if mode == "streamed" and not small and "_20k" not in path:
                    runs.append((path, cfg,
                                 {"PTT_PLAN_IMPL": impl, "PTT_STREAM_SUPER": "1"}))
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--quick", action="store_true", help="skip the A/B configs")
    ap.add_argument("--traversals", action="store_true",
                    help="time every mxu_traversal and both PTT_PLAN_IMPL values on "
                    "every mesh scene instead")
    ap.add_argument("--res", type=int, default=None, help="square resolution override")
    ap.add_argument("--scenes", nargs="+", default=None,
                    help="scene files (relative to the repository) instead of the list")
    ap.add_argument("--timeout", type=int, default=1200)
    ap.add_argument("--root", default=None,
                    help="another checkout of this repository whose package renders "
                    "(scenes and this script stay this checkout's)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; 'cpu' runs the plain versions and "
                    "times nothing)")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.worker is not None:
        print("RESULT " + json.dumps(worker(json.loads(args.worker))), flush=True)
        return 0

    if args.traversals:
        runs = traversal_runs(args.scenes or MESH_SCENES)
    else:
        runs = [(p, {}, {}) for p in (args.scenes or SCENES)]
        if not args.quick:
            runs += [(p, kw, {}) for p, kw in AB_CONFIGS if not args.scenes or p in args.scenes]

    results, failed = [], 0
    for path, kw, env in runs:
        try:
            rec = bench_scene(path, kw, spp=args.spp, batch=args.batch, res=args.res,
                              device=args.device, env=env, timeout=args.timeout,
                              root=args.root)
            results.append(rec)
            failed += not rec["finite"]
        except (RuntimeError, subprocess.TimeoutExpired) as e:
            rec = {"script": "torch_bench_scenes", "scene": os.path.basename(path),
                   "error": str(e)[:300], "env": env, **kw}
            failed += 1
        print(json.dumps(rec), flush=True)

    print("== summary ==")
    for r in results:
        ms = "no time" if r["ms_per_frame"] is None else f"{r['ms_per_frame']:.3f} ms/frame"
        cfg = {k: v for k, v in r.items() if k in ("mxu_traversal", "integrator", "ray_sorting",
                                                     "fused_bounce", "stream_compaction",
                                                     "material_sorting")}
        print(f"{r['scene']:44s} {ms:>20s}  {cfg or ''} {r['env'] or ''}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
