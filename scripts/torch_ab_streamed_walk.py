"""A/B of the streamed walk's block width (#7, ``ptt_streamed_kernel``): the
threads a block spreads a plan entry's (ray, triangle) pairs over.

    python scripts/torch_ab_streamed_walk.py                 # 256, 512, 1024
    python scripts/torch_ab_streamed_walk.py --variants 256 512 --scenes 80k

Builds ``csrc/mesh_walk.cu`` once for each width (``-DPTT_SPREAD_THREADS``;
one ``nvcc`` each, in parallel, into ``build/kernels_ab/``), then on each sorted
bounce of the 80k and 500k meshes at 800x800 (``torch_bench_kernels``'s
states) launches every build's kernel through ``streamed_intersect`` and
times it with CUDA events, the builds in turns (the order reversed every
sample).  Every build's ``(t, tri)`` must equal the package's own build's
bit for bit: a variant that differs is reported, timed no further, and the
script exits 1 at the end.  One JSON line per (scene, bounce, variant).
Needs a CUDA device.
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.ops import intersect_mxu as mxu  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.ops import kernels  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.scene import (  # noqa: E402
    build_device_scene, camera_state, derive_render_camera, load_scene, set_resolution,
)
from project3_cuda_path_tracer_2025_tpu_torch.utils import measure  # noqa: E402
from torch_bench_kernels import SCENE_FILES, sorted_bounces  # noqa: E402


def build_variants(variants) -> dict:
    """width ("256", ...) -> a loaded ``KernelLibrary`` of mesh_walk.cu
    built with it."""
    out_dir = kernels.BUILD_ROOT.parent / "kernels_ab" / kernels._source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for w in variants:
        path = out_dir / f"libptt_mesh_walk_{w}.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, f"-DPTT_SPREAD_THREADS={int(w)}",
               "-I", str(kernels.CSRC), "-o", str(path), str(kernels.CSRC / "mesh_walk.cu")]
        jobs[w] = (path, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True))
    libs = {}
    for w, (path, cmd, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {w}:\n{log}")
        lines = log.splitlines()
        at = next(i for i, ln in enumerate(lines) if "Compiling entry" in ln
                  and "ptt_streamed_kernel" in ln)
        used = next(ln.strip() for ln in lines[at:] if "Used" in ln and "registers" in ln)
        spill = next(ln.strip() for ln in lines[at:] if "spill" in ln)
        print(f"{w}: ptt_streamed_kernel {used}; {spill}", flush=True)
        libs[w] = kernels.KernelLibrary("mesh_walk", path, 0.0, log)
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", default=["256", "512", "1024"],
                    help="block widths (threads a block)")
    ap.add_argument("--scenes", nargs="+", default=list(SCENE_FILES), choices=list(SCENE_FILES))
    ap.add_argument("--k", type=int, default=10, help="launches per sample")
    ap.add_argument("--samples", type=int, default=3)
    args = ap.parse_args(argv)
    device = measure.open_device("cuda")
    card = measure.card_label(device)
    libs = build_variants(args.variants)
    own = kernels.load
    bad = set()
    cfg = RenderConfig()
    for name in args.scenes:
        scene = set_resolution(load_scene(os.path.join(REPO, SCENE_FILES[name])), 800, 800)
        dev, static = build_device_scene(scene, device)
        cam = camera_state(derive_render_camera(scene.state.camera))
        tables = dev.mxu_mesh
        for d, (paths, tl, live) in enumerate(sorted_bounces(dev, static, cam, cfg, device,
                                                             static.trace_depth)):
            ro, rd = paths.origin, paths.direction
            plan = mxu.plan_with_prefix(tables.tile_aabb,
                                        *mxu.plan_rays(tables, ro, rd, live, tl))
            call = lambda: mxu.streamed_intersect(tables, ro, rd, live, tl, plan,
                                                  cfg.baby_epsilon)
            want = call()
            try:
                for w, lib in list(libs.items()):
                    kernels.load = lambda n="fused_prim", lib=lib: lib if n == "mesh_walk" \
                        else own(n)
                    try:
                        got = call()
                        same = torch.equal(got[1], want[1]) and torch.equal(
                            got[0].view(torch.int32), want[0].view(torch.int32))
                    except RuntimeError as exc:  # a launch the runtime refused
                        print(f"{w}: {exc}", flush=True)
                        same = False
                    if not same:
                        print(f"{w} differs from the package's build on {name} bounce {d}",
                              flush=True)
                        del libs[w]
                        bad.add(w)
                times = {w: [] for w in libs}
                order = list(libs)
                for s in range(args.samples):
                    for w in (order if s % 2 == 0 else order[::-1]):
                        kernels.load = lambda n="fused_prim", lib=libs[w]: lib \
                            if n == "mesh_walk" else own(n)
                        times[w].append(measure.event_ms(call, args.k))
            finally:
                kernels.load = own
            for w, ts in times.items():
                measure.emit(dict(script="torch_ab_streamed_walk", scene=name, bounce=d,
                                  variant=w, live=int(live.sum()), ms=float(np.median(ts)),
                                  card=card))
    if bad:
        print(f"variants that differ from the package's build: {sorted(bad)}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
