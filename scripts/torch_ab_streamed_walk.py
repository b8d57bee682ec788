"""A/B of the block width of the walks on the block schedule: the threads a
block spreads a tile's (ray, triangle) pairs over, in the streamed walk (#7,
``ptt_streamed_kernel``), the sweep (#9, ``ptt_sweep_kernel``), the
super-tile walk (#8, ``ptt_streamed_super_kernel``), the mono walk (#4,
``ptt_mono_kernel``) or the binned visits (#10, ``ptt_binned_kernel``).

    python scripts/torch_ab_streamed_walk.py                 # #7 at 256, 512, 1024
    python scripts/torch_ab_streamed_walk.py --variants 256 512 --scenes 80k
    python scripts/torch_ab_streamed_walk.py --walk sweep    # 20k, 80k (chain of 3)
    python scripts/torch_ab_streamed_walk.py --walk super    # 500k, PTT_STREAM_SUPER=1
    python scripts/torch_ab_streamed_walk.py --walk mono     # 5k
    python scripts/torch_ab_streamed_walk.py --walk binned   # 200k, the engaged bounces

Builds ``csrc/mesh_walk.cu`` once for each width (``-DPTT_SPREAD_THREADS``;
one ``nvcc`` each, in parallel, into ``build/kernels_ab/``), then on each sorted
bounce of the walk's meshes at 800x800 (``torch_bench_kernels``'s states and
calls: the sweep one line per call of the 80k chain, the super walk over
tables padded to whole super-tiles, the binned visits on the bounces where
a binned tier engages) launches every build's kernel through
its wrapper and times it with CUDA events, the builds in turns (the order
reversed every sample).  Every build's ``(t, tri)`` must equal the
package's own build's bit for bit: a variant that differs is reported,
timed no further, and the script exits 1 at the end.  One JSON line per
(scene, bounce, call, variant).  Needs a CUDA device.
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
from torch_bench_kernels import (  # noqa: E402
    SCENE_FILES, WALK_SCENES, binned_args, chain_calls, env_set, sorted_bounces, super_args,
)

ENTRY = {"streamed": "ptt_streamed_kernel", "sweep": "ptt_sweep_kernel",
         "super": "ptt_streamed_super_kernel", "mono": "ptt_mono_kernel",
         "binned": "ptt_binned_kernel"}


def build_variants(variants, walk: str = "streamed") -> dict:
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
                  and f"{len(ENTRY[walk])}{ENTRY[walk]}" in ln)  # as the name is mangled
        used = next(ln.strip() for ln in lines[at:] if "Used" in ln and "registers" in ln)
        spill = next(ln.strip() for ln in lines[at:] if "spill" in ln)
        print(f"{w}: {ENTRY[walk]} {used}; {spill}", flush=True)
        libs[w] = kernels.KernelLibrary("mesh_walk", path, 0.0, log)
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", default=["256", "512", "1024"],
                    help="block widths (threads a block)")
    ap.add_argument("--walk", default="streamed", choices=list(ENTRY),
                    help="the kernel compared (default: the streamed walk)")
    ap.add_argument("--scenes", nargs="+", default=None, choices=list(SCENE_FILES),
                    help="default: the walk's scenes (streamed 80k 500k, sweep 20k 80k, "
                    "super 500k, mono 5k, binned 200k)")
    ap.add_argument("--k", type=int, default=10, help="launches per sample")
    ap.add_argument("--samples", type=int, default=3)
    args = ap.parse_args(argv)
    device = measure.open_device("cuda")
    card = measure.card_label(device)
    libs = build_variants(args.variants, args.walk)
    own = kernels.load
    bad = set()
    cfg = RenderConfig()

    def ab_call(name, d, i, call, live):
        """Every build's kernel on one call: checked against the package's
        build, then timed in turns."""
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
            measure.emit(dict(script="torch_ab_streamed_walk", walk=args.walk, scene=name,
                              bounce=d, call=i, variant=w, live=int(live.sum()),
                              ms=float(np.median(ts)), card=card))

    for name in args.scenes or WALK_SCENES[args.walk]:
        scene = set_resolution(load_scene(os.path.join(REPO, SCENE_FILES[name])), 800, 800)
        dev, static = build_device_scene(scene, device)
        cam = camera_state(derive_render_camera(scene.state.camera))
        tables = dev.mxu_mesh
        if args.walk == "super":
            with env_set(PTT_STREAM_SUPER="1"):
                stab = build_device_scene(scene, device)[0].mxu_mesh
            saabb = mxu.super_aabb(stab.tile_aabb)
        eps = cfg.baby_epsilon
        for d, (paths, tl, live) in enumerate(sorted_bounces(dev, static, cam, cfg, device,
                                                             static.trace_depth)):
            ro, rd = paths.origin, paths.direction
            if args.walk == "streamed":
                plan = mxu.plan_with_prefix(tables.tile_aabb,
                                            *mxu.plan_rays(tables, ro, rd, live, tl))
                calls = [(lambda: mxu.streamed_intersect(tables, ro, rd, live, tl, plan, eps),
                          live)]
            elif args.walk == "sweep":
                calls = [(lambda a=a: mxu.sweep_intersect(*a), a[3]) for _, a in chain_calls(
                    mxu, "sweep", tables, static.mxu_padded_tris, ro, rd, live, tl, eps)]
            elif args.walk == "super":
                a = super_args(mxu, stab, saabb, ro, rd, live, tl, eps)
                calls = [(lambda: mxu.streamed_super_intersect(*a, saabb), live)]
            elif args.walk == "mono":
                calls = [(lambda: mxu.mono_intersect(tables, static.num_triangles, ro, rd,
                                                     paths.alive, tl, eps), live)]
            else:
                found = binned_args(mxu, tables, paths, tl, live, cfg.mxu_binned_tiers)
                calls = [] if found is None else [
                    (lambda a=found[0]: mxu.binned_intersect(*a), live)]
            for i, (call, call_live) in enumerate(calls):
                ab_call(name, d, i, call, call_live)
    if bad:
        print(f"variants that differ from the package's build: {sorted(bad)}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
