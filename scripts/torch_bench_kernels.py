"""Time the paths of the port's redesigned kernels on one checkout, so that
two checkouts can be compared on one card in one session (run it on each,
in turns: parent, change, change, parent).

    python scripts/torch_bench_kernels.py                       # this checkout
    python scripts/torch_bench_kernels.py --root build/parent   # the package of
                                                                # another checkout
    python scripts/torch_bench_kernels.py --walks sweep super   # two walks only
    python scripts/torch_bench_kernels.py --walks lanebest planned  # the planned walks
    python scripts/torch_bench_kernels.py --walks mono binned   # 5k mono, 200k binned
    python scripts/torch_bench_kernels.py --kernels shade iteration  # #3 and #1 alone
    python scripts/torch_bench_kernels.py --kernels iteration --refill 1 16  # #1's refill
                                                                # rule, both builds
    python scripts/torch_bench_kernels.py --kernels bounce prepass  # #2 and #11 per bounce
    python scripts/torch_bench_kernels.py --kernels prepass \\
        --builds PTT_PREPASS_SPLIT=32 PTT_PREPASS_SPLIT=1024    # #11's CTA slices
    python scripts/torch_bench_kernels.py --kernels epilogue    # #13a and #13b per flavor
    python scripts/torch_bench_kernels.py --kernels epilogue --builds PTT_SPREAD_THREADS=256
                                                                # and a build of 256 threads
    python scripts/torch_bench_kernels.py --device cpu --res 8 --scenes 80k \\
        --bounces 2                                             # plain versions, no times

One JSON line per measurement:

* ``walk``: a walk kernel on each sorted bounce at 800x800 (camera rays of
  iteration 1 and the bounces after them, each in the main path's signature
  order; a bounce's hits from the kernel traversal, its shade from the plain
  shade, as ``chip_smoke.py`` phase 11 builds them): ms per launch and a
  sha256 of its ``(t, tri)``, which two checkouts that compute the same
  function print alike.  ``walk`` names the kernel: "streamed" (#7,
  ``streamed_intersect``) on the 80k and 500k meshes; "sweep" (#9,
  ``sweep_intersect``) on the 20k mesh (one call) and on the 80k mesh,
  one line for each call of the chain of 3 (``call`` 0-2: tiles 0-31,
  32-63, 64-78, each call's t_limit the running best, the rays that miss
  the chunk's envelope masked, as ``mxu_traversal="sweep"`` calls it);
  "super" (#8, ``streamed_super_intersect``) on the 500k mesh, its tables
  built with ``PTT_STREAM_SUPER=1`` (padded to whole super-tiles) and its
  plan over their super boxes; "lanebest" (#5,
  ``planned_lanebest_intersect``) and "planned" (#6, ``planned_intersect``)
  on the 20k mesh (one call, the full plan) and on the 80k mesh, one line
  for each call of the planned chain of 3 that is that walk's (calls 0-1,
  tiles 0-31 and 32-63: #6; call 2, tiles 64-78: #5), each call's plan
  built against the running best, as ``mxu_traversal="planned"`` calls it;
  "mono" (#4, ``mono_intersect``) on the 5k mesh (the rays' alive flags as
  its ``active``: the kernel takes the root cull itself); "binned" (#10,
  ``binned_intersect``) on the 200k mesh, on each bounce where a binned
  tier engages (``binned_args``: the tier, budget and bins the traversal
  builds; other bounces print no line), its sha256 over the pair rows;
* ``frame``: the frame of each walk's path (``megakernel_iteration``):
  "auto" (the default: #4 at 5k, #5 at 20k, #7 at 80k and 500k, #10 with
  its streamed fallback at 200k; with "mono" also the 5k "auto, unsorted"
  frame, ray sorting off, and the "auto" frame of the textured mesh
  ``scenes/cornell_mesh_textured_local.json``, #4 too), "sweep" (20k, 80k), "super" (500k with ``PTT_STREAM_SUPER=1``) and
  "planned" (80k, the chain): ms per frame and the sha256 of iteration 1's
  film;
* ``scan``: one ``exclusive_scan`` of 640,000 int32 0/1 flags (a compacting
  bounce's shape, made from ``--seed``) against ``torch.cumsum(x, 0)`` of
  the same flags, and whether it is exact;
* ``wavefront``: the ``cornell_dof.json`` wavefront frame with compaction
  on: ms per frame and the sha256 of its first frame's film.

``--kernels`` picks what is timed: "walks" (the default: the lines above),
"shade", "iteration", "bounce", "prepass" and "epilogue":

* ``shade``: the mesh-shade kernel (#3, ``fused_mesh_shade``) on each
  sorted bounce of the 5k mesh (mode "plain"), the textured mesh (mode
  "textured") and the 200k mesh (mode "plain"), as the main path launches
  it (``shade_states``: the emit it asks, none on the last bounce; the
  carried prim winner, ``carried``): ms per launch and a sha256 of its outputs without
  the winner, which two checkouts print alike; then the 5k sorted and unsorted,
  textured-mesh, 200k, 20k and 80k "auto" frames;
* ``iteration``: the iteration kernel (#1, ``fused_prim_iteration``) per
  frame on ``cornell_dof.json``, ``cornell_all_lobes.json`` and the
  40-primitive scene at depth 80 (``many_prims_scene``): ms per frame and the
  sha256 of the film and of the alive counts; with them each scene's lane
  use (``lane_use``): live lane-bounces over lane-bounces issued, of the
  per-pixel schedule (counted from the plain version's paths: a warp of 32
  consecutive pixels issues until its longest path ends) and, where the
  package's kernel has the counting build (``PTT_COUNT_LANES``), of its
  own schedule on the card.  ``--refill`` also builds the kernel with each
  refill rule given (``-DPTT_REFILL_MIN``: a warp takes new pixels once that
  many of its lanes are free) and times the builds in turns; every build's
  film must be the package's.

* ``bounce``: the bounce kernel (#2, ``fused_prim_bounce``) on each bounce
  of ``cornell_dof.json``, ``cornell_all_lobes.json`` and the 40-primitive
  scene at depth 80 (``prim_bounce_states``: the camera rays of iteration 1
  and the bounces after them, traced by the plain version), as
  ``megakernel_iteration`` launches it ("main": the uniforms drawn inline
  where the package's kernel draws them, else the Threefry kernel's [3, n]
  plane and the kernel) and with the [3, n] plane given ("uniforms"): ms per
  launch, the live rays, a sha256 of its outputs, and the lane use of the
  per-ray schedule (warps of 32 consecutive rays) and, where the package
  has the counting build, of the kernel's own; then the ``cornell_dof``
  bounce-kernel frame;
* ``prepass``: the plan prepass kernel (#11, ``plan_prepass``) on each
  sorted bounce of the 80k mesh and at bounce 0 of the 200k and 500k
  meshes: ms per launch, the live rays and live blocks, the (ray, tile)
  pairs the per-block design tests (every ray of a block with a live ray)
  and the live ones (``prepass_pairs``), the bytes and operations its
  bound counts (``prepass_work``), a sha256 of (h, lb), and a line for each
  of ``--builds`` (e.g. ``PTT_PREPASS_SPLIT=32``, the tiles a CTA takes);
  then the 80k frame with ``PTT_PLAN_IMPL=pallas``.
* ``epilogue``: the epilogue variants (#13a ``lb_asc_intersect``: "lb_asc"
  and its floor "lb_mm" over the ascending plan; #13b
  ``epilogue_mono_intersect``: "full", "gate" and the floor "mm") on the
  populations of ``scripts/torch_profile_epilogue.py`` (800x800, the 5k
  and 20k meshes, mid-bounce and with ``bounce0`` the camera rays), with
  the lane-best planned walk (#5, "lanebest") that the exact flavors equal
  and, at 5k, the mono walk (#4, "mono"): ms per launch by events and
  device ms, the bound of the flavor's function and of the pairs its
  schedule evaluates (``variant_bound``), whether an exact flavor equals
  #5 on every ray, and a sha256 of its ``(t, tri)``; a line for each of
  ``--builds`` (e.g. ``PTT_SPREAD_THREADS=256``) and flavor.

``--builds`` builds the walk library (``csrc/mesh_walk.cu``) once with each
``-D`` define given and times the prepass and epilogue lines from each build
in turn; their hashes must be the package's.

Times are CUDA events: the median of ``--samples`` samples of ``--k`` calls
(frames: of ``--frames``) after a warm-up call.  On the CPU nothing is timed.
"""

import argparse
import hashlib
import importlib.util
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE_FILES = {k: f"scenes/cornell_mesh_{k}.json" for k in ("5k", "20k", "80k", "200k", "500k")}
WALKS = ("streamed", "sweep", "super", "lanebest", "planned", "mono", "binned")
# The scenes each walk is timed on.
WALK_SCENES = {"streamed": ("80k", "500k"), "sweep": ("20k", "80k"), "super": ("500k",),
               "lanebest": ("20k", "80k"), "planned": ("20k", "80k"), "mono": ("5k",),
               "binned": ("200k",)}
TEXTURED_MESH = "scenes/cornell_mesh_textured_local.json"  # a mono frame of "mono"
# The walk kernels by their names here (``ops/intersect_mxu.py::WALKS``).
PLANNED_KINDS = {"lanebest": "planned_lanebest", "planned": "planned"}
KERNELS = ("walks", "shade", "iteration", "bounce", "prepass", "epilogue")
# The epilogue flavors: name -> the measuring script's variant of it.
EPILOGUE_VARIANTS = {"lanebest": "prod_lanebest", "mono": "prod_mono", "lb_asc": "lb_asc",
                     "lb_mm": "lb_mm", "full": "mono", "gate": "mono_gate", "mm": "mono_mm"}
BOUNCE_SCENES = ("cornell_dof", "cornell_all_lobes", "depth80")
# The shade kernel's scenes: name -> scene file.
SHADE_SCENES = {"5k": SCENE_FILES["5k"], "mesh_textured": TEXTURED_MESH,
                "200k": SCENE_FILES["200k"]}
ITERATION_SCENES = ("cornell_dof", "cornell_all_lobes", "depth80")


def sorted_bounces(dev, static, cam, cfg, device, bounces: int = 3) -> list:
    """Camera rays and the next bounces, each in the main path's coherence
    order: [(paths, t_lim, live)].  A bounce's hits come from the kernel
    traversal, its shade from the plain shade.  Imports the package of the
    first checkout on ``sys.path``."""
    import dataclasses

    from project3_cuda_path_tracer_2025_tpu_torch.ops import camera as camera_ops
    from project3_cuda_path_tracer_2025_tpu_torch.ops import fused, intersect_mxu as mxu
    from project3_cuda_path_tracer_2025_tpu_torch.ops.compaction import permute_path_state
    from project3_cuda_path_tracer_2025_tpu_torch.ops.intersect import prim_t_min
    from project3_cuda_path_tracer_2025_tpu_torch.utils import prng

    tables = dev.mxu_mesh
    n = static.pixel_count
    prim_static = dataclasses.replace(static, num_triangles=0)
    ik = prng.iteration_key(prng.prng_key(0), 1)
    paths = camera_ops.generate_camera_rays(
        cam, static.width, static.height, static.trace_depth,
        prng.uniforms_at(prng.stage_key(ik, 0, 0), torch.arange(n, device=device), 4, n))
    out = []
    for d in range(bounces):
        tl = prim_t_min(static, cfg, paths.origin, paths.direction)
        perm = mxu.coherence_perm(tables, paths.origin, paths.direction, paths.alive, tl,
                                  cfg.ray_sort_bits, cfg.ray_sort_dir_bits, mode="signature")
        paths, (tl,) = permute_path_state(paths, perm, extra=(tl,))
        live = paths.alive & mxu.root_hit_mask(tables, paths.origin, paths.direction, tl)
        out.append((paths, tl, live))
        mh = fused.mesh_walk(tables, static, cfg, paths, tl)
        paths = fused.fused_mesh_shade_plain(prim_static, cfg, paths, mh.t, None, None,
                                             prng.stage_key(ik, d, 1), n, tables=tables,
                                             mesh_tri=mh.tri)
    return out


def shade_states(dev, static, cam, cfg, device, bounces: int):
    """Each sorted bounce of a mesh frame as the main path shades it, for
    the shade kernel (#3): yields (args, kwargs) of ``fused_mesh_shade``.
    The rays are in the main path's coherence order with their t_limit and
    their prim winner (``prim_t_min(..., winner=True)``, permuted with them:
    the winner the bounce before emits); the mesh inputs are the walk's
    ``(t, tri)`` (``fused.mesh_walk``; ``mesh_tri`` in the kwargs), or
    ``textured_mesh_surface``'s in mode "textured" for a textured mesh; emit
    is the main path's ("tlim+key"; none on the frame's last bounce).  The
    next bounce comes from the plain shade."""
    import dataclasses

    from project3_cuda_path_tracer_2025_tpu_torch.ops import camera as camera_ops
    from project3_cuda_path_tracer_2025_tpu_torch.ops import fused, intersect_mxu as mxu
    from project3_cuda_path_tracer_2025_tpu_torch.ops.compaction import permute_path_state
    from project3_cuda_path_tracer_2025_tpu_torch.ops.intersect import prim_t_min
    from project3_cuda_path_tracer_2025_tpu_torch.utils import prng

    tables = dev.mxu_mesh
    mode = "textured" if static.num_textures > 0 else "plain"
    n = static.pixel_count
    prim_static = dataclasses.replace(static, num_triangles=0)
    ik = prng.iteration_key(prng.prng_key(0), 1)
    paths = camera_ops.generate_camera_rays(
        cam, static.width, static.height, static.trace_depth,
        prng.uniforms_at(prng.stage_key(ik, 0, 0), torch.arange(n, device=device), 4, n))
    for d in range(bounces):
        ro, rd = paths.origin, paths.direction
        tl, win = prim_t_min(static, cfg, ro, rd, winner=True)
        perm = mxu.coherence_perm(tables, ro, rd, paths.alive, tl, cfg.ray_sort_bits,
                                  cfg.ray_sort_dir_bits, mode="signature")
        paths, (tl, win) = permute_path_state(paths, perm, extra=(tl, win))
        if mode == "plain":
            mh = fused.mesh_walk(tables, static, cfg, paths, tl)
            (mt, mn, mm, alb), tri = (mh.t, None, None, None), mh.tri
        else:
            (mt, mn, mm, alb), tri = fused.textured_mesh_surface(dev, static, cfg, paths, tl), None
        emit = "" if d == static.trace_depth - 1 else "tlim+key"
        skey = prng.stage_key(ik, d, 1)
        args = (prim_static, cfg, paths, mt, mn, mm, skey, n, emit, tables)
        yield args, dict(mode=mode, mesh_albedo=alb, prim_winner=win, mesh_tri=tri)
        paths = fused.fused_mesh_shade_plain(prim_static, cfg, paths, mt, mn, mm, skey, n,
                                             tables=tables, mode=mode, mesh_albedo=alb,
                                             mesh_tri=tri)


def shade_outputs(out, emit: str) -> tuple:
    """The outputs of a shade call with ``emit`` without the carried
    winner: the path state, then t_lim and the key where it emits them."""
    paths, extra = out if emit else (out, ())
    return (*paths.origin, *paths.direction, *paths.color, paths.bounces,
            *(x for x in extra[:2] if x is not None))


def iteration_scene(name: str, res: int):
    """A scene of the iteration kernel's A/B at ``res`` x ``res``:
    ``scenes/<name>.json``, or "depth80", the 40-primitive, 40-material
    scene at depth 80 that ``many_prims_scene`` makes from
    ``cornell_dof.json``."""
    from project3_cuda_path_tracer_2025_tpu_torch.scene import (
        load_scene, many_prims_scene, scene_from_dict, set_resolution,
    )

    base = os.path.join(REPO, "scenes", "cornell_dof.json")
    if name == "depth80":
        scene = scene_from_dict(many_prims_scene(base, 40, 40, depth=80))
    else:
        scene = load_scene(os.path.join(REPO, "scenes", f"{name}.json"))
    return set_resolution(scene, res, res)


def variant_library(defines: tuple, name: str = "fused_prim"):
    """The package's kernel library ``name`` (a key of ``kernels.LIBRARIES``)
    built with ``defines`` (``-D`` flags) into ``build/kernels_ab/``,
    loaded: a ``KernelLibrary``."""
    import subprocess

    from project3_cuda_path_tracer_2025_tpu_torch.ops import kernels

    out_dir = kernels.BUILD_ROOT.parent / "kernels_ab" / kernels._source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = "_".join(d.replace("=", "") for d in defines) or "plain"
    path = out_dir / f"libptt_{name}_{tag}.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, *(f"-D{d}" for d in defines),
           "-I", str(kernels.CSRC), "-o", str(path), str(kernels.CSRC / kernels.LIBRARIES[name])]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {defines}:\n{proc.stdout}{proc.stderr}")
    return kernels.KernelLibrary(name, path, 0.0, proc.stdout + proc.stderr)


class library_used:
    """``ops.kernels.load`` returns ``lib`` for its library's name inside a
    ``with`` block: the wrappers launch that build's kernels."""

    def __init__(self, lib):
        self.lib = lib

    def __enter__(self):
        from project3_cuda_path_tracer_2025_tpu_torch.ops import kernels

        self.kernels, self.own = kernels, kernels.load
        kernels.load = lambda name="fused_prim": self.lib if name == self.lib.name \
            else self.own(name)

    def __exit__(self, *exc):
        self.kernels.load = self.own


def lane_use(static, cfg, cam, device, counting=None) -> dict:
    """Lane use of the iteration kernel on one frame (iteration 1, seed 0):
    ``live`` lane-bounces (every bounce of a live path) over ``issued``
    ones.  The per-pixel schedule's, from the plain version's paths: each
    warp of 32 consecutive pixels issues 32 lanes a depth until its longest
    path ends.  With ``counting`` (a build with ``PTT_COUNT_LANES``), the
    regenerating schedule's as that build counts it on the card: 32 lanes
    for every step in which a warp bounces."""
    import ctypes

    from project3_cuda_path_tracer_2025_tpu_torch.ops import camera as camera_ops
    from project3_cuda_path_tracer_2025_tpu_torch.ops import film as film_ops
    from project3_cuda_path_tracer_2025_tpu_torch.ops import fused
    from project3_cuda_path_tracer_2025_tpu_torch.utils import prng

    n, depth = static.pixel_count, static.trace_depth
    idx = torch.arange(n, dtype=torch.int32, device=device)
    cam_key, ik = fused.kernel_key_words(1, prng.prng_key(0))
    paths = camera_ops.generate_camera_rays(
        cam, static.width, static.height, depth, prng.uniforms_at(cam_key, idx, 4, n), idx=idx)
    length = torch.zeros(n, dtype=torch.int64, device=device)
    for d in range(depth):
        length += paths.alive
        paths = fused.fused_prim_bounce_plain(
            static, cfg, paths, prng.uniforms_at(prng.stage_key(ik, d, 1), idx, 3, n))
    warp_max = torch.nn.functional.pad(length, (0, -n % 32)).view(-1, 32).max(1).values
    out = dict(per_pixel_live=int(length.sum()), per_pixel_issued=32 * int(warp_max.sum()))
    if counting is not None:
        counts = (ctypes.c_ulonglong * 2)()
        fn = counting.lib.ptt_lane_counts_read
        fn.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
        counting.check(fn(counts, 1), "ptt_lane_counts_read")
        with library_used(counting):
            fused.fused_prim_iteration(static, cfg, cam, film_ops.new_film(n, device), 1,
                                       prng.prng_key(0))
        counting.check(fn(counts, 1), "ptt_lane_counts_read")
        out.update(regen_issued=int(counts[0]), regen_live=int(counts[1]))
    return out


def device_ms(fn, reps: int, names: tuple):
    """Device ms per call of ``fn`` spent in the kernels whose names contain
    one of ``names``, by ``torch.profiler`` over ``reps`` calls after a
    warm-up: the kernels' own time, without the host's gaps between short
    launches that CUDA events count.  Each kernel's time is its mean over
    the launches the profiler recorded (it may drop some), summed over the
    kernels a call launches once each.  None on the CPU."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    if not torch.cuda.is_available():
        return None
    for k in (reps, 10 * reps):  # a short window can close before its records arrive
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(k):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and any(n in e.key for n in names)]
        if kernels:
            return sum(e.self_device_time_total / e.count for e in kernels) / 1e3
    return None


def prim_bounce_states(static, cam, cfg, device, bounces: int):
    """The bounce kernel's inputs on each bounce of iteration 1 as
    ``megakernel_iteration`` runs it (seed 0): yields (paths, shade key),
    the camera rays first and each next bounce from the plain version.
    Works on any checkout's package."""
    from project3_cuda_path_tracer_2025_tpu_torch.ops import camera as camera_ops
    from project3_cuda_path_tracer_2025_tpu_torch.ops import fused
    from project3_cuda_path_tracer_2025_tpu_torch.utils import prng

    n = static.pixel_count
    idx = torch.arange(n, dtype=torch.int32, device=device)
    ik = prng.iteration_key(prng.prng_key(0), 1)
    paths = camera_ops.generate_camera_rays(
        cam, static.width, static.height, static.trace_depth,
        prng.uniforms_at(prng.stage_key(ik, 0, 0), idx, 4, n), idx=idx)
    for d in range(bounces):
        skey = prng.stage_key(ik, d, 1)
        yield paths, skey
        paths = fused.fused_prim_bounce_plain(static, cfg, paths,
                                              prng.uniforms_at(skey, idx, 3, n))


def draws_inline(fused) -> bool:
    """Whether the package's bounce kernel draws its uniforms (``su_key``)."""
    import inspect

    return "su_key" in inspect.signature(fused.fused_prim_bounce).parameters


def bounce_lane_use(fused, static, cfg, paths, skey, counting=None) -> dict:
    """Lane use of one bounce launch: live lane-bounces over issued ones.
    The per-ray schedule's: a warp of 32 consecutive rays issues 32 lanes
    when any of them is live.  With ``counting`` (a build with
    ``PTT_COUNT_LANES`` whose bounce kernel counts), the kernel's own, as
    that build counts one launch in the main path's form on the card."""
    import ctypes

    live = paths.bounces > 0
    n = live.shape[0]
    warps = torch.nn.functional.pad(live, (0, -n % 32)).view(-1, 32).any(1)
    out = dict(live=int(live.sum()), per_ray_issued=32 * int(warps.sum()))
    if counting is not None:
        counts = (ctypes.c_ulonglong * 2)()
        fn = counting.lib.ptt_lane_counts_read
        fn.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
        counting.check(fn(counts, 1), "ptt_lane_counts_read")
        with library_used(counting):
            fused.fused_prim_bounce(static, cfg, paths, su_key=skey)
        counting.check(fn(counts, 1), "ptt_lane_counts_read")
        out.update(kernel_issued=int(counts[0]), kernel_live=int(counts[1]))
    return out


def prepass_pairs(mxu, live) -> dict:
    """What the plan prepass tests on these padded rays: the live rays and
    the blocks that hold one, the (ray, block) count the per-block design
    tests per tile (all 256 rays of every live block) and the live rays
    alone, each over the tiles."""
    blocks = live.view(-1, mxu.RAY_TILE).any(1)
    return dict(live=int(live.sum()), live_blocks=int(blocks.sum()),
                rays_per_block_design=mxu.RAY_TILE * int(blocks.sum()))


OPS_PLAN_PAIR = 34  # plan_pair: slab 22, widening 8, clamp, three compares


def prepass_work(mxu, ct: int, live) -> tuple:
    """The least work of one plan prepass on these padded rays and ``ct``
    tiles: (bytes, float32 operations).  Bytes: every ray's live flag, the
    live rays' state (recentred origin, direction, t_limit: 28 B), the tile
    boxes and the [nb, ct] (h, lb) written; operations: the live (ray, tile)
    pairs' tests."""
    n_live = int(live.sum())
    nb = live.shape[0] // mxu.RAY_TILE
    return (live.shape[0] + n_live * 7 * 4 + ct * 8 * 4 + nb * ct * 5,
            n_live * ct * OPS_PLAN_PAIR)


def chain_calls(mxu, mode, tables, padded_tris, ro, rd, live, tl, baby_eps) -> list:
    """The walk calls that the traversal ``mxu_traversal=mode`` makes on these
    rays (already in traversal order): [(kind, args)], kind a key of
    ``WALKS`` or "sweep".  Read from the traversal itself, run once on the
    card: its walk entry points are wrapped while it runs
    (``ops/intersect_mxu.py::_traverse`` and ``_chain`` look them up at each
    call), so each call's arguments are the chain's own (its chunk of 32
    tiles, its plan, the running best as t_limit, the sweep's envelope
    mask).  Works on any checkout's package."""
    calls = []

    def recorded(kind, fn):
        def call(*args):
            calls.append((kind, args))
            return fn(*args)
        call.launches = fn.launches
        return call

    walks, sweep = dict(mxu.WALKS), mxu.sweep_intersect
    try:
        mxu.WALKS.update({k: recorded(k, fn) for k, fn in walks.items()})
        mxu.sweep_intersect = recorded("sweep", sweep)
        mxu.mesh_intersect_mxu(tables, padded_tris, padded_tris, ro, rd, live, tl, baby_eps,
                               compute_uv=False, **mxu.traversal_flags(mode, padded_tris))
    finally:
        mxu.WALKS.update(walks)
        # sweep_intersect counts its launches on the module's name, the wrapper's while it ran
        sweep.launches, mxu.sweep_intersect = mxu.sweep_intersect.launches, sweep
    return calls


def bins_inputs(mxu, tables, paths, tl, live, tiers) -> "tuple | None":
    """The packet bins' arguments (``packet_bins(*args)``) for one state at
    the tier the binned traversal engages (``_binning``'s prefix and
    budget), or None where no tier holds the live rays.  Works on any
    checkout's package."""
    ro, rd = paths.origin, paths.direction
    pr = mxu.plan_rays(tables, ro, rd, live, tl)
    n_pad = pr.tl.shape[0]
    live_pos = mxu.live_position(pr.live)
    npre = next((p for p in mxu.binned_prefixes(n_pad, tiers) if live_pos < p), None)
    if npre is None:
        return None
    cut = lambda v: type(v)(*(x[:npre] for x in v))
    budget = mxu.pair_budget(max(npre, ro.x.shape[0] // 4), tables.tile_aabb.shape[0])
    return (tables.tile_aabb, cut(pr.os), cut(pr.d), pr.live[:npre], pr.tl[:npre], budget,
            mxu.BINNED_TOPK)


def bins_work(args, bins) -> tuple:
    """The least work of one ``packet_bins(*args)`` giving ``bins``: (bytes,
    float32 operations).  Bytes: every ray's live flag, the live rays' state
    (recentred origin, direction, t_limit: 28 B), the tile boxes, each
    packet's tile mask (a bit a tile, whole words) and the outputs (src, vt,
    dst) written; operations: the live (ray, tile) pairs' slab tests."""
    aabb, _, _, live, _, _, _ = args
    ct, n_live = aabb.shape[0], int(live.sum())
    n_g = live.shape[0] // 8
    dst = 0 if bins.dst is None else bins.dst.numel()
    nbytes = live.shape[0] + n_live * 7 * 4 + ct * 8 * 4 + n_g * -(-ct // 32) * 4 \
        + (bins.src.numel() + bins.vt.numel() + dst) * 4
    return nbytes, n_live * ct * OPS_PLAN_PAIR


def binned_args(mxu, tables, paths, tl, live, tiers) -> "tuple | None":
    """The binned kernel's arguments for one state at the tier the
    traversal engages, and the bins (None: no tier holds the live rays, or
    the bins overflow, and the traversal walks the streamed plan instead).
    Works on any checkout's package."""
    args = bins_inputs(mxu, tables, paths, tl, live, tiers)
    if args is None:
        return None
    bins = mxu.packet_bins(*args)
    if bool(bins.overflow):
        return None
    npre = args[4].shape[0]
    return (tables, paths.origin, paths.direction, live, tl, bins.vt, bins.src,
            npre // mxu.BINNED_G, 1e-5), bins


def super_args(mxu, stab, saabb, ro, rd, live, tl, baby_eps) -> tuple:
    """The super-tile walk's arguments for one state: the tables padded to
    whole super-tiles (``stab``), the plan over their super boxes."""
    splan = mxu.plan_with_prefix(saabb, *mxu.plan_rays(stab, ro, rd, live, tl))
    return stab, ro, rd, live, tl, splan, baby_eps


class env_set:
    """Environment variables set for the length of a ``with`` block (the
    package reads its switches at call time)."""

    def __init__(self, **env):
        self.env = env

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def sha(*tensors) -> str:
    """The first 16 hex digits of the sha256 of the tensors' bytes, in
    order: equal results or films print alike, in any tree or run."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def run(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; 'cpu' runs the plain versions and "
                    "times nothing)")
    ap.add_argument("--root", default=None,
                    help="the checkout whose package is timed (default: this one)")
    ap.add_argument("--res", type=int, default=800, help="film width and height")
    ap.add_argument("--scenes", nargs="+", default=list(SCENE_FILES), choices=list(SCENE_FILES))
    ap.add_argument("--walks", nargs="+", default=list(WALKS), choices=WALKS,
                    help="the walks timed, each on its scenes (default: all seven)")
    ap.add_argument("--kernels", nargs="+", default=["walks"], choices=KERNELS,
                    help="what is timed: the walks with the scan and the wavefront frame "
                    "(default), the mesh shade (#3), the iteration kernel (#1)")
    ap.add_argument("--refill", nargs="+", type=int, default=[],
                    help="with iteration: also build and time the kernel with each of these "
                    "refill rules (PTT_REFILL_MIN)")
    ap.add_argument("--builds", nargs="+", default=[],
                    help="with prepass or epilogue: also build the walk library with each of "
                    "these -D defines (e.g. PTT_PREPASS_SPLIT=32, PTT_SPREAD_THREADS=256) and "
                    "time those kernels from it")
    ap.add_argument("--bounces", type=int, default=None,
                    help="sorted bounces a mesh (default: the scene's depth)")
    ap.add_argument("--k", type=int, default=10, help="launches per sample")
    ap.add_argument("--frames", type=int, default=3, help="frames per sample")
    ap.add_argument("--samples", type=int, default=3)
    ap.add_argument("--scan-n", type=int, default=640_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    root = os.path.abspath(args.root or REPO)
    sys.path.insert(0, root)  # the package of that checkout, ahead of this one's
    from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer, megakernel_iteration
    from project3_cuda_path_tracer_2025_tpu_torch.ops import film as film_ops
    from project3_cuda_path_tracer_2025_tpu_torch.ops import intersect_mxu as mxu
    from project3_cuda_path_tracer_2025_tpu_torch.ops import scan
    from project3_cuda_path_tracer_2025_tpu_torch.scene import (
        build_device_scene, camera_state, derive_render_camera, load_scene, set_resolution,
    )
    from project3_cuda_path_tracer_2025_tpu_torch.utils import prng

    # The helpers of this checkout (another one may predate them); the file
    # imports nothing of the package when it is loaded.
    mspec = importlib.util.spec_from_file_location("ptt_measure", os.path.join(
        REPO, "project3_cuda_path_tracer_2025_tpu_torch", "utils", "measure.py"))
    measure = importlib.util.module_from_spec(mspec)
    mspec.loader.exec_module(measure)

    device = measure.open_device(args.device)
    common = dict(script="torch_bench_kernels", card=measure.card_label(device),
                  device=device.type, root=os.path.relpath(root, REPO))

    def timed(fn, reps):
        fn()
        if device.type != "cuda":
            return None
        torch.cuda.synchronize()
        return float(np.median([measure.event_ms(fn, reps) for _ in range(args.samples)]))

    def scene_at(path):
        scene = load_scene(os.path.join(REPO, path))
        return set_resolution(scene, args.res, args.res)

    recs = []
    cfg = RenderConfig()

    def frame_of(dev, static, cam, c):
        n, it = static.pixel_count, [0]

        def frame():
            it[0] += 1
            return megakernel_iteration(dev, static, c, cam, film_ops.new_film(n, device),
                                        it[0], prng.prng_key(0))
        return frame

    def time_frame(name, traversal, frame, **env):
        with env_set(**env):
            film, _ = frame()
            recs.append(measure.emit(dict(
                kind="frame", scene=name, traversal=traversal, ms=timed(frame, args.frames),
                film_sha=sha(*film), **common)))

    def time_walk(name, walk, d, live, fn, **extra):
        t, tri = fn()
        recs.append(measure.emit(dict(
            kind="walk", walk=walk, scene=name, bounce=d, **extra, live=int(live.sum()),
            hits=int((tri >= 0).sum()), ms=timed(fn, args.k), result_sha=sha(t, tri),
            **common)))

    if "shade" in args.kernels:
        run_shade(args, measure, recs, common, timed, scene_at, frame_of, time_frame)
    if "iteration" in args.kernels:
        run_iteration(args, measure, recs, common, timed, device)
    if "bounce" in args.kernels:
        run_bounce(args, measure, recs, common, timed, device, time_frame)
    # The walk library built with each define of --builds, once.
    builds = {d: variant_library((d,), "mesh_walk")
              for d in (args.builds if device.type == "cuda" else [])}
    if "prepass" in args.kernels:
        run_prepass(args, measure, recs, common, timed, device, scene_at, frame_of,
                    time_frame, builds)
    if "epilogue" in args.kernels:
        run_epilogue(args, measure, recs, common, timed, device, builds)
    if "walks" not in args.kernels:
        return recs

    for name in args.scenes:
        walks = [w for w in args.walks if name in WALK_SCENES[w]]
        if not walks:
            continue
        planned = [w for w in walks if w in PLANNED_KINDS]
        scene = scene_at(SCENE_FILES[name])
        dev, static = build_device_scene(scene, device)
        cam = camera_state(derive_render_camera(scene.state.camera))
        tables = dev.mxu_mesh
        eps = cfg.baby_epsilon
        states = sorted_bounces(dev, static, cam, cfg, device,
                                args.bounces or static.trace_depth)
        if "super" in walks:
            with env_set(PTT_STREAM_SUPER="1"):
                sdev, sstatic = build_device_scene(scene, device)
            saabb = mxu.super_aabb(sdev.mxu_mesh.tile_aabb)
        for d, (paths, tl, live) in enumerate(states):
            ro, rd = paths.origin, paths.direction
            if "streamed" in walks:
                plan = mxu.plan_with_prefix(tables.tile_aabb,
                                            *mxu.plan_rays(tables, ro, rd, live, tl))
                time_walk(name, "streamed", d, live,
                          lambda: mxu.streamed_intersect(tables, ro, rd, live, tl, plan, eps))
            if "sweep" in walks:
                calls = chain_calls(mxu, "sweep", tables, static.mxu_padded_tris, ro, rd, live,
                                    tl, eps)
                for i, (_, a) in enumerate(calls):
                    time_walk(name, "sweep", d, a[3], lambda a=a: mxu.sweep_intersect(*a),
                              call=i, tiles=a[0].tile_aabb.shape[0])
            if "super" in walks:
                a = super_args(mxu, sdev.mxu_mesh, saabb, ro, rd, live, tl, eps)
                time_walk(name, "super", d, live,
                          lambda: mxu.streamed_super_intersect(*a, saabb))
            if planned and name == "20k":
                plan = mxu.plan_with_prefix(tables.tile_aabb,
                                            *mxu.plan_rays(tables, ro, rd, live, tl))
                for w in planned:
                    fn = mxu.WALKS[PLANNED_KINDS[w]]
                    time_walk(name, w, d, live,
                              lambda fn=fn: fn(tables, ro, rd, live, tl, plan, eps))
            elif planned:
                calls = chain_calls(mxu, "planned", tables, static.mxu_padded_tris, ro, rd,
                                    live, tl, eps)
                for i, (kind, a) in enumerate(calls):
                    w = next(k for k, v in PLANNED_KINDS.items() if v == kind)
                    if w in planned:
                        time_walk(name, w, d, live, lambda a=a, kind=kind: mxu.WALKS[kind](*a),
                                  call=i, tiles=a[0].tile_aabb.shape[0])
            if "mono" in walks:
                time_walk(name, "mono", d, live, lambda: mxu.mono_intersect(
                    tables, static.num_triangles, ro, rd, paths.alive, tl, eps))
            if "binned" in walks:
                found = binned_args(mxu, tables, paths, tl, live, cfg.mxu_binned_tiers)
                if found is not None:
                    a = found[0]
                    time_walk(name, "binned", d, live, lambda a=a: mxu.binned_intersect(*a),
                              visits=int(a[5].numel()), prefix=a[7] * mxu.BINNED_G)
        del states
        if {"streamed", "mono", "binned"} & set(walks) or (name == "20k" and planned):
            time_frame(name, "auto", frame_of(dev, static, cam, cfg))
        if "mono" in walks:
            time_frame(name, "auto, unsorted",
                       frame_of(dev, static, cam, RenderConfig(ray_sorting="off")))
            tex = scene_at(TEXTURED_MESH)
            tdev, tstatic = build_device_scene(tex, device)
            time_frame("mesh_textured", "auto", frame_of(
                tdev, tstatic, camera_state(derive_render_camera(tex.state.camera)), cfg))
            del tdev
        if "sweep" in walks:
            time_frame(name, "sweep",
                       frame_of(dev, static, cam, RenderConfig(mxu_traversal="sweep")))
        if "super" in walks:
            time_frame(name, "super", frame_of(sdev, sstatic, cam, cfg), PTT_STREAM_SUPER="1")
            del sdev
        if planned and name == "80k":
            time_frame(name, "planned",
                       frame_of(dev, static, cam, RenderConfig(mxu_traversal="planned")))

    x = torch.from_numpy(
        (np.random.default_rng(args.seed).random(args.scan_n) > 0.5).astype(np.int32)).to(device)
    exact = bool(torch.equal(scan.exclusive_scan(x), torch.cumsum(x, 0, dtype=torch.int32) - x))
    recs.append(measure.emit(dict(
        kind="scan", n=args.scan_n, exact=exact,
        ms=timed(lambda: scan.exclusive_scan(x), 50),
        library_ms=timed(lambda: torch.cumsum(x, 0, dtype=torch.int32), 50), **common)))

    dof = scene_at("scenes/cornell_dof.json")
    wf = Renderer(dof, RenderConfig(integrator="wavefront", stream_compaction=True),
                  device=device)
    wf.step_many(1)
    film_sha = sha(*wf.film)
    recs.append(measure.emit(dict(
        kind="wavefront", scene="cornell_dof",
        ms=timed(lambda: wf.step_many(1, sync=False), args.frames),
        film_sha=film_sha, **common)))
    return recs


def run_shade(args, measure, recs, common, timed, scene_at, frame_of,
              time_frame) -> None:
    """The ``shade`` lines: #3 on each sorted bounce of its scenes, then
    their frames."""
    from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu_torch.ops import fused
    from project3_cuda_path_tracer_2025_tpu_torch.scene import (
        build_device_scene, camera_state, derive_render_camera,
    )

    cfg = RenderConfig()
    device = torch.device(args.device)
    for name, path in SHADE_SCENES.items():
        scene = scene_at(path)
        dev, static = build_device_scene(scene, device)
        cam = camera_state(derive_render_camera(scene.state.camera))
        bounces = args.bounces or static.trace_depth
        for d, (a, kw) in enumerate(shade_states(dev, static, cam, cfg, device, bounces)):
            fn = lambda a=a, kw=kw: fused.fused_mesh_shade(*a, **kw)
            recs.append(measure.emit(dict(
                kind="shade", scene=name, bounce=d, mode=kw["mode"], emit=a[8],
                carried="prim_winner" in kw, live=int(a[2].alive.sum()),
                ms=timed(fn, args.k), result_sha=sha(*shade_outputs(fn(), a[8])), **common)))
        time_frame(name, "auto", frame_of(dev, static, cam, cfg))
        if name == "5k":
            time_frame(name, "auto, unsorted",
                       frame_of(dev, static, cam, RenderConfig(ray_sorting="off")))
        del dev
    for name in ("20k", "80k"):  # the other "auto" mesh frames, each shading 8 times
        scene = scene_at(SCENE_FILES[name])
        dev, static = build_device_scene(scene, device)
        time_frame(name, "auto", frame_of(dev, static,
                                          camera_state(derive_render_camera(scene.state.camera)),
                                          cfg))
        del dev


def run_iteration(args, measure, recs, common, timed, device) -> None:
    """The ``iteration`` lines: #1 per frame on its scenes with the lane
    use, and with ``--refill`` each refill rule's build in turns."""
    from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu_torch.ops import film as film_ops
    from project3_cuda_path_tracer_2025_tpu_torch.ops import fused, kernels
    from project3_cuda_path_tracer_2025_tpu_torch.scene import (
        build_device_scene, camera_state, derive_render_camera,
    )
    from project3_cuda_path_tracer_2025_tpu_torch.utils import prng

    cfg = RenderConfig()
    on_card = device.type == "cuda"
    countable = on_card and "PTT_COUNT_LANES" in (kernels.CSRC / "fused_prim.cu").read_text()
    counting = variant_library(("PTT_COUNT_LANES",)) if countable else None
    builds = {f"refill {k}": variant_library((f"PTT_REFILL_MIN={k}",))
              for k in (args.refill if on_card else [])}
    for name in ITERATION_SCENES:
        scene = iteration_scene(name, args.res)
        _, static = build_device_scene(scene, device)
        cam = camera_state(derive_render_camera(scene.state.camera))
        n, it = static.pixel_count, [0]
        film = film_ops.new_film(n, device)

        def frame():
            it[0] += 1
            return fused.fused_prim_iteration(static, cfg, cam, film, it[0], prng.prng_key(0))

        film1, alive1 = fused.fused_prim_iteration(static, cfg, cam, film_ops.new_film(n, device),
                                                   1, prng.prng_key(0))
        recs.append(measure.emit(dict(
            kind="iteration", scene=name, depth=static.trace_depth, build="package",
            ms=timed(frame, args.frames), film_sha=sha(*film1), alive_sha=sha(alive1),
            **lane_use(static, cfg, cam, device, counting), **common)))
        if not builds:
            continue
        times = {b: [] for b in builds}
        shas = {}
        for b, lib in builds.items():
            with library_used(lib):
                f, al = fused.fused_prim_iteration(static, cfg, cam,
                                                   film_ops.new_film(n, device), 1,
                                                   prng.prng_key(0))
                shas[b] = (sha(*f), sha(al))
                frame()
        torch.cuda.synchronize()
        for rnd in range(args.samples):
            for b in (list(builds) if rnd % 2 == 0 else list(builds)[::-1]):
                with library_used(builds[b]):
                    times[b].append(measure.event_ms(frame, args.frames))
        for b in builds:
            recs.append(measure.emit(dict(
                kind="iteration", scene=name, depth=static.trace_depth, build=b,
                ms=float(np.median(times[b])), film_sha=shas[b][0], alive_sha=shas[b][1],
                **common)))


def run_bounce(args, measure, recs, common, timed, device, time_frame) -> None:
    """The ``bounce`` lines: #2 on each bounce of its scenes and the
    ``cornell_dof`` bounce-kernel frame."""
    from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu_torch.models import megakernel_iteration
    from project3_cuda_path_tracer_2025_tpu_torch.ops import film as film_ops
    from project3_cuda_path_tracer_2025_tpu_torch.ops import fused
    from project3_cuda_path_tracer_2025_tpu_torch.scene import (
        build_device_scene, camera_state, derive_render_camera,
    )
    from project3_cuda_path_tracer_2025_tpu_torch.utils import prng

    cfg = RenderConfig()
    inline = draws_inline(fused)  # the package's bounce kernel counts lanes where it draws
    counting = variant_library(("PTT_COUNT_LANES",)) if device.type == "cuda" and inline else None
    for name in BOUNCE_SCENES:
        scene = iteration_scene(name, args.res)
        dev, static = build_device_scene(scene, device)
        cam = camera_state(derive_render_camera(scene.state.camera))
        n = static.pixel_count
        bounces = min(args.bounces or static.trace_depth, static.trace_depth)
        for d, (paths, skey) in enumerate(prim_bounce_states(static, cam, cfg, device, bounces)):
            u = prng.uniforms_at(skey, paths.pixel, 3, n)
            if inline:
                main = lambda p=paths, k=skey: fused.fused_prim_bounce(static, cfg, p, su_key=k)
            else:  # megakernel_iteration's form before the inline draw
                main = lambda p=paths, k=skey: fused.fused_prim_bounce(
                    static, cfg, p, prng.uniforms(k, n, 3, device))
            given = lambda p=paths, u=u: fused.fused_prim_bounce(static, cfg, p, u)
            out = given()
            shas = {"main": sha(*_bounce_planes(main())), "uniforms": sha(*_bounce_planes(out))}
            use = bounce_lane_use(fused, static, cfg, paths, skey, counting)
            for form, fn in (("main", main), ("uniforms", given)):
                recs.append(measure.emit(dict(
                    kind="bounce", scene=name, bounce=d, form=form, inline=inline,
                    ms=timed(fn, args.k),
                    device_ms=device_ms(fn, args.k, ("ptt_bounce_kernel", "ptt_uniforms_kernel")),
                    result_sha=shas[form], **use, **common)))
        if name == "cornell_dof":
            it = [0]

            def frame():
                it[0] += 1
                return megakernel_iteration(dev, static, cfg, cam, film_ops.new_film(n, device),
                                            it[0], prng.prng_key(0))
            time_frame(name, "bounce kernel", frame)
        del dev


def _bounce_planes(p) -> tuple:
    return (*p.origin, *p.direction, *p.color, p.bounces)


def run_prepass(args, measure, recs, common, timed, device, scene_at, frame_of,
                time_frame, builds) -> None:
    """The ``prepass`` lines: #11 on each sorted 80k bounce and at bounce 0
    of 200k and 500k (and from each of ``builds``), then the 80k frame with
    ``PTT_PLAN_IMPL=pallas``."""
    from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu_torch.ops import intersect_mxu as mxu
    from project3_cuda_path_tracer_2025_tpu_torch.scene import (
        build_device_scene, camera_state, derive_render_camera,
    )

    cfg = RenderConfig()
    for name in ("80k", "200k", "500k"):
        scene = scene_at(SCENE_FILES[name])
        dev, static = build_device_scene(scene, device)
        cam = camera_state(derive_render_camera(scene.state.camera))
        tables = dev.mxu_mesh
        ct = tables.tile_aabb.shape[0]
        bounces = (args.bounces or static.trace_depth) if name == "80k" else 1
        for d, (paths, tl, live) in enumerate(sorted_bounces(dev, static, cam, cfg, device,
                                                             bounces)):
            pr = mxu.plan_rays(tables, paths.origin, paths.direction, live, tl)
            fn = lambda pr=pr: mxu.plan_prepass(tables.tile_aabb, *pr)
            h, lb = fn()
            pairs = prepass_pairs(mxu, pr.live)
            recs.append(measure.emit(dict(
                kind="prepass", scene=name, bounce=d, tiles=ct, **pairs,
                pairs_per_block_design=pairs["rays_per_block_design"] * ct,
                pairs_live=pairs["live"] * ct,
                **dict(zip(("bytes_needed", "operations"), prepass_work(mxu, ct, pr.live))),
                ms=timed(fn, args.k),
                device_ms=device_ms(fn, args.k, ("ptt_plan_prepass_kernel",)),
                result_sha=sha(h, lb), **common)))
            for define, lib in builds.items():
                with library_used(lib):
                    recs.append(measure.emit(dict(
                        kind="prepass", scene=name, bounce=d, tiles=ct, build=define,
                        device_ms=device_ms(fn, args.k, ("ptt_plan_prepass_kernel",)),
                        result_sha=sha(*fn()), **common)))
        if name == "80k":
            time_frame(name, "auto, PTT_PLAN_IMPL=pallas", frame_of(dev, static, cam, cfg),
                       PTT_PLAN_IMPL="pallas")
        del dev


def run_epilogue(args, measure, recs, common, timed, device, builds) -> None:
    """The ``epilogue`` lines: #13a and #13b, every flavor, with #5 (and #4
    at 5k) on the measuring script's populations (and from each of
    ``builds``)."""
    from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer
    from project3_cuda_path_tracer_2025_tpu_torch.ops import intersect_mxu as mxu
    from project3_cuda_path_tracer_2025_tpu_torch.scene import load_scene, set_resolution

    # This checkout's measuring script (its population and bounds); the
    # package it drives is the one imported above.
    spec = importlib.util.spec_from_file_location(
        "ptt_profile_epilogue", os.path.join(REPO, "scripts", "torch_profile_epilogue.py"))
    tpe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tpe)
    cfg = RenderConfig(mesh_intersector="mxu", ray_sorting="off")
    eps = cfg.baby_epsilon
    kernel_of = {"lanebest": "ptt_planned_lanebest_kernel", "mono": "ptt_mono_kernel",
                 "lb_asc": "ptt_lb_asc_kernel", "lb_mm": "ptt_lb_asc_kernel",
                 "full": "ptt_epilogue_mono_kernel", "gate": "ptt_epilogue_mono_kernel",
                 "mm": "ptt_epilogue_mono_kernel"}
    for name in ("5k", "20k"):
        scene = set_resolution(load_scene(os.path.join(REPO, SCENE_FILES[name])), args.res,
                               args.res)
        r = Renderer(scene, cfg, device=device)
        tables = r.dev.mxu_mesh
        ct = tables.tile_aabb.shape[0]
        for bounce0 in (False, True):
            paths, tl, live = tpe.capture_population(r, cfg, bounce0)
            ro, rd = paths.origin, paths.direction
            plan = mxu.plan_with_prefix(tables.tile_aabb, *mxu.plan_rays(tables, ro, rd, live, tl))
            asc = mxu.ascending_plan(plan, ct)
            gate_visits = mxu._mono_visits(tables, ro, rd, live, tl, gate=True)
            mono = lambda f: lambda: mxu.epilogue_mono_intersect(tables, ro, rd, live, tl, eps, f)
            fns = {
                "lanebest": lambda: mxu.planned_lanebest_intersect(tables, ro, rd, live, tl, plan,
                                                                   eps),
                "mono": lambda: mxu.mono_intersect(tables, r.static.num_triangles, ro, rd,
                                                   paths.alive.contiguous(), tl, eps),
                "lb_asc": lambda: mxu.lb_asc_intersect(tables, ro, rd, live, tl, asc, eps),
                "lb_mm": lambda: mxu.lb_asc_intersect(tables, ro, rd, live, tl, asc, eps,
                                                      mm_only=True),
                "full": mono("full"), "gate": mono("gate"), "mm": mono("mm"),
            }
            if ct > mxu.MONO_MAX_TILES:
                del fns["mono"]
            ref = fns["lanebest"]()
            for flavor, fn in fns.items():
                t, tri = fn()
                b_ms, b_by, wasted, sched_ms = tpe.variant_bound(
                    EPILOGUE_VARIANTS[flavor], tables, ro, rd, live, tl, plan, gate_visits)
                exact = flavor not in ("lb_mm", "mm")
                line = dict(
                    kind="epilogue", scene=name, bounce0=bounce0, flavor=flavor, tiles=ct,
                    live=int(live.sum()), visits=int(plan.cnt.sum()),
                    equal_to_lanebest=bool(torch.equal(t.view(torch.int32),
                                                       ref[0].view(torch.int32))
                                           and torch.equal(tri, ref[1])) if exact else None,
                    bound_ms=b_ms, bound_by=b_by, schedule_bound_ms=sched_ms,
                    wasted_pairs=wasted, result_sha=sha(t, tri), **common)
                recs.append(measure.emit(dict(
                    line, ms=timed(fn, args.k),
                    device_ms=device_ms(fn, args.k, (kernel_of[flavor],)))))
                for define, lib in builds.items():
                    with library_used(lib):
                        recs.append(measure.emit(dict(
                            line, build=define, result_sha=sha(*fn()), ms=timed(fn, args.k),
                            device_ms=device_ms(fn, args.k, (kernel_of[flavor],)))))
        del r


def main(argv=None) -> int:
    recs = run(argv)
    ref = {(r["scene"], r["bounce"]): r["result_sha"] for r in recs
           if r.get("kind") == "bounce" and r["form"] == "main"}
    bad = [r for r in recs if r.get("kind") == "bounce"
           and r["result_sha"] != ref[(r["scene"], r["bounce"])]]
    pre = {(r["scene"], r["bounce"]): r["result_sha"] for r in recs
           if r.get("kind") == "prepass" and "build" not in r}
    bad += [r for r in recs if r.get("kind") == "prepass"
            and r["result_sha"] != pre[(r["scene"], r["bounce"])]]
    bad += [r for r in recs if r.get("kind") == "iteration" and r["build"] != "package"
           and r["film_sha"] != next(q["film_sha"] for q in recs if q.get("kind") == "iteration"
                                     and q["scene"] == r["scene"] and q["build"] == "package")]
    epi = {(r["scene"], r["bounce0"], r["flavor"]): r["result_sha"] for r in recs
           if r.get("kind") == "epilogue" and "build" not in r}
    bad += [r for r in recs if r.get("kind") == "epilogue" and (
        r["equal_to_lanebest"] is False
        or r["result_sha"] != epi[(r["scene"], r["bounce0"], r["flavor"])])]
    if bad:
        print(f"results or films that differ from the package's: {bad}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
