"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``project3_cuda_path_tracer_2025_tpu_torch/csrc``
(one ``nvcc`` per library, started together), holds each against its plain
PyTorch version on the card, drives the main paths with the launch counters
reset -- the prim path (``Renderer`` on ``scenes/cornell_dof.json`` at
800x800, depth 8, and ``megakernel_iteration``, phases 1-7), the mono mesh
path (``scenes/cornell_mesh_5k.json``, phase 8) and the larger meshes, all
at 800x800, depth 8: the planned walks (``cornell_mesh_20k.json``, phase
10), the streamed walk (``cornell_mesh_80k.json`` and
``cornell_mesh_500k.json``, phase 11), the packet-binned traversal
(``cornell_mesh_200k.json``, phase 12), textured
prims (``cornell_prim_textured_local.json``, the shade kernel's mode
"precomputed", phase 13), a textured and bump-mapped mesh
(``cornell_mesh_textured_local.json`` and ``_bump_local``, mode "textured",
phase 14), the wavefront integrator with the scan kernel (phase 15), and
the rest of the mesh traversals: the sweep (20k and, as a chain of calls,
80k; phase 16), the planned chains (80k, 200k, and a torus knot of 1.1 M
triangles, beyond the streamed plan's 1,024 tiles, that the script writes
into ``build/chip_smoke/``; phase 17), the super-tile streamed walk
(``PTT_STREAM_SUPER=1`` on 500k, phase 18) and the plan prepass kernel
(``PTT_PLAN_IMPL=pallas``, phase 19) --
checks the results against the committed golden films, and times the
kernel paths against the plain versions with CUDA events; phase 9 profiles
whole frames.  Phases 8e, 12g and 14e check and time the mesh-shade kernel
on each sorted bounce as the main path launches it, with the carried prim
winner (12g with the key at the 200k mesh's 196 tiles), phase 12f
the prelude kernel (bounce 0's key) on the 200k camera rays, and phase
12h the packet bins kernels on every 200k bounce a binned tier holds; phase 7
logs the iteration kernel's lane use from a counting build of it.  Phase
23 drives multi-device and chunked rendering on the one card (``cuda:0``
named nd times): the block draw of the Threefry kernel, pixel
mode, ``pixel_chunks``, the 5k mesh and the wavefront held bit for bit to
the unsharded films, sample mode, and their ms/frame.  Phase 25 drives the
repo's entry points in the port: ``bench_torch.py`` (its line printed),
``entry()``'s step against the same step on the CPU, and every tag of
``dryrun_multichip(4)`` on ``cuda:0`` named four times.  Phase 26 holds the
iteration kernel's lobes at 800x800 (``cornell_all_lobes.json``) to the
plain path and to the benchmark's reference, the counting variant's lobe
tally included.  Any failure raises and exits non-zero.

Output: progress lines, then the card's ``nvidia-smi`` name and power
limit, then one JSON line describing the kernels, and last one JSON line
``{"ok": true, "device": {...}}``.  Needs no JAX and no network.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time
import types

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# The card's label, CUDA-event timing, the bound (bytes over the card's
# memory rate against float32 operations over its peak) and the mono walk's
# work are the measuring scripts' too.
from project3_cuda_path_tracer_2025_tpu_torch.utils.measure import (  # noqa: E402
    OPS_MONO_PAIR, OPS_MONO_TILE, bound_ms, card_label, event_ms as cuda_time_ms, mono_work,
)

sys.path.insert(0, str(ROOT / "scripts"))
# The sorted bounce states of phase 11 and the film hashes are the A/B
# script's, so that its numbers and this script's describe the same rays
# and films.
from torch_bench_kernels import (  # noqa: E402
    OPS_PLAN_PAIR, binned_args, bins_inputs, bins_work, bounce_lane_use, chain_calls, device_ms,
    env_set, iteration_scene, lane_use, prepass_pairs, prepass_work, prim_bounce_states, sha,
    shade_outputs, shade_states,
    sorted_bounces, super_args, variant_library,
)

PKG = "project3_cuda_path_tracer_2025_tpu_torch"
SCENE = ROOT / "scenes" / "cornell_dof.json"
SCENE_LOBES = ROOT / "scenes" / "cornell_all_lobes.json"
GOLDEN = ROOT / "tests" / "goldens" / "dof.npz"
MESH_SCENE = ROOT / "scenes" / "cornell_mesh_5k.json"
MESH_GOLDEN = ROOT / "tests" / "torch_goldens" / "mesh5k.npz"
LARGE = {k: ROOT / "scenes" / f"cornell_mesh_{k}.json" for k in ("20k", "80k", "200k", "500k")}
GOLDEN_20K = ROOT / "tests" / "torch_goldens" / "mesh20k.npz"
GOLDEN_80K = ROOT / "tests" / "torch_goldens" / "mesh80k.npz"
PRIM_TEX = ROOT / "scenes" / "cornell_prim_textured_local.json"
MESH_TEX = ROOT / "scenes" / "cornell_mesh_textured_local.json"
MESH_BUMP = ROOT / "scenes" / "cornell_mesh_textured_bump_local.json"
TEX_GOLDENS = {PRIM_TEX: "prim_textured", MESH_TEX: "mesh_textured",
               MESH_BUMP: "mesh_textured_bump"}
# The plain walk on the 200k and 500k meshes runs on a fixed sub-range of
# each bounce's sorted rays, its first 64 blocks (16,384 rays, the live
# rays first), to keep the run short.
PLAIN_BLOCKS = 64
OUT_DIR = ROOT / "build" / "chip_smoke"

# Float32 operations per call of the kernels' device functions (the mono
# walk's are utils/measure.py's), counted from csrc/prim_path.cuh and
# csrc/mesh_path.cuh: each add, multiply,
# division, square root, sin/cos, min/max, compare and abs is one, an fma
# two.  Transforms are counted at their folded minimum (a scale and a
# translation per row), scatter at the diffuse lobe, and integer work
# (Threefry, key packing) is left out, so the bounds are lower bounds.
OPS_BOX, OPS_SPHERE = 78, 60  # box_t, sphere_t
OPS_NEAREST = 25  # intersect_prims around the tests: compares, winner normal, flip
OPS_SCATTER = 100  # scatter (diffuse lobe, new origin, throughput)
OPS_RAYGEN = 45
OPS_WALK_RAY = 25  # features and reciprocal direction (the root cull runs in torch)
OPS_KEY_TILE, OPS_KEY_RAY = 28, 60  # coherence_key per tile / per ray
OPS_UNIFORM = 80  # uniform_at: Threefry-2x32's 20 rounds and 5 key injections, the float
OPS_MERGE = 10  # mesh-hit merge and normal flip
OPS_RESOLVE = 68  # mesh_surface: (u, v) by Moller-Trumbore, interpolated normal, normalize
ROW_RESOLVE = 76  # bytes of attrs_shade mesh_surface reads a mesh-hit lane

# Film comparisons between the kernel and the plain path: the goldens'
# per-pixel tolerance (tests/test_goldens.py), a bound on the share of pixels
# outside it (a last-ulp difference in cos/sin can fork a path at a
# silhouette or a lobe choice), and a bound on the film sums.
RTOL, ATOL = 2e-4, 2e-5
MAX_PIXEL_SHARE = 0.005
MAX_SUM_REL = 1e-4
MAX_ALIVE_REL = 1e-3
# Stage comparisons (one bounce from identical inputs) are held tighter.
STAGE_RTOL, STAGE_ATOL = 1e-5, 1e-6
MAX_STAGE_LANE_SHARE = 1e-4
TIMING_ROUNDS = 4  # per-kernel and frame repeats: scripts/torch_bench_kernels.py
# and torch_bench_scenes.py take the many samples of an A/B


def log(msg: str) -> None:
    print(msg, flush=True)


def prim_ops(static) -> int:
    """Operations of one intersect_prims call over the scene's prims."""
    from project3_cuda_path_tracer_2025_tpu_torch.scene.types import GeomType

    return OPS_NEAREST + sum(
        OPS_BOX if g.gtype == int(GeomType.CUBE) else OPS_SPHERE for g in static.geoms
    )


def film_np(film) -> np.ndarray:
    """[N, 3] on the host, from a ``Film`` or an [N, 3] array."""
    if isinstance(film, np.ndarray):
        return film
    return torch.stack([film.x, film.y, film.z], dim=1).cpu().numpy()


def compare_films(tag: str, got, want) -> dict:
    g, w = film_np(got), film_np(want)
    outside = ~np.isclose(g, w, rtol=RTOL, atol=ATOL)
    res = dict(
        sum_rel=float(abs(g.sum() - w.sum()) / abs(w.sum())),
        pixel_share=float(outside.any(axis=1).mean()),
        max_abs=float(np.abs(g - w).max()),
        finite=bool(np.isfinite(g).all()),
    )
    log(f"  {tag}: film sums {g.sum():.6f} vs {w.sum():.6f} (rel {res['sum_rel']:.3e}), "
        f"pixels outside rtol={RTOL} atol={ATOL}: {res['pixel_share']:.5%}, "
        f"max abs diff {res['max_abs']:.6g}")
    return res


def time_paths(paths_t: dict, rounds: dict) -> dict:
    """Per-call CUDA-event times: ``paths_t`` name -> (fn, calls/sample),
    sampled in turns (order reversed every round); ``rounds`` name -> the
    number of samples.  Returns name -> list of ms."""
    times = {k: [] for k in paths_t}
    for fn, _ in paths_t.values():
        fn()  # warm-up
    torch.cuda.synchronize()
    order = list(paths_t)
    for rnd in range(max(rounds.values())):
        for k in (order if rnd % 2 == 0 else order[::-1]):
            if rnd < rounds[k]:
                fn, reps = paths_t[k]
                times[k].append(cuda_time_ms(fn, reps))
    return times


def device_busy(fn, calls: int) -> tuple:
    """``torch.profiler`` over ``calls`` back-to-back calls of ``fn``, after
    one call under a warm-up step of the profiler's schedule (tracing runs
    but is not kept: the first records after tracing starts can be lost):
    (device ms per call, wall ms per call under the profiler, device
    launches per call, the device events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
        prof.step()
    # The schedule's step annotation ("ProfilerStep#") and each of the port's
    # spans ("ptt.", utils/timers.py) have a device span too: annotations
    # mirrored onto the device's timeline, not launches.
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and not e.key.startswith(("ProfilerStep", "ptt."))
           and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in dev) / 1e3 / calls
    count = sum(e.count for e in dev) / calls
    return busy, wall, count, dev


PROFILE_FEW_MS = 15.0  # a frame faster than this is profiled three times


def profile_paths(paths: dict) -> None:
    """Phase 9: ``torch.profiler`` over whole frames of each path (name ->
    (zero-argument frame function, the name of its main kernel)): device
    busy time per frame (the sum of the kernels' and copies' device time;
    one stream, so nothing overlaps), wall time per frame under the profiler
    (inflated by its own host overhead), device launches per frame and the
    top device functions.  Three frames of a path whose frame takes under
    ``PROFILE_FEW_MS`` (the prim paths, a few launches), one of the others
    (thousands of launches a mesh frame, and the profiler's processing
    grows with them).  A profile that holds no launch of the main kernel is
    taken again over ten times the frames; one that still holds none is
    flagged and its device time not reported."""
    for name, (fn, kernel) in paths.items():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        k = 3 if (time.perf_counter() - t0) * 1e3 < PROFILE_FEW_MS else 1
        busy, wall, count, dev = device_busy(fn, k)
        if not any(kernel in e.key for e in dev):
            k *= 10
            busy, wall, count, dev = device_busy(fn, k)
        if not any(kernel in e.key for e in dev):
            log(f"[9] {name}: FLAGGED, the profile of {k} frames holds no launch of {kernel} "
                f"({count:.0f} device launches/frame recorded); device time not reported")
            continue
        log(f"[9] {name} ({k} frame{'s' if k > 1 else ''}): device busy {busy:.4f} ms/frame, "
            f"wall under the profiler {wall:.4f} ms/frame ({busy / wall:.1%} busy), "
            f"{count:.0f} device launches/frame")
        for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:6]:
            log(f"      {e.self_device_time_total / 1e3 / k:9.4f} ms/frame "
                f"x{e.count / k:5.1f}  {e.key[:90]}")


def mesh_phases(device, smi: str) -> tuple:
    """Phase 8: the mesh path on scenes/cornell_mesh_5k.json at 800x800,
    depth 8.  Returns the two mesh kernels' entries of the kernels line and
    the mesh path's frame functions for phase 9."""
    import dataclasses

    from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer, megakernel_iteration
    from project3_cuda_path_tracer_2025_tpu_torch.ops import camera as camera_ops
    from project3_cuda_path_tracer_2025_tpu_torch.ops import film as film_ops
    from project3_cuda_path_tracer_2025_tpu_torch.ops import fused, intersect_mxu
    from project3_cuda_path_tracer_2025_tpu_torch.ops.compaction import permute_path_state
    from project3_cuda_path_tracer_2025_tpu_torch.ops.intersect import prim_t_min
    from project3_cuda_path_tracer_2025_tpu_torch.scene import (
        build_device_scene, camera_state, derive_render_camera, load_scene,
        set_resolution,
    )
    from project3_cuda_path_tracer_2025_tpu_torch.utils import prng

    scene = load_scene(str(MESH_SCENE))
    dev, static = build_device_scene(scene, device)
    cam = camera_state(derive_render_camera(scene.state.camera))
    cfg = RenderConfig()
    n, depth = static.pixel_count, static.trace_depth
    tables = dev.mxu_mesh
    ct = tables.tile_aabb.shape[0]
    prim_static = dataclasses.replace(static, num_triangles=0)
    idx = torch.arange(n, device=device)
    ik = prng.iteration_key(prng.prng_key(0), 1)
    paths = camera_ops.generate_camera_rays(
        cam, static.width, static.height, depth,
        prng.uniforms_at(prng.stage_key(ik, 0, 0), idx, 4, n))
    log(f"[8] mesh path: {MESH_SCENE.name}, {static.width}x{static.height} depth {depth}, "
        f"{static.num_triangles} triangles in {ct} tiles")
    cam_paths = paths

    # -- 8a/8b. both kernels against their plain versions, on the camera rays
    #    and two bounces, in the main path's (sorted) order ----------------
    mono_err, shade_err = 0.0, 0.0
    mono_case = shade_case = None
    for d in range(3):
        tl, win = prim_t_min(static, cfg, paths.origin, paths.direction, winner=True)
        perm = intersect_mxu.coherence_perm(tables, paths.origin, paths.direction, paths.alive,
                                            tl, cfg.ray_sort_bits, cfg.ray_sort_dir_bits,
                                            mode="signature")
        paths, (tl, win) = permute_path_state(paths, perm, extra=(tl, win))
        margs = (tables, static.num_triangles, paths.origin, paths.direction, paths.alive, tl,
                 cfg.baby_epsilon)
        t_k, tri_k = intersect_mxu.mono_intersect(*margs)
        t_p, tri_p = intersect_mxu.mono_intersect_plain(*margs)
        torch.cuda.synchronize()
        tri_bad = int((tri_k != tri_p).sum())
        t_bad = int((t_k.view(torch.int32) != t_p.view(torch.int32)).sum())
        hits = int((tri_k >= 0).sum())
        log(f"[8a] mono bounce {d}: {hits} mesh hits of {int(paths.alive.sum())} alive rays; "
            f"rays with tri differing {tri_bad}, with t not bit-equal {t_bad}")
        if tri_bad or t_bad or hits == 0:
            raise AssertionError("the mono kernel disagrees with its plain version")
        mono_err = max(mono_err, float((t_k - t_p).abs().max()))
        if mono_case is None:
            mono_case = margs
        # Mode "plain": the shade resolves the winner's surface from the walk's (t, tri).
        mh = fused.mesh_walk(tables, static, cfg, paths, tl)
        skey = prng.stage_key(ik, d, 1)
        for emit in fused.EMIT_MODES:
            sargs = (prim_static, cfg, paths, mh.t, None, None, skey, n, emit)
            # The main path's carried prim winner (here the prepass's).
            skw = dict(tables=tables, prim_winner=win, mesh_tri=mh.tri)
            got = fused.fused_mesh_shade(*sargs, **skw)
            want = fused.fused_mesh_shade_plain(*sargs, **skw)
            torch.cuda.synchronize()
            (gp, gc), (wp, wc) = (got, want) if emit else ((got, None), (want, None))
            fk = [*gp.origin, *gp.direction, *gp.color, gp.bounces] + (
                [x for x in gc if x is not None] if emit else [])
            fp = [*wp.origin, *wp.direction, *wp.color, wp.bounces] + (
                [x for x in wc if x is not None] if emit else [])
            # Plane for plane: the lanes whose bits differ.
            bad = [bits_differ(a, b) for a, b in zip(fk, fp)]
            err = max(float((a - b).abs().max()) for a, b in zip(fk[:9], fp[:9]))
            log(f"[8b] shade bounce {d} emit={emit or 'none'}: "
                f"{int(((mh.tri >= 0) & paths.alive).sum())} lanes resolving a mesh hit; lanes "
                f"not bit-equal to the plain version by plane (o xyz, d xyz, color rgb, bounces"
                f"{', t_lim, key, winner' if emit == 'tlim+key' else ', t_lim, winner' if emit else ''}"
                f"): {bad}; max abs diff {err:.3g}")
            if any(bad):
                raise AssertionError("the mesh-shade kernel disagrees with its plain version")
            shade_err = max(shade_err, err)
            if emit == "tlim+key" and shade_case is None:
                shade_case = (sargs, skw)
        paths = want[0]

    # -- 8c. one frame: the kernel path against the plain fused-mesh path,
    #    and sorted against unsorted ----------------------------------------
    base_key = prng.prng_key(0)
    frame = lambda c, plain=False: megakernel_iteration(
        dev, static, c, cam, film_ops.new_film(n, device), 1, base_key, plain=plain)
    film_s, alive_s = frame(cfg)
    film_u, alive_u = frame(RenderConfig(ray_sorting="off"))
    film_p, alive_p = frame(cfg, plain=True)
    film_e, alive_e = megakernel_iteration(dev, static, cfg, cam, film_ops.new_film(n, device), 1,
                                           base_key, carry_winner=False)
    torch.cuda.synchronize()
    log("[8c] one frame, kernel path vs the plain fused-mesh path (megakernel_iteration "
        "plain=True):")
    r_frame = compare_films("sorted kernel path vs plain", film_s, film_p)
    sorted_eq = all(torch.equal(a, b) for a, b in zip(film_s, film_u))
    carry_eq = all(torch.equal(a, b) for a, b in zip(film_s, film_e))
    log(f"  sorted and unsorted kernel films bit-identical: {sorted_eq}; with and without the "
        f"carried prim winner: {carry_eq}; alive per depth "
        f"kernel {alive_s.tolist()}, plain {alive_p.tolist()}")
    alive_rel = np.abs(alive_s.cpu().numpy() - alive_p.cpu().numpy()) / np.maximum(
        alive_p.cpu().numpy(), 1)
    if not (sorted_eq and carry_eq and torch.equal(alive_s, alive_e)
            and torch.equal(alive_s, alive_u) and r_frame["finite"]
            and r_frame["sum_rel"] <= MAX_SUM_REL and r_frame["pixel_share"] <= MAX_PIXEL_SHARE
            and (alive_rel <= MAX_ALIVE_REL).all()):
        raise AssertionError("the mesh kernel path disagrees with the plain path")

    # -- 8d. the main path, counters reset ---------------------------------
    counters = (intersect_mxu.mono_intersect, fused.fused_mesh_shade,
                fused.fused_prim_iteration, fused.fused_prim_bounce, fused.mesh_prelude)
    for c in counters:
        c.launches = 0
    r = Renderer(str(MESH_SCENE))
    r.step_many(4)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    img = r.image()
    log(f"[8d] Renderer('{MESH_SCENE.name}') step_many(4): iteration {r.iteration}, launches "
        f"{launches}, film sum {img.sum():.3f}, alive {r._alive_counts.tolist()}")
    if (launches["mono_intersect"], launches["fused_mesh_shade"],
            launches["fused_prim_iteration"], launches["fused_prim_bounce"],
            launches["mesh_prelude"]) != (4 * depth, 4 * depth, 0, 0, 4):
        raise AssertionError("the mesh Renderer did not take the mesh kernels 8 times per spp "
                             "and the prelude once")
    if not np.isfinite(img).all() or not img.sum() > 0:
        raise AssertionError("mesh main-path film is empty or not finite")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    log(f"    saved {pathlib.Path(r.save(out_dir=str(OUT_DIR))).relative_to(ROOT)}")
    g = np.load(MESH_GOLDEN)
    small = Renderer(set_resolution(load_scene(str(MESH_SCENE)), int(g["width"]),
                                    int(g["height"])))
    small.step_many(int(g["spp"]))
    got, want = film_np(small.film), g["film"]
    outside = ~np.isclose(got, want, rtol=RTOL, atol=ATOL)
    share = float(outside.any(axis=1).mean())
    sum_rel = float(abs(got.sum() - want.sum()) / abs(want.sum()))
    log(f"    golden {MESH_GOLDEN.name}: pixels outside rtol={RTOL} atol={ATOL}: {share:.3%}, "
        f"film-sum rel diff {sum_rel:.3e}, max abs diff {np.abs(got - want).max():.3g}")
    if not np.isfinite(got).all() or share > 0.01 or sum_rel > 1e-3:
        raise AssertionError("the card's mesh render disagrees with the golden film")

    # -- 8e. timing ----------------------------------------------------------
    rays = float(n + alive_s.sum().item())
    film_t = film_ops.new_film(n, device)
    it = [0]

    def run_path(c):
        def fn():
            it[0] += 1
            megakernel_iteration(dev, static, c, cam, film_t, it[0], base_key)
        return fn

    paths_t = {
        "mesh kernel path, sorted": (run_path(cfg), 5),
        "mesh kernel path, unsorted": (run_path(RenderConfig(ray_sorting="off")), 5),
        "mono kernel (1 bounce)": (lambda: intersect_mxu.mono_intersect(*mono_case), 10),
        "plain mono (1 bounce)": (lambda: intersect_mxu.mono_intersect_plain(*mono_case), 1),
        "mesh-shade kernel (1 bounce)": (
            lambda: fused.fused_mesh_shade(*shade_case[0], **shade_case[1]), 20),
        "plain mesh shade (1 bounce)": (
            lambda: fused.fused_mesh_shade_plain(*shade_case[0], **shade_case[1]), 1),
    }
    rounds = {k: (1 if k.startswith("plain") else TIMING_ROUNDS) for k in paths_t}
    times = time_paths(paths_t, rounds)
    ms = {k: float(np.median(v)) for k, v in times.items()}
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"[8e] timing on {smi} (after the runs: sm clock, power, temperature = {clocks}), "
        f"{MESH_SCENE.name} {static.width}x{static.height} depth {depth}, {rays:.0f} ray "
        "segments/frame; median of the samples [quartiles], each the mean over the calls "
        "shown:")
    for k, v in ms.items():
        q1, q3 = np.percentile(times[k], [25, 75])
        per = "per launch" if "1 bounce" in k else "per frame"
        rate = "" if "1 bounce" in k else f", {rays / (v * 1e3):.1f} Mrays/s"
        log(f"    {k:30s} {v:10.4f} ms {per} [{q1:.4f}, {q3:.4f}]{rate}  "
            f"({paths_t[k][1]} calls/sample, {rounds[k]} samples)")

    # Bounds at the timed shapes (bounce 0 of the main path, sorted).
    mono_b = mono_bound(mono_case)
    act, pairs = mono_b[3], mono_b[2]
    live = int(shade_case[0][2].alive.sum())
    hits = int(((shade_case[1]["mesh_tri"] >= 0) & shade_case[0][2].alive).sum())
    shade_bound = bound_ms(
        n * (13 + 12) * 4 + hits * ROW_RESOLVE,  # 13 planes in, 12 out, a hit's row
        live * (prim_ops(prim_static) + OPS_MERGE + OPS_SCATTER) + hits * OPS_RESOLVE
        + n * (prim_ops(prim_static) + OPS_KEY_RAY + ct * OPS_KEY_TILE),
    )
    log(f"    bounds: mono kernel {mono_b[0]:.4f} ms ({mono_b[1]}; {pairs} (ray, tile) "
        f"pairs whose entry is no farther than the ray's hit, of {int(act.sum())} root-hitting "
        f"rays), mesh-shade kernel "
        f"{shade_bound[0]:.4f} ms ({shade_bound[1]}; {live} live rays, {hits} resolving a "
        "mesh hit)")

    # The mono kernel on each of the frame's eight sorted bounces (the A/B
    # script's states), checked against its plain version and timed with its
    # bound; then on the unsorted camera rays.
    for d, (p, tl_d, live_d) in enumerate(sorted_bounces(dev, static, cam, cfg, device,
                                                         bounces=depth)):
        a = (tables, static.num_triangles, p.origin, p.direction, p.alive, tl_d,
             cfg.baby_epsilon)
        tri_bad, t_bad, _ = bit_diff(intersect_mxu.mono_intersect(*a),
                                     intersect_mxu.mono_intersect_plain(*a))
        if tri_bad or t_bad:
            raise AssertionError(f"the mono kernel disagrees with its plain version, bounce {d}")
        launch("8e", f"mono_intersect sorted bounce {d}",
               lambda a=a: intersect_mxu.mono_intersect(*a), 20, mono_bound(a), live_d, smi)
    tl_u = prim_t_min(static, cfg, cam_paths.origin, cam_paths.direction)
    a = (tables, static.num_triangles, cam_paths.origin, cam_paths.direction, cam_paths.alive,
         tl_u, cfg.baby_epsilon)
    bu = mono_bound(a)
    launch("8e", "mono_intersect unsorted bounce 0", lambda: intersect_mxu.mono_intersect(*a), 20,
           bu, bu[3], smi)
    shade_bounces("8e", dev, static, cam, cfg, device, smi)

    profiled = {
        "mesh kernel path, sorted": (paths_t["mesh kernel path, sorted"][0],
                                     "ptt_mono_kernel"),
        "mesh kernel path, unsorted": (paths_t["mesh kernel path, unsorted"][0],
                                       "ptt_mono_kernel"),
    }
    return [
        {
            "name": "mono_intersect",
            "route": "cuda",
            "source": f"{PKG}/csrc/mesh_walk.cu",
            "replaces": "project3_cuda_path_tracer_2025_tpu/ops/intersect_mxu.py:1423",
            "launches": launches["mono_intersect"],
            "max_abs_err": mono_err,
            "ms": ms["mono kernel (1 bounce)"],
            "plain_ms": ms["plain mono (1 bounce)"],
            "bound_ms": mono_b[0],
            "bound_by": mono_b[1],
            "library_ms": None,
        },
        {
            "name": "fused_mesh_shade",
            "route": "cuda",
            "source": f"{PKG}/csrc/fused_mesh.cu",
            "replaces": "project3_cuda_path_tracer_2025_tpu/ops/fused.py:201",
            "launches": launches["fused_mesh_shade"],
            "max_abs_err": shade_err,
            "ms": ms["mesh-shade kernel (1 bounce)"],
            "plain_ms": ms["plain mesh shade (1 bounce)"],
            "bound_ms": shade_bound[0],
            "bound_by": shade_bound[1],
            "library_ms": None,
        },
    ], profiled


# ---------------------------------------------------------------------------
# Phases 10-12: the meshes beyond the mono band (csrc/mesh_walk.cu)
# ---------------------------------------------------------------------------

def launch(tag, what, fn, reps, bound, live, smi) -> float:
    """One kernel's ms per launch on the card (median of 3 samples of
    ``reps`` launches, after one), logged with its ``bound`` (walk_bound or
    visit_bound) and its share of it."""
    fn()
    torch.cuda.synchronize()
    ms = float(np.median([cuda_time_ms(fn, reps) for _ in range(3)]))
    log(f"[{tag}] {what}: {ms:.4f} ms per launch on {smi}; {int(live.sum())} live rays, "
        f"{bound[2]} (ray, tile) pairs the result needs; bound {bound[0]:.4f} ms ({bound[1]}), "
        f"{bound[0] / ms:.1%} of it")
    return ms


def bit_diff(got: tuple, want: tuple) -> tuple:
    """(rays with tri differing, rays with t not bit-equal, max |t diff|)
    of two (t, tri) results."""
    (tk, trk), (tp, trp) = got, want
    t_bad = tk.view(torch.int32) != tp.view(torch.int32)
    diff = torch.where(t_bad, (tk - tp).abs(), torch.zeros_like(tk))
    return int((trk != trp).sum()), int(t_bad.sum()), float(diff.max()) if diff.numel() else 0.0


def walk_args(tables, paths, tl, live, blocks: int = None) -> tuple:
    """The walk kernels' arguments for one state (its full plan), cut to
    its first ``blocks`` blocks when given (a plan row covers one block, so
    the cut computes the same function on those rays)."""
    from project3_cuda_path_tracer_2025_tpu_torch.ops import intersect_mxu as mxu

    ro, rd = paths.origin, paths.direction
    plan = mxu.plan_with_prefix(tables.tile_aabb, *mxu.plan_rays(tables, ro, rd, live, tl))
    if blocks is not None:
        m, ct = blocks * mxu.RAY_TILE, tables.tile_aabb.shape[0]
        cut = lambda v: type(v)(*(x[:m].contiguous() for x in v))
        ro, rd, live, tl = cut(ro), cut(rd), live[:m].contiguous(), tl[:m].contiguous()
        plan = mxu.TilePlan(plan.ids[:blocks * ct].contiguous(),
                            plan.tlo[:blocks * ct].contiguous(), plan.cnt[:blocks].contiguous())
    return tables, ro, rd, live, tl, plan, 1e-5


def mono_bound(args) -> tuple:
    """Bound of one mono launch (``mono_work``): (ms, bound_by, pairs,
    root-hitting rays mask)."""
    nbytes, ops, pairs, act = mono_work(args)
    return bound_ms(nbytes, ops) + (pairs, act)


def walk_bound(args, gate_t) -> tuple:
    """Bound of one walk launch (#5, #6, #7): ``visit_bound`` over the
    tiles each block's plan row lists, with the plan's bytes, counting only
    the pairs whose slab entry is no farther than ``gate_t``, the walk's
    own result t (past a ray's final hit no order of tiles needs a pair:
    the candidate contract)."""
    from project3_cuda_path_tracer_2025_tpu_torch.ops import intersect_mxu as mxu

    tables, ro, rd, live, tl, plan, _ = args
    nb, ct = plan.cnt.shape[0], tables.tile_aabb.shape[0]
    return visit_bound(tables, ro, rd, live, tl, mxu._plan_visits(plan, ct), nb * (ct * 8 + 4),
                       gate_t)


def binned_bound(args) -> tuple:
    """Bound of one binned launch: the rays, the bins and the visited
    tiles' rows read once, the pair rows written; a member test per live
    pair row and the candidate pairs x 1,024 triangles.  Returns (ms,
    bound_by, member pair rows, (live pair rows, all pair rows))."""
    from project3_cuda_path_tracer_2025_tpu_torch.ops import intersect_mxu as mxu

    tables, ro, rd, live, tl, vt, src, n_g, _ = args
    n = ro.x.shape[0]
    tile, ray, ok = mxu._pair_rays(vt, src, n_g, n)
    ray = torch.clamp(ray, max=n - 1)
    ok = ok & live[ray]
    rf = mxu._features(tables, ro, rd)
    pairs = 0
    for c in torch.unique(tile[ok]).tolist():
        rr = ray[ok & (tile == c)]
        member, _, _ = mxu._member_slab(tables.tile_aabb[c].tolist(),
                                        type(rf.os)(*(x[rr] for x in rf.os)),
                                        type(rf.inv)(*(x[rr] for x in rf.inv)), tl[rr])
        pairs += int(member.sum())
    tiles = int(torch.unique(vt[vt >= 0]).numel())
    nbytes = n * (6 * 4 + 1 + 4) + vt.numel() * 4 + src.numel() * 4 \
        + tiles * mxu.TRI_TILE * mxu.COEF_W * 4 + vt.numel() * mxu.RAY_TILE * 8
    ops = int(ok.sum()) * (OPS_WALK_RAY + OPS_MONO_TILE) + pairs * mxu.TRI_TILE * OPS_MONO_PAIR
    return bound_ms(nbytes, ops) + (pairs, (int(ok.sum()), vt.numel() * mxu.RAY_TILE))


def traversals_agree(tag, tables, static, states, modes) -> None:
    """``mesh_intersect_mxu`` under each ``mxu_traversal`` mode on every ray
    of the states: (t, tri) bit-equal to the first mode's."""
    from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu_torch.ops import intersect_mxu as mxu

    cfg = RenderConfig()
    for d, (paths, tl, _) in enumerate(states):
        res = {m: mxu.mesh_intersect_mxu(
            tables, static.num_triangles, static.mxu_padded_tris, paths.origin,
            paths.direction, paths.alive, tl, cfg.baby_epsilon, compute_uv=False,
            **mxu.traversal_flags(m, static.mxu_padded_tris, binned_tiers=cfg.mxu_binned_tiers,
                                  binned_budget_rays=static.pixel_count))
            for m in modes}
        torch.cuda.synchronize()
        base = res[modes[0]]
        bad = {m: bit_diff((r.t, r.tri), (base.t, base.tri))[:2] for m, r in res.items()}
        log(f"[{tag}] bounce {d}: {' / '.join(modes)} on the same {paths.alive.numel()} rays "
            f"({int((base.tri >= 0).sum())} hits), (tri, t) rays differing from {modes[0]}: {bad}")
        if any(a or b for a, b in bad.values()) or not int((base.tri >= 0).sum()):
            raise AssertionError("the traversals disagree")


def on_device(ms) -> str:
    """A device time for a log line: "not measured" where the profiler
    caught no record of the kernel."""
    return "not measured" if ms is None else f"{ms:.4f} ms"


def bits_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """Lanes whose bit patterns differ (NaN payloads included)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum())


def check_golden(path_scene, golden) -> None:
    from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer
    from project3_cuda_path_tracer_2025_tpu_torch.scene import load_scene, set_resolution

    g = np.load(golden)
    small = Renderer(set_resolution(load_scene(str(path_scene)), int(g["width"]),
                                    int(g["height"])))
    small.step_many(int(g["spp"]))
    got, want = film_np(small.film), g["film"]
    outside = ~np.isclose(got, want, rtol=RTOL, atol=ATOL)
    share = float(outside.any(axis=1).mean())
    sum_rel = float(abs(got.sum() - want.sum()) / abs(want.sum()))
    log(f"    golden {golden.name}: pixels outside rtol={RTOL} atol={ATOL}: {share:.3%}, "
        f"film-sum rel diff {sum_rel:.3e}, max abs diff {np.abs(got - want).max():.3g}")
    if not np.isfinite(got).all() or share > 0.01 or sum_rel > 1e-3:
        raise AssertionError(f"the card's render disagrees with {golden.name}")


def drive(scene, spp: int, counters: dict, cfg=None) -> tuple:
    """A main path: ``Renderer(scene).step_many(spp)`` with every counter set
    to 0 just before and read just after.  Returns (renderer, launches)."""
    from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer

    r = Renderer(scene, cfg or RenderConfig())
    for c in counters.values():
        c.launches = 0
    r.step_many(spp)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    img = r.image()
    if not np.isfinite(img).all() or not img.sum() > 0:
        raise AssertionError("a main-path film is empty or not finite")
    return r, launches


def frame_fn(dev, static, cam, cfg, base_key, device):
    from project3_cuda_path_tracer_2025_tpu_torch.models import megakernel_iteration
    from project3_cuda_path_tracer_2025_tpu_torch.ops import film as film_ops

    film = film_ops.new_film(static.pixel_count, device)
    it = [0]

    def fn():
        it[0] += 1
        return megakernel_iteration(dev, static, cfg, cam, film, it[0], base_key)
    return fn


def with_env(fn, **env):
    def run():
        with env_set(**env):
            return fn()
    return run


def host_syncs(fn) -> str:
    """The synchronizing CUDA calls (reads of a device value to the host)
    made by one call of ``fn``, as ``torch.cuda.set_sync_debug_mode``
    reports them: their number and where in the source they are made."""
    import collections
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    where = collections.Counter(f"{pathlib.Path(w.filename).name}:{w.lineno}" for w in caught
                                if "synchroniz" in str(w.message))
    return f"{sum(where.values())} {dict(where)}"


def log_times(tag, smi, times, paths_t, rounds, rays: dict) -> dict:
    ms = {k: float(np.median(v)) for k, v in times.items()}
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"[{tag}] timing on {smi} (after the runs: sm clock, power, temperature = {clocks}); "
        "median of the samples [quartiles], each the mean over the calls shown:")
    for k, v in ms.items():
        q1, q3 = np.percentile(times[k], [25, 75])
        rate = f", {rays[k] / (v * 1e3):.1f} Mrays/s" if k in rays else ""
        per = "per frame" if k in rays else "per call"
        log(f"    {k:42s} {v:10.4f} ms {per} [{q1:.4f}, {q3:.4f}]{rate}  "
            f"({paths_t[k][1]} calls/sample, {rounds[k]} samples)")
    return ms


# Scenes and sorted bounce states that phases 10-12 loaded, kept for phases
# 16-19: name -> (scene, dev, static, cam) and name -> [(paths, t_lim, live)]
# (all eight bounces of the 20k, 80k and 500k frames, three of 200k).
LOADED, STATES = {}, {}


def larger_mesh_phases(device, smi: str) -> tuple:
    """Phases 10-12: the planned (cornell_mesh_20k.json), streamed
    (cornell_mesh_80k.json, the slice's main path, and cornell_mesh_500k.json)
    and binned (cornell_mesh_200k.json) traversals at 800x800, depth 8.
    Returns the four walk kernels' and the prelude kernel's entries of the
    kernels line and the 20k, 80k and 200k frames for phase 9."""
    from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu_torch.models import megakernel_iteration
    from project3_cuda_path_tracer_2025_tpu_torch.ops import film as film_ops
    from project3_cuda_path_tracer_2025_tpu_torch.ops import fused, intersect_mxu as mxu
    from project3_cuda_path_tracer_2025_tpu_torch.scene import (
        build_device_scene, camera_state, derive_render_camera, load_scene,
    )
    from project3_cuda_path_tracer_2025_tpu_torch.utils import prng

    cfg = RenderConfig()
    base_key = prng.prng_key(0)
    counters = {c.__name__: c for c in (
        mxu.mono_intersect, mxu.planned_lanebest_intersect, mxu.planned_intersect,
        mxu.streamed_intersect, mxu.binned_intersect, mxu.packet_bins, fused.fused_mesh_shade,
        fused.mesh_prelude)}
    err = {k: 0.0 for k in counters}
    main_launches, entries, profiled = {}, {}, {}

    def setup(name):
        t0 = time.perf_counter()
        scene = load_scene(str(LARGE[name]))
        dev, static = build_device_scene(scene, device)
        cam = camera_state(derive_render_camera(scene.state.camera))
        log(f"    {LARGE[name].name}: {static.num_triangles} triangles in "
            f"{dev.mxu_mesh.tile_aabb.shape[0]} tiles, {static.width}x{static.height} depth "
            f"{static.trace_depth}; loaded and uploaded in {time.perf_counter() - t0:.1f} s")
        LOADED[name] = (scene, dev, static, cam)
        return scene, dev, static, cam

    def check_walks(tag, kinds, states, tables, blocks=None):
        """Each walk kernel against walk_plain on every state: bit-equal."""
        hits = 0
        for d, (paths, tl, live) in enumerate(states):
            args = walk_args(tables, paths, tl, live, blocks)
            want = mxu.walk_plain(*args)
            for kind in kinds:
                fn = mxu.WALKS[kind]
                tri_bad, t_bad, e = bit_diff(fn(*args), want)
                torch.cuda.synchronize()
                log(f"[{tag}] {fn.__name__} bounce {d}: {int(args[3].sum())} live of "
                    f"{args[1].x.shape[0]} rays{' (the first %d blocks)' % blocks if blocks else ''}"
                    f", {int((want[1] >= 0).sum())} mesh hits; rays with tri differing {tri_bad},"
                    f" with t not bit-equal {t_bad}")
                if tri_bad or t_bad:
                    raise AssertionError(f"{fn.__name__} disagrees with walk_plain")
                err[fn.__name__] = max(err[fn.__name__], e)
            hits += int((want[1] >= 0).sum())
        if hits == 0:
            raise AssertionError(f"[{tag}] no mesh hit to compare")

    def per_bounce(tag, states, reps, kinds=("streamed",)):
        """Each walk kernel of ``kinds`` on each sorted bounce at full size,
        with its bound and share."""
        for d, st in enumerate(states):
            args = walk_args(tables, *st)
            bound = walk_bound(args, mxu.WALKS[kinds[0]](*args)[0])
            for kind in kinds:
                fn = mxu.WALKS[kind]
                launch(tag, f"{fn.__name__} bounce {d}", lambda fn=fn: fn(*args), reps, bound,
                       args[3], smi)

    # -- 10. planned, cornell_mesh_20k.json --------------------------------
    log("[10] planned walks (#5 lane-best, #6 with the early exit; the block schedule):")
    scene, dev, static, cam = setup("20k")
    tables, n, depth = dev.mxu_mesh, static.pixel_count, static.trace_depth
    states = STATES["20k"] = sorted_bounces(dev, static, cam, cfg, device, bounces=depth)
    check_walks("10a", ("planned_lanebest", "planned"), states, tables)
    per_bounce("10a", states, 20, ("planned_lanebest", "planned"))
    traversals_agree("10b", tables, static, states[:3], ("planned", "streamed", "binned"))
    r, got = drive(scene, 4, counters)
    log(f"[10c] Renderer('{LARGE['20k'].name}') step_many(4): launches {got}")
    if (got["planned_lanebest_intersect"], got["mono_intersect"], got["planned_intersect"],
            got["fused_mesh_shade"]) != (4 * depth, 0, 0, 4 * depth):
        raise AssertionError("the 20k Renderer did not take the lane-best walk once per bounce")
    main_launches["planned_lanebest_intersect"] = got["planned_lanebest_intersect"]
    with env_set(PTT_PLANNED_EPILOGUE="running"):
        r, got = drive(scene, 2, counters)
    log(f"[10d] the same with PTT_PLANNED_EPILOGUE=running, step_many(2): launches {got}")
    if (got["planned_intersect"], got["planned_lanebest_intersect"]) != (2 * depth, 0):
        raise AssertionError("PTT_PLANNED_EPILOGUE=running did not take the walk with the exit")
    main_launches["planned_intersect"] = got["planned_intersect"]
    check_golden(LARGE["20k"], GOLDEN_20K)
    a0 = walk_args(tables, *states[0])
    frame20 = frame_fn(dev, static, cam, cfg, base_key, device)
    profiled["20k mesh, 'auto' (the lane-best planned walk #5)"] = (
        frame20, "ptt_planned_lanebest_kernel")
    _, alive20 = frame20()
    paths_t = {
        "planned_lanebest_intersect (1 bounce)":
            (lambda: mxu.planned_lanebest_intersect(*a0), 20),
        "planned_intersect (1 bounce)": (lambda: mxu.planned_intersect(*a0), 20),
        "plain walk_plain (1 bounce)": (lambda: mxu.walk_plain(*a0), 1),
        "plan prepass build_tile_plan (1 bounce)": (lambda: mxu.build_tile_plan(
            tables.tile_aabb, *mxu.plan_rays(tables, a0[1], a0[2], a0[3], a0[4])), 5),
        "20k frame (Renderer default path)": (frame20, 3),
    }
    rounds = {k: (1 if "plain" in k else TIMING_ROUNDS) for k in paths_t}
    rays20 = float(n + alive20.sum().item())
    ms = log_times("10e", smi, time_paths(paths_t, rounds), paths_t, rounds,
                   {"20k frame (Renderer default path)": rays20})
    log(f"    host reads in one 20k frame: {host_syncs(frame20)}")
    b5 = walk_bound(a0, mxu.planned_lanebest_intersect(*a0)[0])
    log(f"    bounds: each planned walk {b5[0]:.4f} ms ({b5[1]}; {b5[2]} (ray, tile) pairs whose "
        f"entry is no farther than the ray's hit, of {int(a0[3].sum())} live rays)")
    for k in ("planned_lanebest_intersect", "planned_intersect"):
        entries[k] = dict(ms=ms[f"{k} (1 bounce)"], plain_ms=ms["plain walk_plain (1 bounce)"],
                          bound=b5)
    del states, a0

    # -- 11. streamed, cornell_mesh_80k.json and cornell_mesh_500k.json ------
    log("[11] streamed walk (#7):")
    scene, dev, static, cam = setup("80k")
    tables, n, depth = dev.mxu_mesh, static.pixel_count, static.trace_depth
    states = sorted_bounces(dev, static, cam, cfg, device, bounces=depth)
    STATES["80k"] = states
    check_walks("11a", ("streamed",), states, tables)
    per_bounce("11a", states, 10)
    frame = lambda c, plain=False: megakernel_iteration(
        dev, static, c, cam, film_ops.new_film(n, device), 1, base_key, plain=plain)
    film_s, alive_s = frame(cfg)
    film_u, alive_u = frame(RenderConfig(ray_sorting="off"))
    film_p, alive_p = frame(cfg, plain=True)
    torch.cuda.synchronize()
    log("[11b] one 80k frame, kernel path vs megakernel_iteration(plain=True):")
    r_frame = compare_films("sorted kernel path vs plain", film_s, film_p)
    sorted_eq = all(torch.equal(a, b) for a, b in zip(film_s, film_u))
    log(f"  sorted and unsorted kernel films bit-identical: {sorted_eq}; alive per depth "
        f"kernel {alive_s.tolist()}, plain {alive_p.tolist()}; film sha256 "
        f"{sha(*film_s)}")
    alive_rel = np.abs(alive_s.cpu().numpy() - alive_p.cpu().numpy()) / np.maximum(
        alive_p.cpu().numpy(), 1)
    if not (sorted_eq and torch.equal(alive_s, alive_u) and r_frame["finite"]
            and r_frame["sum_rel"] <= MAX_SUM_REL and r_frame["pixel_share"] <= MAX_PIXEL_SHARE
            and (alive_rel <= MAX_ALIVE_REL).all()):
        raise AssertionError("the 80k kernel path disagrees with the plain path")
    r, got = drive(scene, 4, counters)
    log(f"[11c] Renderer('{LARGE['80k'].name}') step_many(4) (the slice's main path): "
        f"launches {got}")
    if (got["streamed_intersect"], got["mono_intersect"], got["fused_mesh_shade"]) != (
            4 * depth, 0, 4 * depth):
        raise AssertionError("the 80k Renderer did not take the streamed walk once per bounce")
    main_launches["streamed_intersect"] = got["streamed_intersect"]
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    log(f"    saved {pathlib.Path(r.save(out_dir=str(OUT_DIR))).relative_to(ROOT)}")
    check_golden(LARGE["80k"], GOLDEN_80K)
    a0 = walk_args(tables, *states[0])
    frame80 = frame_fn(dev, static, cam, cfg, base_key, device)
    profiled["80k mesh kernel path, sorted (the slice's main path)"] = (
        frame80, "ptt_streamed_kernel")
    paths_t = {
        "streamed_intersect (1 bounce)": (lambda: mxu.streamed_intersect(*a0), 10),
        "plain walk_plain (1 bounce)": (lambda: mxu.walk_plain(*a0), 1),
        "plan prepass build_tile_plan (1 bounce)": (lambda: mxu.build_tile_plan(
            tables.tile_aabb, *mxu.plan_rays(tables, a0[1], a0[2], a0[3], a0[4])), 5),
        "80k frame (Renderer default path)": (frame80, 3),
    }
    rounds = {k: (1 if "plain" in k else TIMING_ROUNDS) for k in paths_t}
    rays80 = float(n + alive_s.sum().item())
    ms = log_times("11e", smi, time_paths(paths_t, rounds), paths_t, rounds,
                   {"80k frame (Renderer default path)": rays80})
    log(f"    host reads in one 80k frame: {host_syncs(frame80)}")
    b7 = walk_bound(a0, mxu.streamed_intersect(*a0)[0])
    log(f"    bounds: streamed walk {b7[0]:.4f} ms ({b7[1]}; {b7[2]} (ray, tile) pairs whose "
        f"entry is no farther than the ray's hit, of {int(a0[3].sum())} live rays)")
    entries["streamed_intersect"] = dict(ms=ms["streamed_intersect (1 bounce)"],
                                         plain_ms=ms["plain walk_plain (1 bounce)"], bound=b7)
    del states, a0

    scene, dev, static, cam = setup("500k")
    tables, n, depth = dev.mxu_mesh, static.pixel_count, static.trace_depth
    states = sorted_bounces(dev, static, cam, cfg, device, bounces=depth)
    STATES["500k"] = states
    check_walks("11f", ("streamed",), states, tables, blocks=PLAIN_BLOCKS)
    per_bounce("11f", states, 5)
    film_s, alive_s = megakernel_iteration(dev, static, cfg, cam, film_ops.new_film(n, device),
                                           1, base_key)
    film_u, _ = megakernel_iteration(dev, static, RenderConfig(ray_sorting="off"), cam,
                                     film_ops.new_film(n, device), 1, base_key)
    sorted_eq = all(torch.equal(a, b) for a, b in zip(film_s, film_u))
    log(f"[11g] 500k frame: sorted and unsorted kernel films bit-identical: {sorted_eq}; film "
        f"sha256 {sha(*film_s)}")
    if not sorted_eq:
        raise AssertionError("the 500k sorted and unsorted films differ")
    r, got = drive(scene, 2, counters)
    log(f"[11h] Renderer('{LARGE['500k'].name}') step_many(2): launches {got}")
    if (got["streamed_intersect"], got["mono_intersect"]) != (2 * depth, 0):
        raise AssertionError("the 500k Renderer did not take the streamed walk once per bounce")
    a0 = walk_args(tables, *states[0])
    frame500 = frame_fn(dev, static, cam, cfg, base_key, device)
    paths_t = {
        "streamed_intersect, 500k (1 bounce)": (lambda: mxu.streamed_intersect(*a0), 5),
        "plan prepass build_tile_plan, 500k (1 bounce)": (lambda: mxu.build_tile_plan(
            tables.tile_aabb, *mxu.plan_rays(tables, a0[1], a0[2], a0[3], a0[4])), 3),
        "500k frame (Renderer default path)": (frame500, 2),
    }
    rounds = {k: 3 for k in paths_t}
    rays500 = float(n + alive_s.sum().item())
    log_times("11i", smi, time_paths(paths_t, rounds), paths_t, rounds,
              {"500k frame (Renderer default path)": rays500})
    log(f"    host reads in one 500k frame: {host_syncs(frame500)}")
    del states, a0

    # -- 12. binned, cornell_mesh_200k.json --------------------------------
    log("[12] packet-binned traversal (#10, the streamed walk as its fallback):")
    scene, dev, static, cam = setup("200k")
    tables, n, depth = dev.mxu_mesh, static.pixel_count, static.trace_depth
    # All eight sorted bounces for 12a; phases 12b, 12c and 17 take three.
    states = sorted_bounces(dev, static, cam, cfg, device, bounces=depth)
    engaged, b_case = 0, None
    for d, (paths, tl, live) in enumerate(states):
        found = binned_args(mxu, tables, paths, tl, live, cfg.mxu_binned_tiers)
        if found is None:
            log(f"[12a] bounce {d}: no binned tier engages (the streamed walk runs)")
            continue
        args, bins = found
        got_k = mxu.binned_intersect(*args)
        want = mxu.binned_intersect_plain(*args)
        torch.cuda.synchronize()
        tri_bad, t_bad, e = bit_diff(got_k, want)
        log(f"[12a] bounce {d}: binned over the first {args[7] * mxu.BINNED_G} rays, "
            f"{args[5].numel()} visits, {int((want[1] >= 0).sum())} accepted pair rows; pair "
            f"rows with tri differing {tri_bad}, with t not bit-equal {t_bad}")
        if tri_bad or t_bad:
            raise AssertionError("binned_intersect disagrees with its plain version")
        err["binned_intersect"] = max(err["binned_intersect"], e)
        bound = binned_bound(args)
        (ok_rows, rows), members = bound[3], bound[2]
        log(f"[12a] bounce {d}: pair rows {rows}: {members} members of their visit's tile, "
            f"{ok_rows - members} live non-members, {rows - ok_rows} dead, empty slots or "
            "empty visits")
        launch("12a", f"binned_intersect bounce {d}", lambda a=args: mxu.binned_intersect(*a),
               10, bound, args[3], smi)
        engaged += 1
        b_case = b_case or args
    if not engaged:
        raise AssertionError("no bounce of the 200k frame engaged the binned traversal")
    bins_entry = bins_phase("12h", tables, states, cfg, smi)
    states = STATES["200k"] = states[:3]
    check_walks("12b", ("streamed",), states, tables, blocks=PLAIN_BLOCKS)
    traversals_agree("12c", tables, static, states, ("binned", "streamed"))
    prelude = prelude_phase("12f", dev, static, cam, cfg, device, smi,
                            [p for p, _, _ in states])
    shade_bounces("12g", dev, static, cam, cfg, device, smi)
    overflows = mxu._binning.overflows
    r, got = drive(scene, 2, counters)
    overflows = mxu._binning.overflows - overflows
    log(f"[12d] Renderer('{LARGE['200k'].name}') step_many(2): launches {got}, bins that "
        f"overflowed to the streamed walk {overflows}")
    if got["binned_intersect"] == 0 or got["mono_intersect"] or (
            got["binned_intersect"] + got["streamed_intersect"] != 2 * depth):
        raise AssertionError("the 200k Renderer did not take binned (+ streamed) per bounce")
    if got["packet_bins"] != got["binned_intersect"] + overflows:
        raise AssertionError("a binned bounce of the 200k Renderer built no bins by the kernels")
    if (got["fused_mesh_shade"], got["mesh_prelude"]) != (2 * depth, 2):
        raise AssertionError("the 200k Renderer did not take #3 per bounce and the prelude per "
                             "frame")
    main_launches["binned_intersect"] = got["binned_intersect"]
    prelude["launches"] = got["mesh_prelude"]
    bins_entry["launches"] = got["packet_bins"]
    frame200 = frame_fn(dev, static, cam, cfg, base_key, device)
    profiled["200k mesh, 'auto' (the binned visits #10)"] = (frame200, "ptt_binned_kernel")
    _, alive200 = frame200()
    paths_t = {
        "binned_intersect (1 bounce)": (lambda: mxu.binned_intersect(*b_case), 10),
        "plain binned_intersect_plain (1 bounce)":
            (lambda: mxu.binned_intersect_plain(*b_case), 1),
        "200k frame (Renderer default path)": (frame200, 2),
    }
    rounds = {k: (1 if "plain" in k else 3) for k in paths_t}
    ms = log_times("12e", smi, time_paths(paths_t, rounds), paths_t, rounds,
                   {"200k frame (Renderer default path)": float(n + alive200.sum().item())})
    log(f"    host reads in one 200k frame: {host_syncs(frame200)}")
    b10 = binned_bound(b_case)
    log(f"    bounds: binned visits {b10[0]:.4f} ms ({b10[1]}; {b10[2]} candidate pair rows)")
    entries["binned_intersect"] = dict(ms=ms["binned_intersect (1 bounce)"],
                                       plain_ms=ms["plain binned_intersect_plain (1 bounce)"],
                                       bound=b10)

    replaces = {
        "planned_lanebest_intersect": 1330, "planned_intersect": 1231,
        "streamed_intersect": 1499, "binned_intersect": 1848,
    }
    kernels = [{
        "name": k,
        "route": "cuda",
        "source": f"{PKG}/csrc/mesh_walk.cu",
        "replaces": f"project3_cuda_path_tracer_2025_tpu/ops/intersect_mxu.py:{line}",
        "launches": main_launches[k],
        "max_abs_err": err[k],
        "ms": entries[k]["ms"],
        "plain_ms": entries[k]["plain_ms"],
        "bound_ms": entries[k]["bound"][0],
        "bound_by": entries[k]["bound"][1],
        "library_ms": None,
    } for k, line in replaces.items()] + [prelude, bins_entry]
    return kernels, profiled


def bins_phase(tag, tables, states, cfg, smi) -> dict:
    """The packet bins kernels (``packet_bins``, ``csrc/mesh_bins.cu``) on
    every sorted bounce whose live rays a binned tier holds, at that tier's
    prefix and budget: ``src``, ``vt``, ``dst`` and ``overflow`` bit-equal
    to ``packet_bins_plain``'s; each call timed by CUDA events (median of 3
    samples of 10 calls) with its bound (``bins_work``: bytes and slab
    operations), the plain version once.  Returns its entry of the kernels
    line, launches to be filled in."""
    from project3_cuda_path_tracer_2025_tpu_torch.ops import intersect_mxu as mxu

    first = None
    for d, (paths, tl, live) in enumerate(states):
        args = bins_inputs(mxu, tables, paths, tl, live, cfg.mxu_binned_tiers)
        if args is None:
            log(f"[{tag}] bounce {d}: no binned tier engages")
            continue
        before = mxu.packet_bins.launches
        got = mxu.packet_bins(*args)
        want = mxu.packet_bins_plain(*args)
        torch.cuda.synchronize()
        if mxu.packet_bins.launches != before + 1:
            raise AssertionError("packet_bins did not count its launch")
        bad = {k: bits_differ(getattr(got, k), getattr(want, k))
               for k in ("src", "vt", "dst", "overflow")}
        npre, ct = args[4].shape[0], args[0].shape[0]
        log(f"[{tag}] bounce {d}: bins over the first {npre} rays ({int(args[3].sum())} live), "
            f"{ct} tiles, budget {args[5]}, topk {args[6]}: {int((want.vt >= 0).sum())} visits, "
            f"overflow {bool(want.overflow)}; entries differing from packet_bins_plain {bad}")
        if any(bad.values()):
            raise AssertionError("packet_bins disagrees with packet_bins_plain")
        nbytes, ops = bins_work(args, want)
        bound = (*bound_ms(nbytes, ops), ops // OPS_PLAN_PAIR)
        ms = launch(tag, f"packet_bins bounce {d}", lambda a=args: mxu.packet_bins(*a), 10,
                    bound, args[3], smi)
        plain_ms = cuda_time_ms(lambda a=args: mxu.packet_bins_plain(*a), 1)
        log(f"[{tag}] bounce {d}: packet_bins_plain {plain_ms:.4f} ms by events")
        if first is None:
            first = dict(ms=ms, plain_ms=plain_ms, bound=bound)
    if first is None:
        raise AssertionError("no bounce of the 200k frame engaged a binned tier")
    return {
        "name": "packet_bins",
        "route": "cuda",
        "source": f"{PKG}/csrc/mesh_bins.cu",
        "replaces": "none (XLA glue in the JAX package: ops/intersect_mxu.py::_packet_bins)",
        "launches": None,
        "max_abs_err": 0.0,
        "ms": first["ms"],
        "plain_ms": first["plain_ms"],
        "bound_ms": first["bound"][0],
        "bound_by": first["bound"][1],
        "library_ms": None,
    }


def prelude_phase(tag, dev, static, cam, cfg, device, smi, sorted_paths) -> dict:
    """The prelude kernel (bounce 0's t_lim, winner and key, ``mesh_prelude``)
    on a frame's camera rays and on ``sorted_paths`` (sorted bounce states):
    bit-equal to ``mesh_prelude_plain`` in each plane; timed on the camera
    rays (median of 3 samples of 20 launches) with its bound.  Returns its
    entry of the kernels line, launches to be filled in."""
    import dataclasses

    from project3_cuda_path_tracer_2025_tpu_torch.ops import camera as camera_ops
    from project3_cuda_path_tracer_2025_tpu_torch.ops import fused
    from project3_cuda_path_tracer_2025_tpu_torch.utils import prng

    tables, n = dev.mxu_mesh, static.pixel_count
    ct = tables.tile_aabb.shape[0]
    prim_static = dataclasses.replace(static, num_triangles=0)
    ik = prng.iteration_key(prng.prng_key(0), 1)
    cam_paths = camera_ops.generate_camera_rays(
        cam, static.width, static.height, static.trace_depth,
        prng.uniforms_at(prng.stage_key(ik, 0, 0), torch.arange(n, device=device), 4, n))
    args = lambda p: (prim_static, cfg, p, tables)
    for what, p in [("camera rays", cam_paths)] + [
            (f"sorted bounce {d}", q) for d, q in enumerate(sorted_paths)]:
        got = fused.mesh_prelude(*args(p))
        want = fused.mesh_prelude_plain(*args(p))
        torch.cuda.synchronize()
        bad = [bits_differ(a, b) for a, b in zip(got, want)]
        keyed = int((got[1] < (1 << 30)).sum())
        log(f"[{tag}] mesh_prelude on the {what} ({ct} tiles): {int(p.alive.sum())} alive "
            f"rays, {keyed} keyed live; rays whose t_lim, key, winner are not bit-equal to "
            f"mesh_prelude_plain: {bad}")
        if any(bad) or keyed == 0:
            raise AssertionError("the prelude kernel disagrees with its plain version")
    fn = lambda: fused.mesh_prelude(*args(cam_paths))
    fn()
    torch.cuda.synchronize()
    ms = float(np.median([cuda_time_ms(fn, 20) for _ in range(3)]))
    plain_ms = cuda_time_ms(lambda: fused.mesh_prelude_plain(*args(cam_paths)), 1)
    keyed = int((fn()[1] < (1 << 30)).sum())
    # Rays in (6 planes and bounces), t_lim, key and winner out; every ray's
    # prim test and key set-up, and the tile loop of the rays it keys live.
    bound = bound_ms(n * (7 + 3) * 4, n * (prim_ops(prim_static) + OPS_KEY_RAY)
                     + keyed * ct * OPS_KEY_TILE)
    log(f"[{tag}] mesh_prelude on the camera rays: {ms:.4f} ms per launch on {smi} (plain "
        f"{plain_ms:.4f} ms); {keyed} rays keyed live over {ct} tiles; bound {bound[0]:.4f} ms "
        f"({bound[1]}), {bound[0] / ms:.1%} of it")
    return {
        "name": "mesh_prelude",
        "route": "cuda",
        "source": f"{PKG}/csrc/fused_mesh.cu",
        "replaces": "project3_cuda_path_tracer_2025_tpu/ops/intersect.py:156",
        "launches": None,
        "max_abs_err": 0.0,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound[0],
        "bound_by": bound[1],
        "library_ms": None,
    }


# ---------------------------------------------------------------------------
# Phases 13-14: textured scenes (the shade kernel's modes "precomputed" and
# "textured")
# ---------------------------------------------------------------------------

def tex_states(dev, static, cam, cfg, device, mode: str, bounces: int = 4) -> list:
    """Camera rays and the next bounces of a textured scene as the main path
    shades them: [(paths, surface, shade key, winner)], ``surface`` the
    kernel's resolved inputs (mesh_t, normal, material, albedo).  Mode
    "textured" (a textured mesh): each state in coherence order with the
    mesh surface stage and the carried prim winner; mode "precomputed" (a
    textured prim): intersect_scene and textured_surface, no winner.  The
    next state comes from the plain shade."""
    import dataclasses

    from project3_cuda_path_tracer_2025_tpu_torch.ops import camera as camera_ops
    from project3_cuda_path_tracer_2025_tpu_torch.ops import fused, intersect_mxu as mxu
    from project3_cuda_path_tracer_2025_tpu_torch.ops import shade as shade_ops
    from project3_cuda_path_tracer_2025_tpu_torch.ops.compaction import permute_path_state
    from project3_cuda_path_tracer_2025_tpu_torch.ops.intersect import intersect_scene, prim_t_min
    from project3_cuda_path_tracer_2025_tpu_torch.utils import prng
    from project3_cuda_path_tracer_2025_tpu_torch.utils.vec import Vec3

    n = static.pixel_count
    prim_static = dataclasses.replace(static, num_triangles=0)
    ik = prng.iteration_key(prng.prng_key(0), 1)
    paths = camera_ops.generate_camera_rays(
        cam, static.width, static.height, static.trace_depth,
        prng.uniforms_at(prng.stage_key(ik, 0, 0), torch.arange(n, device=device), 4, n))
    out = []
    for d in range(bounces):
        win = None
        if mode == "textured":
            tables = dev.mxu_mesh
            tl, win = prim_t_min(static, cfg, paths.origin, paths.direction, winner=True)
            perm = mxu.coherence_perm(tables, paths.origin, paths.direction, paths.alive, tl,
                                      cfg.ray_sort_bits, cfg.ray_sort_dir_bits, mode="signature")
            paths, (tl, win) = permute_path_state(paths, perm, extra=(tl, win))
            surf = fused.textured_mesh_surface(dev, static, cfg, paths, tl)
        else:
            isect = intersect_scene(dev, static, paths, cfg)
            mid = torch.clamp(isect.material_id, 0, static.num_materials - 1)
            alb, nrm = shade_ops.textured_surface(
                dev, static, isect, mid, Vec3(*(c[mid.long()] for c in dev.materials.color)),
                live=paths.alive & (isect.t > 0.0))
            surf = (isect.t, nrm, isect.material_id, alb)
        skey = prng.stage_key(ik, d, 1)
        out.append((paths, surf, skey, win))
        paths = fused.fused_mesh_shade_plain(prim_static, cfg, paths, *surf[:3], skey, n,
                                             mode=mode, mesh_albedo=surf[3])
    return out


def shade_mode_bound(n: int, live: int, prim_static, mode: str, emit: str, ct: int,
                     keyed: int = None, hits: int = 0) -> tuple:
    """Bound of one mesh-shade launch: every input plane read once (13 in
    mode "plain", whose ``hits`` live mesh-hit lanes read 76 B of their
    winner's row each; 16 and 3 albedo planes in the textured modes), every
    output written once (10, and t_lim and the key with emit); the
    operations of the live rays' prim intersection (none in "precomputed"),
    merge and scatter, of the hits' surface resolve, and with emit the
    scattered rays' prim t and sort key: its set-up on every ray, its tile
    loop on the ``keyed`` rays it keys live (default every ray)."""
    planes = (13 if mode == "plain" else 19) + 10 + (emit != "") + (emit == "tlim+key")
    ops = live * ((0 if mode == "precomputed" else prim_ops(prim_static))
                  + OPS_MERGE + OPS_SCATTER) + hits * OPS_RESOLVE
    if emit:
        ops += n * prim_ops(prim_static)
    if emit == "tlim+key":
        ops += n * OPS_KEY_RAY + (n if keyed is None else keyed) * ct * OPS_KEY_TILE
    return bound_ms(n * planes * 4 + hits * ROW_RESOLVE, ops)


def shade_bounces(tag, dev, static, cam, cfg, device, smi) -> None:
    """The mesh-shade kernel on each of a frame's sorted bounces as the main
    path launches it (``torch_bench_kernels.shade_states``: the carried prim
    winner, the emit the main path asks): bit-equal to its plain version
    given the same winner, and to itself testing every prim; both timed
    (median of 3 samples of 20 launches), with the bound of the function
    (``shade_mode_bound``) and its share."""
    import dataclasses

    from project3_cuda_path_tracer_2025_tpu_torch.ops import fused

    prim_static = dataclasses.replace(static, num_triangles=0)
    ct = dev.mxu_mesh.tile_aabb.shape[0]
    n = static.pixel_count
    for d, (a, kw) in enumerate(shade_states(dev, static, cam, cfg, device, static.trace_depth)):
        every = {k: v for k, v in kw.items() if k != "prim_winner"}
        got = fused.fused_mesh_shade(*a, **kw)
        want = fused.fused_mesh_shade_plain(*a, **kw)
        got_e = fused.fused_mesh_shade(*a, **every)
        torch.cuda.synchronize()
        outs = lambda o: (*shade_outputs(o, a[8]), *(o[1][2:] if a[8] else ()))
        bad = sum(bits_differ(x, y) for x, y in zip(outs(got), outs(want)))
        bad += sum(bits_differ(x, y) for x, y in zip(shade_outputs(got, a[8]),
                                                       shade_outputs(got_e, a[8])))
        if bad:
            raise AssertionError(f"[{tag}] the mesh-shade kernel with the carried winner is not "
                                 f"bit-equal to its plain version, bounce {d}")
        ms = {}
        for what, k in (("carried", kw), ("every prim", every)):
            fn = lambda k=k: fused.fused_mesh_shade(*a, **k)
            fn()
            torch.cuda.synchronize()
            ms[what] = float(np.median([cuda_time_ms(fn, 20) for _ in range(3)]))
        live = int(a[2].alive.sum())
        keyed = int((got[1][1] < (1 << 30)).sum()) if a[8] == "tlim+key" else None
        hits = int(((kw["mesh_tri"] >= 0) & a[2].alive).sum()) if kw["mode"] == "plain" else 0
        b = shade_mode_bound(n, live, prim_static, kw["mode"], a[8], ct, keyed, hits)
        log(f"[{tag}] fused_mesh_shade[{kw['mode']}] sorted bounce {d} (emit "
            f"{a[8] or 'none'}, {ct} tiles, {keyed} rays keyed live): {ms['carried']:.4f} ms "
            "per launch with the carried winner, "
            f"{ms['every prim']:.4f} testing every prim, on {smi}; {live} live rays, {hits} "
            f"resolving a mesh hit; bound "
            f"{b[0]:.4f} ms ({b[1]}), {b[0] / ms['carried']:.1%} of it; bit-equal to the plain "
            "version and to the launch without the winner")


def texture_phases(device, smi: str) -> tuple:
    """Phases 13 (textured prims, mode "precomputed") and 14 (a textured,
    bump-mapped mesh, mode "textured", and its variant with a distinct
    height map) at 800x800, depth 8.  Returns the two modes' entries of the
    kernels line and frames for phase 9."""
    import dataclasses

    from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu_torch.models import megakernel_iteration
    from project3_cuda_path_tracer_2025_tpu_torch.ops import film as film_ops
    from project3_cuda_path_tracer_2025_tpu_torch.ops import fused, intersect_mxu as mxu
    from project3_cuda_path_tracer_2025_tpu_torch.ops import scan
    from project3_cuda_path_tracer_2025_tpu_torch.scene import (
        build_device_scene, camera_state, derive_render_camera, load_scene,
    )
    from project3_cuda_path_tracer_2025_tpu_torch.utils import prng

    cfg = RenderConfig()
    base_key = prng.prng_key(0)
    counters = {c.__name__: c for c in (
        mxu.mono_intersect, fused.fused_mesh_shade, fused.fused_prim_iteration,
        fused.fused_prim_bounce, scan.scan_flat)}
    entries, profiled = [], {}
    for tag, mode, scenes in (("13", "precomputed", (PRIM_TEX,)),
                              ("14", "textured", (MESH_TEX, MESH_BUMP))):
        log(f"[{tag}] textured path, the shade kernel in mode {mode!r}:")
        err, timed, rays = 0.0, {}, {}
        for k, path in enumerate(scenes):
            scene = load_scene(str(path))
            dev, static = build_device_scene(scene, device)
            cam = camera_state(derive_render_camera(scene.state.camera))
            n, depth = static.pixel_count, static.trace_depth
            prim_static = dataclasses.replace(static, num_triangles=0)
            ms = static.material_consts
            single = all(m.texture_id < 0 or m.bump_id < 0 or m.texture_id == m.bump_id
                         for m in ms)
            ct = dev.mxu_mesh.tile_aabb.shape[0]
            emit = "tlim+key" if mode == "textured" else ""
            log(f"    {path.name}: {static.num_textures} textures "
                f"{[tuple(d) for d in static.tex_dims]}, {static.num_triangles} triangles in "
                f"{ct} tiles, {static.width}x{static.height} depth {depth}; texel gather: "
                f"{'one packed quad' if single else 'two quads (albedo, gradients)'}")
            # a. the kernel against its plain version, bit for bit
            states = tex_states(dev, static, cam, cfg, device, mode)
            case = None
            for d, (paths, surf, skey, win) in enumerate(states):
                args = (prim_static, cfg, paths, *surf[:3], skey, n, emit)
                # the main path's carried prim winner (textured), none (precomputed)
                kw = dict(tables=dev.mxu_mesh if emit else None, mode=mode,
                          mesh_albedo=surf[3])
                if win is not None:
                    kw.update(prim_winner=win)
                got = fused.fused_mesh_shade(*args, **kw)
                want = fused.fused_mesh_shade_plain(*args, **kw)
                torch.cuda.synchronize()
                (gp, gc), (wp, wc) = (got, want) if emit else ((got, ()), (want, ()))
                fk = [*gp.origin, *gp.direction, *gp.color, gp.bounces, *gc]
                fp = [*wp.origin, *wp.direction, *wp.color, wp.bounces, *wc]
                bad = sum(bits_differ(a, b) for a, b in zip(fk, fp))
                tex_lanes = int((surf[2] >= 0).sum()) if mode == "textured" else int(
                    (paths.alive & (surf[0] > 0)).sum())
                log(f"[{tag}a] bounce {d}: {int(paths.alive.sum())} alive rays, {tex_lanes} "
                    f"{'mesh hits' if mode == 'textured' else 'hits'}; output values not "
                    f"bit-equal to the plain version: {bad}")
                if bad:
                    raise AssertionError(f"the mesh-shade kernel in mode {mode!r} is not "
                                         "bit-equal to its plain version")
                err = max(err, max(float((a.float() - b.float()).abs().max()) for a, b in zip(fk, fp)))
                case = case or (args, kw)
            # b. one frame: the kernel path against the plain path
            frame = lambda c, plain=False: megakernel_iteration(
                dev, static, c, cam, film_ops.new_film(n, device), 1, base_key, plain=plain)
            film_k, alive_k = frame(cfg)
            film_p, alive_p = frame(cfg, plain=True)
            torch.cuda.synchronize()
            log(f"[{tag}b] one frame, kernel path vs megakernel_iteration(plain=True):")
            r_frame = compare_films("kernel path vs plain", film_k, film_p)
            alive_rel = np.abs(alive_k.cpu().numpy() - alive_p.cpu().numpy()) / np.maximum(
                alive_p.cpu().numpy(), 1)
            checks = [r_frame["finite"], r_frame["sum_rel"] <= MAX_SUM_REL,
                      r_frame["pixel_share"] <= MAX_PIXEL_SHARE, (alive_rel <= MAX_ALIVE_REL).all()]
            if mode == "textured":
                film_u, _ = frame(RenderConfig(ray_sorting="off"))
                sorted_eq = all(torch.equal(a, b) for a, b in zip(film_k, film_u))
                log(f"  sorted and unsorted kernel films bit-identical: {sorted_eq}")
                checks.append(sorted_eq)
            if not all(checks):
                raise AssertionError(f"the textured kernel path disagrees on {path.name}")
            # c. the main path, counters reset
            r, got = drive(scene, 4, counters)
            log(f"[{tag}c] Renderer('{path.name}') step_many(4): launches {got}")
            if (got["fused_mesh_shade"], got["mono_intersect"], got["fused_prim_iteration"],
                    got["fused_prim_bounce"]) != (4 * depth, 4 * depth, 0, 0):
                raise AssertionError(f"the {path.name} Renderer did not take the shade "
                                     "kernel and the traversal once per bounce")
            if k == 0:
                entries.append(dict(name=f"fused_mesh_shade[{mode}]",
                                    launches=got["fused_mesh_shade"], max_abs_err=err))
                OUT_DIR.mkdir(parents=True, exist_ok=True)
                log(f"    saved {pathlib.Path(r.save(out_dir=str(OUT_DIR))).relative_to(ROOT)}")
            check_golden(path, ROOT / "tests" / "torch_goldens" / f"{TEX_GOLDENS[path]}.npz")
            # d. timing
            fr = frame_fn(dev, static, cam, cfg, base_key, device)
            fname = f"{path.stem} frame (Renderer default path)"
            timed[fname] = (fr, 3)
            rays[fname] = float(n + alive_k.sum().item())
            if k == 0:
                args, kw = case
                timed[f"mesh-shade kernel, {mode} (1 bounce)"] = (
                    lambda: fused.fused_mesh_shade(*args, **kw), 20)
                timed[f"plain mesh shade, {mode} (1 bounce)"] = (
                    lambda: fused.fused_mesh_shade_plain(*args, **kw), 1)
                live = int(args[2].alive.sum())
                entries[-1]["bound"] = shade_mode_bound(n, live, prim_static, mode, emit, ct)
                log(f"    bound of one {mode} launch (bounce 0): {entries[-1]['bound'][0]:.4f} "
                    f"ms ({entries[-1]['bound'][1]}; {live} live rays)")
                profiled[f"{path.stem} (textured, kernel path)"] = (
                    fr, "ptt_mesh_shade_kernel")
            if k == 0 and mode == "textured":
                # e. every sorted bounce, with the carried winner
                shade_bounces(f"{tag}e", dev, static, cam, cfg, device, smi)
        rounds = {k: (1 if "plain" in k else 3) for k in timed}
        ms = log_times(f"{tag}d", smi, time_paths(timed, rounds), timed, rounds, rays)
        entries[-1]["ms"] = ms[f"mesh-shade kernel, {mode} (1 bounce)"]
        entries[-1]["plain_ms"] = ms[f"plain mesh shade, {mode} (1 bounce)"]
        log(f"    host reads in one frame: {host_syncs(profiled[f'{scenes[0].stem} (textured, kernel path)'][0])}")
    kernels = [{
        "name": e["name"],
        "route": "cuda",
        "source": f"{PKG}/csrc/fused_mesh.cu",
        "replaces": "project3_cuda_path_tracer_2025_tpu/ops/fused.py:201",
        "launches": e["launches"],
        "max_abs_err": e["max_abs_err"],
        "ms": e["ms"],
        "plain_ms": e["plain_ms"],
        "bound_ms": e["bound"][0],
        "bound_by": e["bound"][1],
        "library_ms": None,
    } for e in entries]
    return kernels, profiled


# ---------------------------------------------------------------------------
# Phase 15: the wavefront integrator and the scan kernel (csrc/scan.cu)
# ---------------------------------------------------------------------------

def wavefront_phases(device, smi: str) -> tuple:
    """Phase 15: the scan kernels against torch.cumsum and their plain
    version (exact on int32), one exclusive_scan timed against
    torch.cumsum with its device launches and host reads counted and its
    host cost split, the radix sort against a stable argsort, and
    ``Renderer(integrator="wavefront")`` on cornell_dof.json (every
    compaction policy, with and without material sorting),
    cornell_mesh_5k.json and the textured mesh: each film bit-identical to
    the megakernel's unfused film, beside the megakernel kernel path's.
    Returns the scan kernel's entry of the kernels line and frames for
    phase 9."""
    from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer
    from project3_cuda_path_tracer_2025_tpu_torch.ops import scan
    from project3_cuda_path_tracer_2025_tpu_torch.scene import load_scene

    log("[15] wavefront integrator and the scan kernel (#12):")
    g = torch.Generator(device=device).manual_seed(0)
    # a. the kernel path of the scan against torch.cumsum: exact on integers
    for n in (640_000, scan.TILE * 39 + 1):
        flags = (torch.rand(n, generator=g, device=device) > 0.5).to(torch.int32)
        ramp = torch.arange(n, device=device, dtype=torch.int32) % 5
        for name, x in (("0/1 flags", flags), ("int ramp", ramp)):
            ex = scan.exclusive_scan(x)
            inc = scan.inclusive_scan(x)
            want = torch.cumsum(x, 0, dtype=torch.int32)
            bad = int((ex != want - x).sum()) + int((inc != want).sum())
            log(f"[15a] N={n} {name}: scan elements differing from torch.cumsum: {bad}")
            if bad:
                raise AssertionError("the scan kernel path disagrees with torch.cumsum")
        xf = torch.rand(n, generator=g, device=device)
        got = scan.inclusive_scan(xf).double()
        ref = torch.cumsum(xf.double(), 0)
        lib = torch.cumsum(xf, 0).double()
        rel = float(((got - ref).abs() / ref.clamp_min(1.0)).max())
        rel_lib = float(((lib - ref).abs() / ref.clamp_min(1.0)).max())
        log(f"[15a] N={n} float32 U[0,1): max relative error vs a float64 cumsum {rel:.3e} "
            f"(torch.cumsum in float32: {rel_lib:.3e}); bar 1e-5")
        if rel > 1e-5:
            raise AssertionError("the float scan is outside its tolerance")
    # the kernels against their plain version on both dtypes, one tile and many
    err = 0.0
    for n in (640_000, scan.KERNEL_TILE * 7 + 5, 1000):
        xi = torch.randint(0, 3, (n,), generator=g, device=device, dtype=torch.int32)
        xf = torch.rand(n, generator=g, device=device)
        for inclusive in (False, True):
            bad = bits_differ(scan.scan_flat(xi, inclusive), scan.scan_flat_plain(xi, inclusive))
            got = scan.scan_flat(xf, inclusive).double()
            ref = scan.scan_flat_plain(xf.double(), inclusive)
            rel = float(((got - ref).abs() / ref.abs().clamp_min(1.0)).max())
            err = max(err, float((got - scan.scan_flat_plain(xf, inclusive).double()).abs().max()))
            log(f"[15a] scan_flat N={n} {'inclusive' if inclusive else 'exclusive'}: int32 "
                f"elements differing from scan_flat_plain {bad}; float32 max relative error vs "
                f"a float64 scan {rel:.3e} (bar 1e-5)")
            if bad or rel > 1e-5:
                raise AssertionError("the scan kernels disagree with their plain version")
    keys = torch.randint(0, 64, (640_000,), generator=g, device=device, dtype=torch.int32)
    perm = scan.radix_sort_permutation(keys, num_bits=6)
    same = torch.equal(perm.long(), torch.argsort(keys, stable=True))
    log(f"[15b] radix_sort_permutation (6 bits, 640,000 keys) equals stable argsort: {same}")
    if not same:
        raise AssertionError("the radix sort disagrees with a stable argsort")

    # c. wavefront frames against the megakernel's
    configs = [("compaction", dict(stream_compaction=True)),
               ("adaptive", dict(stream_compaction="adaptive")),
               ("no compaction", dict(stream_compaction=False)),
               ("compaction+sort", dict(stream_compaction=True, material_sorting=True)),
               ("adaptive+sort", dict(stream_compaction="adaptive", material_sorting=True)),
               ("no compaction+sort", dict(stream_compaction=False, material_sorting=True))]
    runs = [(SCENE, configs), (MESH_SCENE, configs[:1]), (MESH_TEX, configs[:1])]
    timed, rays, profiled, main_launches = {}, {}, {}, None
    for path, cfgs in runs:
        scene = load_scene(str(path))
        ref = Renderer(scene, RenderConfig(fused_bounce="off"))
        ref.step_many(1)
        fast = Renderer(scene, RenderConfig())
        fast.step_many(1)
        depth = ref.static.trace_depth
        for name, kw in cfgs:
            scan.scan_flat.launches = 0
            wf = Renderer(scene, RenderConfig(integrator="wavefront", **kw))
            wf.step_many(1)
            torch.cuda.synchronize()
            launches = scan.scan_flat.launches
            same = all(torch.equal(a, b) for a, b in zip(wf.film, ref.film))
            log(f"[15c] {path.name} wavefront ({name}): scan launches {launches}, alive "
                f"{wf._alive_counts.tolist()}; film bit-identical to the unfused megakernel "
                f"film: {same}")
            r_fast = compare_films("vs the megakernel kernel path", wf.film, fast.film)
            if not same or not r_fast["finite"] or r_fast["sum_rel"] > MAX_SUM_REL \
                    or r_fast["pixel_share"] > MAX_PIXEL_SHARE:
                raise AssertionError(f"the wavefront film of {path.name} ({name}) disagrees")
            if kw.get("stream_compaction") is True and launches != 2 * depth:
                raise AssertionError("a compacting wavefront frame did not launch the scan "
                                     "kernel twice per bounce")
            if path == SCENE and name == "compaction":
                main_launches = launches

            def fn(r=wf):
                r.step_many(1, sync=False)
            key = f"{path.stem} wavefront ({name})"
            timed[key] = (fn, 2)
            rays[key] = float(wf.static.pixel_count + wf._alive_counts.sum())
            if name in ("compaction", "adaptive"):
                log(f"    host reads in one {path.stem} wavefront frame ({name}): "
                    f"{host_syncs(fn)}")
            if path == SCENE and name == "compaction":
                profiled[f"{path.stem} wavefront (compaction)"] = (fn, "ptt_scan_kernel")
    rounds = {k: 3 for k in timed}
    log_times("15d", smi, time_paths(timed, rounds), timed, rounds, rays)

    # e. one exclusive_scan at a compacting bounce's shape: the kernels, the
    # plain version and the one torch call of the same function, by events
    # and on the device; the wrapper's host cost split into its steps
    x = (torch.rand(640_000, generator=g, device=device) > 0.5).to(torch.int32)
    want = torch.cumsum(x, 0, dtype=torch.int32)
    if not (torch.equal(scan.exclusive_scan(x), want - x)
            and torch.equal(scan.inclusive_scan(x), want)):
        raise AssertionError("exclusive_scan / inclusive_scan of int32 flags are not exact")
    t = {
        "exclusive_scan, kernels (1 call)": (lambda: scan.exclusive_scan(x), 50),
        "inclusive_scan, kernels (1 call)": (lambda: scan.inclusive_scan(x), 50),
        "plain exclusive_scan_jnp (1 call)": (lambda: scan.exclusive_scan_jnp(x), 50),
        "library torch.cumsum(x, 0) (1 call)":
            (lambda: torch.cumsum(x, 0, dtype=torch.int32), 50),
    }
    rounds = {k: TIMING_ROUNDS for k in t}
    ms = log_times("15e", smi, time_paths(t, rounds), t, rounds, {})
    dev_ms = {}
    for name in t:
        busy, wall, count, _ = device_busy(t[name][0], 50)
        dev_ms[name] = busy
        log(f"    {name}: device time {busy:.4f} ms per call under the profiler "
            f"({count:.0f} device launches per call)")
        if name.startswith("exclusive_scan") and count > 2:
            raise AssertionError(f"exclusive_scan took {count} device launches, not <= 2")
    syncs = host_syncs(lambda: scan.exclusive_scan(x))
    log(f"    host reads in one exclusive_scan: {syncs}")
    if not syncs.startswith("0 "):
        raise AssertionError("exclusive_scan reads the device")
    scan_host_split(x)
    bound = bound_ms(x.numel() * 8, 0)
    log(f"    bound of one scan of {x.numel()} int32 elements: {bound[0]:.4f} ms ({bound[1]}; "
        f"each element read once and its prefix written once); exclusive_scan at "
        f"{bound[0] / ms['exclusive_scan, kernels (1 call)']:.1%} of it by events, "
        f"{bound[0] / dev_ms['exclusive_scan, kernels (1 call)']:.1%} on the device")
    return [{
        "name": "scan_flat",
        "route": "cuda",
        "source": f"{PKG}/csrc/scan.cu",
        "replaces": "project3_cuda_path_tracer_2025_tpu/ops/scan.py:75",
        "launches": main_launches,
        "max_abs_err": err,
        "ms": ms["exclusive_scan, kernels (1 call)"],
        "plain_ms": ms["plain exclusive_scan_jnp (1 call)"],
        "bound_ms": bound[0],
        "bound_by": bound[1],
        "library_ms": ms["library torch.cumsum(x, 0) (1 call)"],
    }], profiled


def scan_host_split(x, calls: int = 10_000) -> None:
    """The host cost of one ``scan_flat`` call split into its steps, each
    timed alone over ``calls`` calls with ``time.perf_counter`` (the launch
    step enqueues the two kernels; one synchronisation after the loop)."""
    from project3_cuda_path_tracer_2025_tpu_torch.ops import kernels, scan

    n, device = x.shape[0], x.device
    tiles = (n + scan.KERNEL_TILE - 1) // scan.KERNEL_TILE
    buf = torch.empty((n + tiles,), dtype=x.dtype, device=device)
    lib = kernels.load("scan")
    args = (x.data_ptr(), buf.data_ptr(), buf.data_ptr() + 4 * n, n, 0, 0)
    steps = {
        "checks (check_flat)": lambda: scan.check_flat(x),
        "torch.empty of the output and totals": lambda: torch.empty(
            (n + tiles,), dtype=x.dtype, device=device),
        "kernels.load('scan')": lambda: kernels.load("scan"),
        "kernels.stream_handle (raw handle)": lambda: kernels.stream_handle(device),
        "torch.cuda.current_stream(device).cuda_stream (before)":
            lambda: torch.cuda.current_stream(device).cuda_stream,
        "ctypes launch (two kernels)": lambda: lib.lib.ptt_launch_scan(
            *args, kernels.stream_handle(device)),
        "the whole scan_flat call": lambda: scan.scan_flat(x, False),
    }
    log(f"[15e] host cost of one scan_flat call, split ({calls} calls each, "
        "time.perf_counter, us per call):")
    for name, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us = (time.perf_counter() - t0) * 1e6 / calls
        torch.cuda.synchronize()
        log(f"    {name:56s} {us:8.3f} us")


# ---------------------------------------------------------------------------
# Phases 16-19: the sweep, the chunked chains, the super-tile walk and the
# plan prepass (csrc/mesh_walk.cu)
# ---------------------------------------------------------------------------

BIG_SEG = (1100, 500)  # torus-knot segments of the mesh beyond 1,024 tiles: 1.1 M triangles


def visit_bound(tables, ro, rd, live, tl, visits, plan_bytes: int, gate_t=None) -> tuple:
    """Bound of one traversal launch over ``visits`` [NB, Ct] (which tiles
    each block takes): the rays read once, ``plan_bytes`` of plan, the
    coefficient rows of the tiles visited, the outputs; operations of the
    rays' features, a member test per (live ray, visited tile) and the
    candidate (ray, tile) pairs x 1,024 triangles.  ``gate_t``: count only
    pairs whose slab entry is no farther than this t per ray (the final
    hit, beyond which no order of tiles needs a pair)."""
    from project3_cuda_path_tracer_2025_tpu_torch.ops import intersect_mxu as mxu

    n = ro.x.shape[0]
    block = torch.arange(n, device=live.device) // mxu.RAY_TILE
    rf = mxu._features(tables, ro, rd)
    pairs = tests = tiles = 0
    for c, row in enumerate(tables.tile_aabb.tolist()):
        seen = live & visits[block, c]
        member, s_tlo, _ = mxu._member_slab(row, rf.os, rf.inv, tl)
        take = member & seen if gate_t is None else member & seen & (s_tlo <= gate_t)
        took = int(take.sum())
        pairs, tests, tiles = pairs + took, tests + int(seen.sum()), tiles + (took > 0)
    nbytes = n * (6 * 4 + 1 + 4 + 8) + plan_bytes + tables.tile_aabb.numel() * 4 \
        + tiles * mxu.TRI_TILE * mxu.COEF_W * 4
    ops = int(live.sum()) * OPS_WALK_RAY + tests * OPS_MONO_TILE \
        + pairs * mxu.TRI_TILE * OPS_MONO_PAIR
    return bound_ms(nbytes, ops) + (pairs,)


def write_big_mesh() -> pathlib.Path:
    """A (2,3) torus knot of BIG_SEG segments (1.1 M triangles; the formula
    of the repo's asset generator) as an OBJ, and a copy of
    cornell_mesh_500k.json that names it, under build/chip_smoke/."""
    seg_u, seg_v = BIG_SEG
    us = np.linspace(0, 2 * np.pi, seg_u, endpoint=False)
    c = np.stack([np.cos(2 * us) * (2 + np.cos(3 * us)), np.sin(2 * us) * (2 + np.cos(3 * us)),
                  np.sin(3 * us)], 1)
    tangent = np.roll(c, -1, 0) - np.roll(c, 1, 0)
    tangent /= np.linalg.norm(tangent, axis=1, keepdims=True)
    n1 = np.cross(tangent, np.asarray([0.0, 0.0, 1.0]))
    n1 /= np.maximum(np.linalg.norm(n1, axis=1, keepdims=True), 1e-9)
    n2 = np.cross(tangent, n1)
    vs = np.linspace(0, 2 * np.pi, seg_v, endpoint=False)
    verts = (c[:, None, :] + 0.35 * (np.cos(vs)[None, :, None] * n1[:, None, :]
                                     + np.sin(vs)[None, :, None] * n2[:, None, :]))
    verts = verts.reshape(-1, 3) / 3.0
    i, j = np.meshgrid(np.arange(seg_u), np.arange(seg_v), indexing="ij")
    a, b = i * seg_v + j, ((i + 1) % seg_u) * seg_v + j
    c2, d = ((i + 1) % seg_u) * seg_v + (j + 1) % seg_v, i * seg_v + (j + 1) % seg_v
    faces = np.stack([np.stack([a, b, c2], -1), np.stack([a, c2, d], -1)], 2).reshape(-1, 3) + 1
    (OUT_DIR / "obj").mkdir(parents=True, exist_ok=True)
    with open(OUT_DIR / "obj" / "knot_big.obj", "w") as f:
        np.savetxt(f, verts, fmt="v %.6f %.6f %.6f")
        np.savetxt(f, faces, fmt="f %d %d %d")
    spec = json.loads(LARGE["500k"].read_text())
    for obj in spec["Objects"]:
        if obj["TYPE"] == "obj":
            obj["PATH"] = "obj/knot_big.obj"
    spec["Camera"]["FILE"] = "cornell_mesh_big"
    path = OUT_DIR / "cornell_mesh_big.json"
    path.write_text(json.dumps(spec))
    return path


def slice5_phases(device, smi: str) -> tuple:
    """Phases 16 (the sweep, #9), 17 (the chunked chains and a mesh beyond
    1,024 tiles), 18 (the super-tile streamed walk, #8) and 19 (the plan
    prepass, #11), all at 800x800, depth 8, on the scenes phases 10-12
    loaded.  Returns the three kernels' entries of the kernels line and
    frames for phase 9."""
    from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu_torch.models import megakernel_iteration
    from project3_cuda_path_tracer_2025_tpu_torch.ops import film as film_ops
    from project3_cuda_path_tracer_2025_tpu_torch.ops import fused, intersect_mxu as mxu
    from project3_cuda_path_tracer_2025_tpu_torch.ops.intersect import mesh_intersect_brute
    from project3_cuda_path_tracer_2025_tpu_torch.scene import (
        build_device_scene, camera_state, derive_render_camera, load_scene,
    )
    from project3_cuda_path_tracer_2025_tpu_torch.utils import prng

    cfg = RenderConfig()
    base_key = prng.prng_key(0)
    counters = {c.__name__: c for c in (
        mxu.mono_intersect, mxu.planned_lanebest_intersect, mxu.planned_intersect,
        mxu.streamed_intersect, mxu.binned_intersect, mxu.sweep_intersect,
        mxu.streamed_super_intersect, mxu.plan_prepass, fused.fused_mesh_shade)}
    err = {"sweep_intersect": 0.0, "streamed_super_intersect": 0.0, "plan_prepass": 0.0}
    main_launches, entries, profiled = {}, {}, {}

    def one_frame(name, c, **env):
        _, dev, static, cam = LOADED[name]
        with env_set(**env):
            out = megakernel_iteration(dev, static, c, cam,
                                       film_ops.new_film(static.pixel_count, device), 1, base_key)
        torch.cuda.synchronize()
        return out

    def same_film(tag, got, want):
        same = all(torch.equal(a, b) for a, b in zip(got[0], want[0])) \
            and torch.equal(got[1], want[1])
        log(f"[{tag}] film and alive counts bit-identical to the 'auto' frame: {same}")
        if not same or not bool(torch.isfinite(got[0].x).all()) or not float(got[0].x.sum()) > 0:
            raise AssertionError(f"[{tag}] the frame differs from the 'auto' frame")

    # -- 16. the sweep -------------------------------------------------------
    log("[16] the sweep (#9: every tile in ascending id, no plan; the block schedule):")
    scene20, dev, static, cam = LOADED["20k"]
    tables, n, depth = dev.mxu_mesh, static.pixel_count, static.trace_depth
    every = lambda tab, k: torch.ones((-(-k // mxu.RAY_TILE), tab.tile_aabb.shape[0]),
                                      dtype=torch.bool, device=device)
    for d, (paths, tl, live) in enumerate(STATES["20k"]):
        a = walk_args(tables, paths, tl, live)
        sargs = a[:5] + (a[6],)
        got = mxu.sweep_intersect(*sargs)
        want = mxu.sweep_intersect_plain(*sargs)
        others = {k: mxu.WALKS[k](*a) for k in ("planned", "streamed")}
        torch.cuda.synchronize()
        tri_bad, t_bad, e = bit_diff(got, want)
        vs = {k: bit_diff(got, o)[:2] for k, o in others.items()}
        log(f"[16a] sweep_intersect bounce {d}: {int(live.sum())} live of {n} rays, "
            f"{int((want[1] >= 0).sum())} mesh hits; rays with tri differing from the plain "
            f"version {tri_bad}, with t not bit-equal {t_bad}; against the planned and streamed "
            f"kernels (tri, t): {vs}")
        if tri_bad or t_bad or any(x or y for x, y in vs.values()) or not int((want[1] >= 0).sum()):
            raise AssertionError("sweep_intersect disagrees")
        err["sweep_intersect"] = max(err["sweep_intersect"], e)
        launch("16a", f"sweep_intersect 20k bounce {d}", lambda: mxu.sweep_intersect(*sargs), 20,
               visit_bound(*sargs[:5], every(tables, n), 0, gate_t=got[0]), live, smi)
    _, dev80, static80, cam80 = LOADED["80k"]
    tab80 = dev80.mxu_mesh
    m = PLAIN_BLOCKS * mxu.RAY_TILE
    for d, (paths, tl, live) in enumerate(STATES["80k"]):
        calls = chain_calls(mxu, "sweep", tab80, static80.mxu_padded_tris, paths.origin,
                            paths.direction, live, tl, 1e-5)
        for i, (_, c) in enumerate(calls):
            cut = lambda v: type(v)(*(x[:m].contiguous() for x in v))
            head = (c[0], cut(c[1]), cut(c[2]), c[3][:m].contiguous(), c[4][:m].contiguous(), c[5])
            got = mxu.sweep_intersect(*c)
            tri_bad, t_bad, e = bit_diff(mxu.sweep_intersect(*head),
                                         mxu.sweep_intersect_plain(*head))
            torch.cuda.synchronize()
            log(f"[16a] 80k bounce {d}, chain call {i} ({c[0].tile_aabb.shape[0]} tiles): "
                f"against the plain version on the first {PLAIN_BLOCKS} blocks, rays with tri "
                f"differing {tri_bad}, with t not bit-equal {t_bad}")
            if tri_bad or t_bad:
                raise AssertionError("sweep_intersect disagrees in the 80k chain")
            err["sweep_intersect"] = max(err["sweep_intersect"], e)
            launch("16a", f"sweep_intersect 80k bounce {d} call {i}",
                   lambda c=c: mxu.sweep_intersect(*c), 10,
                   visit_bound(*c[:5], every(c[0], n), 0, gate_t=got[0]), c[3], smi)
    traversals_agree("16a 80k", tab80, static80, STATES["80k"], ("streamed", "sweep"))
    sweep_cfg = RenderConfig(mxu_traversal="sweep")
    auto20 = one_frame("20k", cfg)
    same_film("16b 20k sweep", one_frame("20k", sweep_cfg), auto20)
    auto80 = one_frame("80k", cfg)
    same_film("16b 80k sweep (chain of 3)", one_frame("80k", sweep_cfg), auto80)
    r, got = drive(scene20, 2, counters, sweep_cfg)
    log(f"[16c] Renderer('{LARGE['20k'].name}', mxu_traversal='sweep') step_many(2): launches {got}")
    if got["sweep_intersect"] != 2 * depth or got["plan_prepass"] or any(
            got[f"{k}_intersect"] for k in ("planned", "planned_lanebest", "streamed", "mono")):
        raise AssertionError("the 20k sweep Renderer did not take the sweep once per bounce")
    main_launches["sweep_intersect"] = got["sweep_intersect"]
    r, got = drive(LOADED["80k"][0], 1, counters, sweep_cfg)
    log(f"[16c] Renderer('{LARGE['80k'].name}', mxu_traversal='sweep') step_many(1): launches {got}")
    if got["sweep_intersect"] != 3 * depth:
        raise AssertionError("the 80k sweep Renderer did not take 3 sweep calls per bounce")
    a0 = walk_args(tables, *STATES["20k"][0])
    s0 = a0[:5] + (a0[6],)
    f20s = frame_fn(dev, static, cam, sweep_cfg, base_key, device)
    f20a = frame_fn(dev, static, cam, cfg, base_key, device)
    f80s = frame_fn(dev80, static80, cam80, sweep_cfg, base_key, device)
    f80a = frame_fn(dev80, static80, cam80, cfg, base_key, device)
    profiled["80k frame, mxu_traversal='sweep' (chain of 3 sweeps a bounce)"] = (
        f80s, "ptt_sweep_kernel")
    paths_t = {
        "sweep_intersect, 20k (1 bounce)": (lambda: mxu.sweep_intersect(*s0), 20),
        "planned_intersect, 20k (1 bounce)": (lambda: mxu.planned_intersect(*a0), 20),
        "plain sweep_intersect_plain, 20k (1 bounce)": (lambda: mxu.sweep_intersect_plain(*s0), 1),
        "20k frame, mxu_traversal='sweep'": (f20s, 3),
        "20k frame, 'auto'": (f20a, 3),
        "80k frame, mxu_traversal='sweep'": (f80s, 2),
        "80k frame, 'auto'": (f80a, 2),
    }
    rounds = {k: (1 if "plain" in k else 3) for k in paths_t}
    rays20, rays80 = (float(n + f[1].sum().item()) for f in (auto20, auto80))
    ms = log_times("16d", smi, time_paths(paths_t, rounds), paths_t, rounds,
                   {k: (rays20 if k.startswith("20k") else rays80) for k in paths_t
                    if "frame" in k})
    log(f"    host reads in one 20k sweep frame: {host_syncs(f20s)}; 'auto': {host_syncs(f20a)}")
    log(f"    host reads in one 80k sweep frame: {host_syncs(f80s)}; 'auto': {host_syncs(f80a)}")
    b9 = visit_bound(*s0[:5], every(tables, n), 0, gate_t=mxu.sweep_intersect(*s0)[0])
    log(f"    bound of one sweep launch: {b9[0]:.4f} ms ({b9[1]}; {b9[2]} (ray, tile) pairs whose "
        f"entry is no farther than the ray's hit, of {int(s0[3].sum())} live rays)")
    entries["sweep_intersect"] = dict(ms=ms["sweep_intersect, 20k (1 bounce)"],
                                      plain_ms=ms["plain sweep_intersect_plain, 20k (1 bounce)"],
                                      bound=b9)

    # -- 17. the chunked chains ------------------------------------------------
    log("[17] the chunked chains (planned: a plan and a walk per chunk of 32 tiles):")
    for d, (paths, tl, live) in enumerate(STATES["80k"]):
        calls = chain_calls(mxu, "planned", tab80, static80.mxu_padded_tris, paths.origin,
                            paths.direction, live, tl, 1e-5)
        for i, (kind, c) in enumerate(calls):
            fn = mxu.WALKS[kind]
            got = fn(*c)
            tri_bad, t_bad, _ = bit_diff(got, mxu.walk_plain(*c))
            torch.cuda.synchronize()
            log(f"[17a] 80k bounce {d}, planned chain call {i} ({fn.__name__}, "
                f"{c[0].tile_aabb.shape[0]} tiles): against walk_plain on all {n} rays, rays "
                f"with tri differing {tri_bad}, with t not bit-equal {t_bad}")
            if tri_bad or t_bad:
                raise AssertionError(f"{fn.__name__} disagrees in the 80k planned chain")
            launch("17a", f"{fn.__name__} 80k bounce {d} call {i}", lambda fn=fn, c=c: fn(*c), 10,
                   walk_bound(c, got[0]), c[3], smi)
    traversals_agree("17a 80k", dev80.mxu_mesh, static80, STATES["80k"][:3],
                     ("streamed", "planned"))
    _, dev200, static200, cam200 = LOADED["200k"]
    traversals_agree("17a 200k", dev200.mxu_mesh, static200, STATES["200k"],
                     ("streamed", "planned"))
    plan_cfg = RenderConfig(mxu_traversal="planned")
    same_film("17b 80k planned (chain of 3)", one_frame("80k", plan_cfg), auto80)
    auto200 = one_frame("200k", cfg)
    same_film("17b 200k planned (chain of 7)", one_frame("200k", plan_cfg), auto200)
    r, got = drive(LOADED["80k"][0], 1, counters, plan_cfg)
    log(f"[17c] Renderer('{LARGE['80k'].name}', mxu_traversal='planned') step_many(1): "
        f"launches {got}")
    if (got["planned_intersect"], got["planned_lanebest_intersect"], got["streamed_intersect"]) \
            != (2 * depth, depth, 0):
        raise AssertionError("the 80k planned Renderer did not walk 3 chunks per bounce")
    f80p = frame_fn(dev80, static80, cam80, plan_cfg, base_key, device)
    profiled["80k frame, mxu_traversal='planned' (chain of 3: #6, #6, #5)"] = (
        f80p, "ptt_planned_kernel")
    f200p = frame_fn(dev200, static200, cam200, plan_cfg, base_key, device)
    f200a = frame_fn(dev200, static200, cam200, cfg, base_key, device)
    paths_t = {"80k frame, mxu_traversal='planned'": (f80p, 2), "80k frame, 'auto'": (f80a, 2),
               "200k frame, mxu_traversal='planned'": (f200p, 2), "200k frame, 'auto'": (f200a, 2)}
    rounds = {k: 3 for k in paths_t}
    rays200 = float(n + auto200[1].sum().item())
    log_times("17d", smi, time_paths(paths_t, rounds), paths_t, rounds,
              {k: (rays80 if k.startswith("80k") else rays200) for k in paths_t})
    log(f"    host reads in one 80k planned frame: {host_syncs(f80p)}; "
        f"in one 200k planned frame: {host_syncs(f200p)}")

    t0 = time.perf_counter()
    big_path = write_big_mesh()
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    big_scene = load_scene(str(big_path))
    big_scene.state.trace_depth = 2  # its frame and states at depth 2: the run's time
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    big_dev, big_static = build_device_scene(big_scene, device)
    big_cam = camera_state(derive_render_camera(big_scene.state.camera))
    LOADED["big"] = (big_scene, big_dev, big_static, big_cam)
    big_ct = big_dev.mxu_mesh.tile_aabb.shape[0]
    log(f"[17e] {big_path.relative_to(ROOT)}: {big_static.num_triangles} triangles in {big_ct} "
        f"tiles (beyond the streamed plan's {mxu.STREAMED_MAX_TILES}); OBJ written in "
        f"{t_write:.1f} s, parsed and its BVH built (native) in {t_load:.1f} s, tables built and "
        f"uploaded in {time.perf_counter() - t0:.1f} s")
    if big_ct <= mxu.STREAMED_MAX_TILES:
        raise AssertionError("the big mesh does not pass the streamed plan's capacity")
    sample = torch.arange(0, n, 97, device=device)  # 6,598 rays of each state
    hits = 0
    for d, (paths, tl, live) in enumerate(sorted_bounces(big_dev, big_static, big_cam, cfg,
                                                         device, bounces=2)):
        for c in counters.values():
            c.launches = 0
        got = mxu.mesh_intersect_mxu(
            big_dev.mxu_mesh, big_static.num_triangles, big_static.mxu_padded_tris, paths.origin,
            paths.direction, paths.alive, tl, cfg.baby_epsilon, compute_uv=False,
            **mxu.traversal_flags("auto", big_static.mxu_padded_tris,
                                  binned_tiers=cfg.mxu_binned_tiers, binned_budget_rays=n))
        m = PLAIN_BLOCKS * mxu.RAY_TILE
        want = mxu.walk_plain(*walk_args(big_dev.mxu_mesh, paths, tl, live, PLAIN_BLOCKS))
        want_tri = torch.where(want[1] >= big_static.num_triangles, -1, want[1])
        tri_bad, t_bad, _ = bit_diff((got.t[:m], got.tri[:m]), (want[0], want_tri))
        cut = lambda v: type(v)(*(x[sample].contiguous() for x in v))
        ref = mesh_intersect_brute(big_dev, big_static, cut(paths.origin), cut(paths.direction),
                                   paths.alive[sample], tl[sample], cfg.baby_epsilon)
        torch.cuda.synchronize()
        both = (ref.tri >= 0) & (got.tri[sample] >= 0)
        miss = int(((ref.tri >= 0) != (got.tri[sample] >= 0)).sum())
        t_err = float((got.t[sample] - ref.t)[both].abs().max()) if bool(both.any()) else 0.0
        hits += int(both.sum())
        chunks = counters["planned_intersect"].launches \
            + counters["planned_lanebest_intersect"].launches
        log(f"[17f] big mesh bounce {d}, 'auto' (streamed -> the planned chain): {chunks} planned "
            f"launches, streamed {counters['streamed_intersect'].launches}; "
            f"{int((got.tri >= 0).sum())} hits; against walk_plain over all {big_ct} tiles on the "
            f"first {PLAIN_BLOCKS} blocks: rays with tri differing {tri_bad}, with t not "
            f"bit-equal {t_bad}; against the brute-force oracle (another arithmetic) on "
            f"{sample.numel()} sampled rays: hit/miss differing {miss}, max |t diff| on "
            f"{int(both.sum())} common hits {t_err:.3g} (bars: 0.5% of the sample, 1e-4)")
        if tri_bad or t_bad or miss > 0.005 * sample.numel() or t_err > 1e-4 \
                or counters["streamed_intersect"].launches or chunks != -(-big_ct // 32):
            raise AssertionError("the mesh beyond 1,024 tiles disagrees with the plain walk")
    if not hits:
        raise AssertionError("[17f] no sampled ray hit the big mesh")
    fbig = frame_fn(big_dev, big_static, big_cam, cfg, base_key, device)
    film_big, alive_big = fbig()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(film_big.x).all()) or not float(film_big.x.sum()) > 0:
        raise AssertionError("the big mesh's film is empty or not finite")
    paths_t = {"big-mesh frame at depth 2, 'auto' (planned chain)": (fbig, 1)}
    log_times("17g", smi, time_paths(paths_t, {k: 2 for k in paths_t}), paths_t,
              {k: 2 for k in paths_t},
              {k: float(n + alive_big.sum().item()) for k in paths_t})
    del big_dev, big_scene, fbig, film_big

    # -- 18. the super-tile streamed walk ---------------------------------------
    log("[18] super-tile streamed walk (#8), PTT_STREAM_SUPER=1:")
    scene500, dev500, static500, cam500 = LOADED["500k"]
    with env_set(PTT_STREAM_SUPER="1"):
        sdev, sstatic = build_device_scene(scene500, device)  # tables padded to whole supers
    stab = sdev.mxu_mesh
    saabb = mxu.super_aabb(stab.tile_aabb)
    log(f"    {LARGE['500k'].name}: tables built with the switch on, "
        f"{dev500.mxu_mesh.tile_aabb.shape[0]} -> {stab.tile_aabb.shape[0]} tiles in "
        f"{saabb.shape[0]} super-tiles; mxu_padded_tris {sstatic.mxu_padded_tris} as before")
    if stab.tile_aabb.shape[0] % mxu.SUPER_TILES or sstatic != static500:
        raise AssertionError("the super-padded tables have the wrong shape")

    def sargs(paths, tl, live, blocks=None):
        full = super_args(mxu, stab, saabb, paths.origin, paths.direction, live, tl, 1e-5)
        if blocks is None:
            return full
        m, cs = blocks * mxu.RAY_TILE, saabb.shape[0]
        cut = lambda v: type(v)(*(x[:m].contiguous() for x in v))
        splan = full[5]
        return (stab, cut(full[1]), cut(full[2]), live[:m].contiguous(), tl[:m].contiguous(),
                mxu.TilePlan(splan.ids[:blocks * cs].contiguous(),
                             splan.tlo[:blocks * cs].contiguous(),
                             splan.cnt[:blocks].contiguous()), 1e-5)

    def super_bound(u):
        visits = mxu._plan_visits(u[5], saabb.shape[0]).repeat_interleave(
            mxu.SUPER_TILES, dim=1)[:, :stab.tile_aabb.shape[0]]
        return visit_bound(*u[:5], visits, u[5].cnt.shape[0] * (saabb.shape[0] * 8 + 4)
                           + saabb.numel() * 4, mxu.streamed_super_intersect(*u, saabb)[0])

    for d, (paths, tl, live) in enumerate(STATES["500k"]):
        cut_args = sargs(paths, tl, live, PLAIN_BLOCKS)
        tri_bad, t_bad, e = bit_diff(mxu.streamed_super_intersect(*cut_args, saabb),
                                     mxu.streamed_super_plain(*cut_args))
        full = sargs(paths, tl, live)
        vs = bit_diff(mxu.streamed_super_intersect(*full, saabb),
                      mxu.streamed_intersect(*walk_args(stab, paths, tl, live)))
        torch.cuda.synchronize()
        log(f"[18a] streamed_super_intersect bounce {d}: against its plain version on the first "
            f"{PLAIN_BLOCKS} blocks, rays with tri differing {tri_bad}, with t not bit-equal "
            f"{t_bad}; against the streamed kernel on all {n} rays ({int(live.sum())} live): "
            f"tri differing {vs[0]}, t not bit-equal {vs[1]}")
        if tri_bad or t_bad or vs[0] or vs[1]:
            raise AssertionError("streamed_super_intersect disagrees")
        err["streamed_super_intersect"] = max(err["streamed_super_intersect"], e)
        launch("18a", f"streamed_super_intersect 500k bounce {d}",
               lambda: mxu.streamed_super_intersect(*full, saabb), 5, super_bound(full), live, smi)
    auto500 = one_frame("500k", cfg)
    with env_set(PTT_STREAM_SUPER="1"):
        sup = megakernel_iteration(sdev, sstatic, cfg, cam500, film_ops.new_film(n, device), 1,
                                   base_key)
        torch.cuda.synchronize()
        same_film("18b 500k super", sup, auto500)
        r, got = drive(scene500, 1, counters)
    log(f"[18c] Renderer('{LARGE['500k'].name}') with PTT_STREAM_SUPER=1, step_many(1): "
        f"launches {got}")
    if (got["streamed_super_intersect"], got["streamed_intersect"]) != (depth, 0):
        raise AssertionError("the 500k Renderer did not take the super walk once per bounce")
    main_launches["streamed_super_intersect"] = got["streamed_super_intersect"]
    u0 = sargs(*STATES["500k"][0])
    w0 = walk_args(stab, *STATES["500k"][0])
    c0 = sargs(*STATES["500k"][0], PLAIN_BLOCKS)
    f500s = with_env(frame_fn(sdev, sstatic, cam500, cfg, base_key, device), PTT_STREAM_SUPER="1")
    f500a = frame_fn(dev500, static500, cam500, cfg, base_key, device)
    profiled["500k frame, PTT_STREAM_SUPER=1 (the super-tile walk)"] = (
        f500s, "ptt_streamed_super_kernel")
    paths_t = {
        "streamed_super_intersect, 500k (1 bounce)":
            (lambda: mxu.streamed_super_intersect(*u0, saabb), 5),
        "streamed_intersect, 500k (1 bounce)": (lambda: mxu.streamed_intersect(*w0), 5),
        f"streamed_super_intersect, first {PLAIN_BLOCKS} blocks":
            (lambda: mxu.streamed_super_intersect(*c0, saabb), 5),
        f"plain streamed_super_plain, first {PLAIN_BLOCKS} blocks":
            (lambda: mxu.streamed_super_plain(*c0), 1),
        "500k frame, PTT_STREAM_SUPER=1": (f500s, 1),
        "500k frame, 'auto' (streamed)": (f500a, 1),
    }
    rounds = {k: (1 if "plain" in k else 3) for k in paths_t}
    rays500 = float(n + auto500[1].sum().item())
    ms = log_times("18d", smi, time_paths(paths_t, rounds), paths_t, rounds,
                   {k: rays500 for k in paths_t if "frame" in k})
    b8 = super_bound(u0)
    log(f"    bound of one super launch on all rays: {b8[0]:.4f} ms ({b8[1]}; {b8[2]} (ray, "
        f"tile) pairs whose entry is no farther than the ray's hit, of {int(u0[3].sum())} live "
        f"rays); the plain version is timed on "
        f"the first {PLAIN_BLOCKS} blocks only")
    entries["streamed_super_intersect"] = dict(
        ms=ms["streamed_super_intersect, 500k (1 bounce)"],
        plain_ms=ms[f"plain streamed_super_plain, first {PLAIN_BLOCKS} blocks"], bound=b8)
    del u0, w0, c0

    # -- 19. the plan prepass ---------------------------------------------------
    log("[19] plan prepass (#11), plan_impl='pallas' / PTT_PLAN_IMPL=pallas:")
    cases, per_bounce = {}, []
    for name, bounces in (("20k", 3), ("80k", 8), ("200k", 1), ("500k", 3)):
        tab = LOADED[name][1].mxu_mesh
        for d, (paths, tl, live) in enumerate(STATES[name][:bounces]):
            pr = mxu.plan_rays(tab, paths.origin, paths.direction, live, tl)
            h, lb = mxu.plan_prepass(tab.tile_aabb, *pr)
            hp, lbp = mxu.plan_prepass_plain(tab.tile_aabb, *pr)
            got = mxu.plan_with_prefix(tab.tile_aabb, *pr, impl="pallas")
            want = mxu.plan_with_prefix(tab.tile_aabb, *pr)
            torch.cuda.synchronize()
            bad = int((h != hp).sum()) + bits_differ(lb, lbp)
            plan_bad = sum(bits_differ(x, y) for x, y in zip(got, want))
            e = float(torch.where(torch.isfinite(lbp), (lb - lbp).abs(),
                                  torch.zeros_like(lb)).max())
            pairs = prepass_pairs(mxu, pr.live)
            ct = h.shape[1]
            log(f"[19a] {name} bounce {d}: (h, lb) over {h.shape[0]} blocks x {ct} tiles "
                f"({int(hp.sum())} candidate pairs): values not bit-equal to the plain version "
                f"{bad}; plan (ids, tlo, cnt) values differing from the torch plan {plan_bad}; "
                f"{pairs['live']} live rays in {pairs['live_blocks']} blocks: (ray, tile) pairs "
                f"tested {pairs['live'] * ct} (the per-block design: "
                f"{pairs['rays_per_block_design'] * ct})")
            if bad or plan_bad or not int(hp.sum()):
                raise AssertionError("plan_prepass disagrees with the torch plan")
            err["plan_prepass"] = max(err["plan_prepass"], e)
            if d == 0:
                cases[name] = (tab.tile_aabb, *pr)
            if name in ("80k", "200k", "500k") and (name == "80k" or d == 0):
                per_bounce.append((name, d, (tab.tile_aabb, *pr), pairs))
    for name, auto in (("20k", auto20), ("80k", auto80)):
        same_film(f"19b {name} PTT_PLAN_IMPL=pallas",
                  one_frame(name, cfg, PTT_PLAN_IMPL="pallas"), auto)
    with env_set(PTT_PLAN_IMPL="pallas"):
        r, got = drive(LOADED["80k"][0], 2, counters)
    log(f"[19c] Renderer('{LARGE['80k'].name}') with PTT_PLAN_IMPL=pallas, step_many(2): "
        f"launches {got}")
    if (got["plan_prepass"], got["streamed_intersect"]) != (2 * depth, 2 * depth):
        raise AssertionError("the 80k Renderer did not take the plan kernel once per bounce")
    main_launches["plan_prepass"] = got["plan_prepass"]
    f20k = with_env(f20a, PTT_PLAN_IMPL="pallas")
    f80k = with_env(f80a, PTT_PLAN_IMPL="pallas")
    profiled["80k frame, PTT_PLAN_IMPL=pallas (the plan kernel)"] = (
        f80k, "ptt_plan_prepass_kernel")
    for name, d, a, pairs in per_bounce:
        ms = float(np.median([cuda_time_ms(lambda a=a: mxu.plan_prepass(*a), 10)
                              for _ in range(5)]))
        dev = device_ms(lambda a=a: mxu.plan_prepass(*a), 20, ("ptt_plan_prepass_kernel",))
        ct = a[0].shape[0]
        b = bound_ms(*prepass_work(mxu, ct, a[3]))
        log(f"[19e] plan_prepass {name} bounce {d}: {ms:.4f} ms per launch by events, "
            f"{on_device(dev)} on the device (torch.profiler), on {smi}; {pairs['live']} live "
            f"rays in {pairs['live_blocks']} blocks x {ct} tiles; bound {b[0]:.4f} ms ({b[1]}), "
            f"{b[0] / (dev or ms):.1%} of the {'device time' if dev else 'time by events'}")
    paths_t = {}
    for name, a in cases.items():
        if name == "200k":
            continue
        paths_t[f"plan_prepass, {name} (1 bounce)"] = (lambda a=a: mxu.plan_prepass(*a), 10)
        paths_t[f"plain plan_prepass_plain, {name} (1 bounce)"] = (
            lambda a=a: mxu.plan_prepass_plain(*a), 2)
        paths_t[f"whole plan, kernel slab stage, {name}"] = (
            lambda a=a: mxu.plan_with_prefix(*a, impl="pallas"), 5)
        paths_t[f"whole plan, torch, {name}"] = (lambda a=a: mxu.plan_with_prefix(*a), 2)
    paths_t.update({"20k frame, PTT_PLAN_IMPL=pallas": (f20k, 3), "20k frame, torch plan": (f20a, 3),
                    "80k frame, PTT_PLAN_IMPL=pallas": (f80k, 2), "80k frame, torch plan": (f80a, 2)})
    rounds = {k: (1 if "plain" in k else 3) for k in paths_t}
    ms = log_times("19d", smi, time_paths(paths_t, rounds), paths_t, rounds,
                   {k: (rays20 if k.startswith("20k") else rays80) for k in paths_t
                    if "frame" in k})
    log(f"    host reads in one 80k frame with the plan kernel: {host_syncs(f80k)}")
    aabb, live = cases["80k"][0], cases["80k"][3]
    b11 = bound_ms(*prepass_work(mxu, aabb.shape[0], live))
    log(f"    bound of one prepass launch (80k, bounce 0): {b11[0]:.4f} ms ({b11[1]}; "
        f"{int(live.sum())} live rays x {aabb.shape[0]} tiles)")
    entries["plan_prepass"] = dict(ms=ms["plan_prepass, 80k (1 bounce)"],
                                   plain_ms=ms["plain plan_prepass_plain, 80k (1 bounce)"],
                                   bound=b11)

    replaces = {"streamed_super_intersect": 1633, "sweep_intersect": 671, "plan_prepass": 946}
    kernels = [{
        "name": k,
        "route": "cuda",
        "source": f"{PKG}/csrc/mesh_walk.cu",
        "replaces": f"project3_cuda_path_tracer_2025_tpu/ops/intersect_mxu.py:{line}",
        "launches": main_launches[k],
        "max_abs_err": err[k],
        "ms": entries[k]["ms"],
        "plain_ms": entries[k]["plain_ms"],
        "bound_ms": entries[k]["bound"][0],
        "bound_by": entries[k]["bound"][1],
        "library_ms": None,
    } for k, line in replaces.items()]
    return kernels, profiled


def prim_phases(device, smi: str) -> tuple:
    """Phases 3-7: the prim path on scenes/cornell_dof.json at 800x800, depth
    8.  Returns the two prim kernels' entries of the kernels line and the
    prim path's frame functions for phase 9."""
    from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer, megakernel_iteration
    from project3_cuda_path_tracer_2025_tpu_torch.ops import fused
    from project3_cuda_path_tracer_2025_tpu_torch.ops import film as film_ops
    from project3_cuda_path_tracer_2025_tpu_torch.scene import (
        build_device_scene, camera_state, derive_render_camera, load_scene,
        set_resolution,
    )
    from project3_cuda_path_tracer_2025_tpu_torch.utils import prng

    # -- 3. RNG: kernel Threefry == plain, bit for bit ----------------------
    n_rng = 640_000
    key = prng.stage_key(prng.iteration_key(prng.prng_key(0), 1), 3, 1)
    u_k = fused.kernel_uniforms(key, n_rng, 4, device)
    u_p = prng.uniforms_at(key, torch.arange(n_rng, device=device), 4, n_rng)
    torch.cuda.synchronize()
    rng_equal = torch.equal(u_k, u_p)
    log(f"[3] RNG: kernel uniforms [4, {n_rng}] bit-identical to plain: {rng_equal}")
    if not rng_equal:
        raise AssertionError("in-kernel Threefry uniforms differ from the plain version")

    # -- 4. bounce kernel vs plain, both uniform forms ------------------------
    bounce_err = 0.0
    for path in (SCENE, SCENE_LOBES):
        scene = load_scene(str(path))
        _, static = build_device_scene(scene, device)
        cfg = RenderConfig()
        cam = camera_state(derive_render_camera(scene.state.camera))
        n = static.pixel_count
        for d, (paths, skey) in enumerate(prim_bounce_states(static, cam, cfg, device, 2)):
            su = prng.uniforms_at(skey, paths.pixel, 3, n)
            out_k = fused.fused_prim_bounce(static, cfg, paths, su)
            out_i = fused.fused_prim_bounce(static, cfg, paths, su_key=skey, rng_n=n)
            out_p = fused.fused_prim_bounce_plain(static, cfg, paths, su)
            torch.cuda.synchronize()
            names = ("ox", "oy", "oz", "dx", "dy", "dz", "r", "g", "b")
            fk = [*out_k.origin, *out_k.direction, *out_k.color]
            fp = [*out_p.origin, *out_p.direction, *out_p.color]
            diffs = {nm: float((a - b).abs().max()) for nm, a, b in zip(names, fk, fp)}
            lane_bad = torch.zeros(n, dtype=torch.bool, device=device)
            for a, b in zip(fk, fp):
                lane_bad |= ~torch.isclose(a, b, rtol=STAGE_RTOL, atol=STAGE_ATOL)
            bn_diff = int((out_k.bounces != out_p.bounces).sum())
            share = float(lane_bad.float().mean())
            not_bits = sum(bits_differ(a, b) for a, b in zip(
                (*fk, out_k.bounces), (*fp, out_p.bounces)))
            forms_differ = sum(bits_differ(a, b) for a, b in zip(
                (*fk, out_k.bounces),
                (*out_i.origin, *out_i.direction, *out_i.color, out_i.bounces)))
            log(f"[4] bounce {d} {path.name} {static.width}x{static.height}: max abs diff "
                + " ".join(f"{k}={v:.3g}" for k, v in diffs.items())
                + f"; lanes with bounces differing: {bn_diff}; lanes outside "
                f"rtol={STAGE_RTOL} atol={STAGE_ATOL}: {share:.5%}; values not bit-equal to "
                f"the plain version {not_bits}; inline draw vs [3, n] form: {forms_differ}")
            if bn_diff / n > MAX_STAGE_LANE_SHARE or share > MAX_STAGE_LANE_SHARE \
                    or not_bits:
                raise AssertionError(
                    f"bounce kernel disagrees with its plain version on {path.name}")
            if forms_differ:
                raise AssertionError("the bounce kernel's inline draw differs from its [3, n] form")
            bounce_err = max(bounce_err, max(diffs.values()))

    # -- 5. iteration kernel vs the plain unfused path, 800x800 depth 8 -----
    scene = load_scene(str(SCENE))
    dev, static = build_device_scene(scene, device)
    cam = camera_state(derive_render_camera(scene.state.camera))
    n, depth = static.pixel_count, static.trace_depth
    base_key = prng.prng_key(0)
    film_k, alive_k = fused.fused_prim_iteration(
        static, RenderConfig(), cam, film_ops.new_film(n, device), 1, base_key)
    film_u, alive_u = megakernel_iteration(
        dev, static, RenderConfig(fused_bounce="off"), cam,
        film_ops.new_film(n, device), 1, base_key)
    film_p, alive_p = fused.fused_prim_iteration_plain(
        static, RenderConfig(), cam, film_ops.new_film(n, device), 1, base_key)
    torch.cuda.synchronize()
    log(f"[5] iteration kernel vs plain, {static.width}x{static.height} depth {depth} seed 0:")
    r_u = compare_films("vs unfused megakernel_iteration (fused_bounce='off')", film_k, film_u)
    r_p = compare_films("vs fused_prim_iteration_plain", film_k, film_p)
    ak, au = alive_k.cpu().numpy(), alive_u.cpu().numpy()
    log(f"  alive per depth: kernel {ak.tolist()}")
    log(f"  alive per depth: plain  {au.tolist()}")
    alive_rel = np.abs(ak - au) / np.maximum(au, 1)
    for r in (r_u, r_p):
        if not (r["finite"] and r["sum_rel"] <= MAX_SUM_REL
                and r["pixel_share"] <= MAX_PIXEL_SHARE):
            raise AssertionError(f"iteration kernel film disagrees with the plain path: {r}")
    if (alive_rel > MAX_ALIVE_REL).any():
        raise AssertionError(f"alive counts differ by more than {MAX_ALIVE_REL:.1%}")

    # -- 6. the main path, counters reset -----------------------------------
    fused.fused_prim_iteration.launches = 0
    fused.fused_prim_bounce.launches = 0
    fused.kernel_uniforms.launches = 0
    r = Renderer(str(SCENE))
    r.step_many(16)
    # The per-bounce twin, as the JAX package's entry() drives it.
    film_b, alive_b = megakernel_iteration(
        r.dev, r.static, r.cfg, r._cam_state, film_ops.new_film(n, device), 1, r._base_key)
    torch.cuda.synchronize()
    launches = {
        "fused_prim_iteration": fused.fused_prim_iteration.launches,
        "fused_prim_bounce": fused.fused_prim_bounce.launches,
    }
    img = r.image()
    log(f"[6] Renderer('{SCENE.name}') step_many(16): iteration {r.iteration}, "
        f"launches {launches}, Threefry kernel launches {fused.kernel_uniforms.launches}, "
        f"film sum {img.sum():.3f}, alive {r._alive_counts.tolist()}")
    if launches["fused_prim_iteration"] != 16:
        raise AssertionError("the Renderer did not take the iteration kernel 16 times")
    if launches["fused_prim_bounce"] != depth:
        raise AssertionError("megakernel_iteration did not take the bounce kernel")
    if fused.kernel_uniforms.launches != 1:
        raise AssertionError("the bounce-kernel frame drew uniforms by the Threefry kernel "
                             "beyond the camera's")
    if img.shape != (static.height, static.width, 3) or not np.isfinite(img).all() \
            or not img.sum() > 0:
        raise AssertionError("main-path film is empty or not finite")
    if not np.isfinite(film_np(film_b)).all() or alive_b.sum() <= 0:
        raise AssertionError("bounce-kernel iteration produced no finite film")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    png = r.save(out_dir=str(OUT_DIR))
    log(f"    saved {pathlib.Path(png).relative_to(ROOT)}")

    # The repo's own check: the committed golden film (32x32, 2 spp, seed 0).
    g = np.load(GOLDEN)
    small = Renderer(set_resolution(load_scene(str(SCENE)), int(g["width"]), int(g["height"])))
    for _ in range(int(g["spp"])):
        small.step()
    got = film_np(small.film)
    want = g["film"]
    outside = ~np.isclose(got, want, rtol=RTOL, atol=ATOL)
    share = float(outside.any(axis=1).mean())
    sum_rel = float(abs(got.sum() - want.sum()) / abs(want.sum()))
    log(f"    golden {GOLDEN.name}: pixels outside rtol={RTOL} atol={ATOL}: {share:.3%}, "
        f"film-sum rel diff {sum_rel:.3e}")
    if not np.isfinite(got).all() or share > 0.01 or sum_rel > 1e-3:
        raise AssertionError("the card's render disagrees with the golden film")

    # -- 7. timing at 800x800 depth 8 ---------------------------------------
    rays = float(n + alive_k.sum().item())
    film_t = film_ops.new_film(n, device)
    it = [0]

    def run_iter_kernel():
        it[0] += 1
        fused.fused_prim_iteration(static, RenderConfig(), cam, film_t, it[0], base_key)

    def run_bounce_path():
        it[0] += 1
        megakernel_iteration(dev, static, RenderConfig(), cam, film_t, it[0], base_key)

    def run_plain():
        it[0] += 1
        megakernel_iteration(dev, static, RenderConfig(fused_bounce="off"), cam, film_t,
                             it[0], base_key)

    def run_iter_plain():
        it[0] += 1
        fused.fused_prim_iteration_plain(static, RenderConfig(), cam, film_t, it[0], base_key)

    # The bounce kernel as the frame launches it: bounce 0, drawing inline.
    b_paths, b_key = next(prim_bounce_states(static, cam, RenderConfig(), device, 1))
    b_live = int((b_paths.bounces > 0).sum())

    def run_bounce_kernel():
        fused.fused_prim_bounce(static, RenderConfig(), b_paths, su_key=b_key)

    def run_bounce_plain():
        fused.fused_prim_bounce_plain(static, RenderConfig(), b_paths, su_key=b_key)

    paths_t = {
        "iteration kernel": (run_iter_kernel, 20),
        "bounce-kernel megakernel": (run_bounce_path, 10),
        "plain unfused torch": (run_plain, 3),
        "plain fused_prim_iteration": (run_iter_plain, 3),
        "bounce kernel (1 bounce)": (run_bounce_kernel, 20),
        "plain bounce (1 bounce)": (run_bounce_plain, 3),
    }
    times = {k: [] for k in paths_t}
    for fn, _ in paths_t.values():
        fn()  # warm-up
    torch.cuda.synchronize()
    order = list(paths_t)
    for rnd in range(TIMING_ROUNDS):  # in turns, the order reversed every round
        for k in (order if rnd % 2 == 0 else order[::-1]):
            fn, reps = paths_t[k]
            times[k].append(cuda_time_ms(fn, reps))
    ms = {k: float(np.median(v)) for k, v in times.items()}
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"[7] timing on {smi} (after the runs: sm clock, power, temperature = {clocks}), "
        f"{static.width}x{static.height} depth {depth}, {rays:.0f} ray segments/frame "
        f"(camera rays + alive after each bounce); median of {TIMING_ROUNDS} samples "
        "[quartiles], each the mean over the calls shown:")
    for k, v in ms.items():
        fn, reps = paths_t[k]
        q1, q3 = np.percentile(times[k], [25, 75])
        per = "per launch" if "1 bounce" in k else "per frame"
        rate = "" if "1 bounce" in k else f", {rays / (v * 1e3):.1f} Mrays/s"
        log(f"    {k:28s} {v:9.4f} ms {per} [{q1:.4f}, {q3:.4f}]{rate}  ({reps} calls/sample)")

    # Bounds of the prim kernels at the shapes timed above.
    live_before = [n] + [int(a) for a in alive_k.tolist()[:-1]]
    it_bound = bound_ms(
        n * 24 + depth * 4,  # film read and written; alive counts
        n * OPS_RAYGEN + sum(live_before) * (prim_ops(static) + OPS_SCATTER),
    )
    b_bound = bounce_bound(static, n, b_live)
    log(f"    bounds: iteration kernel {it_bound[0]:.4f} ms ({it_bound[1]}), "
        f"bounce kernel {b_bound[0]:.4f} ms ({b_bound[1]}; with the [3, n] plane "
        f"{bounce_bound(static, n, b_live, drawn=False)[0]:.4f})")
    # The iteration kernel's lane use, from a counting build of it
    # (-DPTT_COUNT_LANES; the shipped kernel counts nothing), against the
    # per-pixel schedule's on the same paths.
    counting = variant_library(("PTT_COUNT_LANES",))
    use = lane_use(static, RenderConfig(), cam, device, counting)
    log(f"    lane use (live lane-bounces / issued) of one frame: regenerating schedule "
        f"{use['regen_live']} / {use['regen_issued']} = "
        f"{use['regen_live'] / use['regen_issued']:.1%}; the per-pixel schedule "
        f"{use['per_pixel_live']} / {use['per_pixel_issued']} = "
        f"{use['per_pixel_live'] / use['per_pixel_issued']:.1%} (of pixels x depth: "
        f"{use['per_pixel_live'] / (n * depth):.1%})")
    if use["regen_live"] != use["per_pixel_live"]:
        raise AssertionError("the counting build bounced another number of live paths")
    bounce_lines(smi, counting, device)

    kernels_line = [
        {
            "name": "fused_prim_iteration",
            "route": "cuda",
            "source": f"{PKG}/csrc/fused_prim.cu",
            "replaces": "project3_cuda_path_tracer_2025_tpu/ops/fused.py:959",
            "launches": launches["fused_prim_iteration"],
            "max_abs_err": r_p["max_abs"],
            "ms": ms["iteration kernel"],
            "plain_ms": ms["plain fused_prim_iteration"],
            "bound_ms": it_bound[0],
            "bound_by": it_bound[1],
            "library_ms": None,
        },
        {
            "name": "fused_prim_bounce",
            "route": "cuda",
            "source": f"{PKG}/csrc/fused_prim.cu",
            "replaces": "project3_cuda_path_tracer_2025_tpu/ops/fused.py:74",
            "launches": launches["fused_prim_bounce"],
            "max_abs_err": bounce_err,
            "ms": ms["bounce kernel (1 bounce)"],
            "plain_ms": ms["plain bounce (1 bounce)"],
            "bound_ms": b_bound[0],
            "bound_by": b_bound[1],
            "library_ms": None,
        },
    ]
    return kernels_line, {
        "prim iteration kernel (Renderer default)": (run_iter_kernel, "ptt_iteration_kernel"),
        "prim bounce-kernel path": (run_bounce_path, "ptt_bounce_kernel"),
    }


def bounce_bound(static, n: int, live: int, drawn: bool = True) -> tuple:
    """Bound of one bounce-kernel launch over n rays, ``live`` of them live:
    every ray's 9 float planes and bounces read once and written once, the
    live rays' pixels (``drawn``: the uniforms drawn inline, three Threefry
    draws a live ray) or every ray's three uniforms (the [3, n] plane);
    operations of the live rays' prim tests and scatter."""
    ops = live * (prim_ops(static) + OPS_SCATTER + (3 * OPS_UNIFORM if drawn else 0))
    return bound_ms(n * 80 + (live * 4 if drawn else n * 12), ops)


def bounce_lines(smi: str, counting, device) -> None:
    """Phase 7's per-bounce lines of the bounce kernel: on every bounce of
    cornell_dof.json, cornell_all_lobes.json and the 40-primitive scene at
    depth 80 (800x800, iteration 1), both uniform forms bit-equal to the
    plain version; on cornell_dof.json each bounce timed as the frame
    launches it (drawing inline) with its bound share and the lane use of
    the counting build against the per-ray schedule's."""
    from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu_torch.ops import fused
    from project3_cuda_path_tracer_2025_tpu_torch.scene import (
        build_device_scene, camera_state, derive_render_camera,
    )
    from project3_cuda_path_tracer_2025_tpu_torch.utils import prng

    cfg = RenderConfig()
    for name in ("cornell_dof", "cornell_all_lobes", "depth80"):
        scene = iteration_scene(name, 800)
        _, static = build_device_scene(scene, device)
        cam = camera_state(derive_render_camera(scene.state.camera))
        n, depth = static.pixel_count, static.trace_depth
        bad = forms = 0
        for d, (paths, skey) in enumerate(prim_bounce_states(static, cam, cfg, device, depth)):
            want = fused.fused_prim_bounce_plain(static, cfg, paths, su_key=skey)
            got = fused.fused_prim_bounce(static, cfg, paths, su_key=skey)
            given = fused.fused_prim_bounce(static, cfg, paths,
                                            prng.uniforms_at(skey, paths.pixel, 3, n))
            planes = lambda p: (*p.origin, *p.direction, *p.color, p.bounces)
            bad += sum(bits_differ(a, b) for a, b in zip(planes(got), planes(want)))
            forms += sum(bits_differ(a, b) for a, b in zip(planes(got), planes(given)))
            if name != "cornell_dof":
                continue
            live = int((paths.bounces > 0).sum())
            run = lambda: fused.fused_prim_bounce(static, cfg, paths, su_key=skey)
            ms = float(np.median([cuda_time_ms(run, 20) for _ in range(5)]))
            dev = device_ms(run, 20, ("ptt_bounce_kernel",))
            b = bounce_bound(static, n, live)
            use = bounce_lane_use(fused, static, cfg, paths, skey, counting)
            log(f"[7] fused_prim_bounce {name} bounce {d}: {ms:.4f} ms per launch by events, "
                f"{on_device(dev)} on the device (torch.profiler), on {smi}; {live} live rays "
                f"of {n}; bound {b[0]:.4f} ms ({b[1]}), {b[0] / (dev or ms):.1%} of the "
                f"{'device time' if dev else 'time by events'}; "
                f"lane use {use['kernel_live']} / {use['kernel_issued']} = "
                f"{use['kernel_live'] / max(use['kernel_issued'], 1):.1%} (per-ray schedule "
                f"{use['live'] / max(use['per_ray_issued'], 1):.1%})")
            if use["kernel_live"] != live:
                raise AssertionError("the counting build bounced another number of live rays")
        log(f"[7] fused_prim_bounce {name}: {depth} bounces at {static.width}x{static.height}, "
            f"values not bit-equal to the plain version {bad}, inline draw vs the [3, n] "
            f"form {forms}")
        if bad:
            raise AssertionError(f"the bounce kernel is not bit-equal to its plain version "
                                 f"on {name}")
        if forms:
            raise AssertionError("the bounce kernel's inline draw differs from its [3, n] form")


# ---------------------------------------------------------------------------
# Slice 6: the epilogue variants (#13), the prim kernels beyond their old
# capacity, the measuring scripts
# ---------------------------------------------------------------------------

EPILOGUE_K = 24  # timed launches per variant, the measuring script's default


def epilogue_phases(device, smi: str) -> tuple:
    """Phase 20: ``scripts/torch_profile_epilogue.py`` in-process at 800x800 on
    the 5k mesh (mid-bounce population) and the 20k mesh: the script's own
    gate (every exact variant == prod_lanebest on every ray, each new kernel
    == its plain version bit for bit), then its timing.  The launch counters
    are set to 0 just before each script run and read just after.  Returns the
    new kernels' entries of the kernels line (times of the 5k run for the
    mono flavors, of the 20k run, where a plan matters, for lb_asc)."""
    import torch_profile_epilogue as tpe

    from project3_cuda_path_tracer_2025_tpu_torch.ops import intersect_mxu as mxu

    runs = {}
    for tag, path in (("5k", MESH_SCENE), ("20k", LARGE["20k"])):
        log(f"[20] torch_profile_epilogue on {path.name}, 800x800, --check-plain, "
            f"k={EPILOGUE_K} (the floor flavors against their plain version on the first "
            f"{PLAIN_BLOCKS} blocks):")
        mxu.lb_asc_intersect.launches = 0
        mxu.epilogue_mono_intersect.launches = 0
        recs = tpe.run(["--scene", str(path), "--res", "800", "--k", str(EPILOGUE_K),
                        "--check-plain", "--mm-plain-blocks", str(PLAIN_BLOCKS)])
        torch.cuda.synchronize()
        got = (mxu.lb_asc_intersect.launches, mxu.epilogue_mono_intersect.launches)
        runs[tag] = {r["variant"]: r for r in recs}
        want = (2 * (1 + EPILOGUE_K), 3 * (1 + EPILOGUE_K))  # lb_asc + lb_mm; full, gate, mm
        log(f"[20] {path.name}: launches lb_asc_intersect {got[0]}, epilogue_mono_intersect "
            f"{got[1]} (1 check + {EPILOGUE_K} timed per variant)")
        if got != want:
            raise AssertionError(f"the script launched {got}, not {want}")
        for name, r in runs[tag].items():
            if r["exact"] and name != "prod_lanebest" and not r["identical_to_prod_lanebest"]:
                raise AssertionError(f"{name} differs from prod_lanebest on {path.name}")
            if "plain_mismatch" in r and (r["plain_mismatch"] or r["max_abs_err"]):
                raise AssertionError(f"{name} differs from its plain version on {path.name}")
        floors = {k: v["ms"] for k, v in runs[tag].items() if not v["exact"]}
        log(f"[20] {path.name} floors (the four numerators and a minimum fold of det, as the "
            f"JAX script's; wrong results by design, equal to their plain versions): {floors} "
            f"ms per launch on {smi}")
        wasted = {k: v["wasted_pairs"] for k, v in runs[tag].items() if v["wasted_pairs"]}
        log(f"[20] {path.name} (ray, tile) pairs a schedule evaluates beyond what its bound "
            f"counts (non-members and dead rays of a visiting block): {wasted}")

    def entry(name, variant, tag, line):
        r = runs[tag][variant]
        return {
            "name": name, "route": "cuda", "source": f"{PKG}/csrc/mesh_walk.cu",
            "replaces": f"scripts/profile_epilogue.py:{line}", "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
        }

    return [entry("lb_asc", "lb_asc", "20k", 239),
            entry("epilogue_mono full", "mono", "5k", 285),
            entry("epilogue_mono gate", "mono_gate", "5k", 285)], {}


def capacity_phases(device, smi: str) -> tuple:
    """Phase 21: a generated scene of 40 primitives and 40 materials at
    depth 80 (the box of cornell_dof.json filled with a grid of spheres and
    cubes), beyond what the prim kernels' fixed tables and key array once
    held: the bounce kernel and the iteration kernel against their plain
    versions to the bars of phases 4-5, and the Renderer's main path through
    the iteration kernel; then 1,600 primitives at a small frame, whose tables
    exceed the card's shared memory, through the bounce, mesh-shade and
    iteration kernels' device-memory instantiations."""
    from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer
    from project3_cuda_path_tracer_2025_tpu_torch.ops import camera as camera_ops
    from project3_cuda_path_tracer_2025_tpu_torch.ops import film as film_ops
    from project3_cuda_path_tracer_2025_tpu_torch.ops import fused, intersect_mxu as mxu
    from project3_cuda_path_tracer_2025_tpu_torch.ops.intersect import intersect_scene
    from project3_cuda_path_tracer_2025_tpu_torch.scene import (
        build_device_scene, camera_state, derive_render_camera, many_prims_scene,
        scene_from_dict, set_resolution,
    )
    from project3_cuda_path_tracer_2025_tpu_torch.utils import prng

    res, prims, mats, depth = 400, 40, 40, 80
    make = lambda: set_resolution(
        scene_from_dict(many_prims_scene(str(SCENE), prims, mats, depth=depth)), res, res)
    scene = make()
    _, static = build_device_scene(scene, device)
    cam = camera_state(derive_render_camera(scene.state.camera))
    cfg = RenderConfig()
    n = static.pixel_count
    log(f"[21] generated scene: {len(static.geoms)} primitives, {static.num_materials} "
        f"materials, depth {static.trace_depth}, {res}x{res}")
    if (len(static.geoms), static.num_materials, static.trace_depth) != (prims, mats, depth):
        raise AssertionError("the generated scene is not the one asked for")
    ik = prng.iteration_key(prng.prng_key(0), 1)
    idx = torch.arange(n, device=device)
    paths = camera_ops.generate_camera_rays(
        cam, static.width, static.height, static.trace_depth,
        prng.uniforms_at(prng.stage_key(ik, 0, 0), idx, 4, n))
    for d in range(3):
        su = prng.uniforms_at(prng.stage_key(ik, d, 1), idx, 3, n)
        out_k = fused.fused_prim_bounce(static, cfg, paths, su)
        out_p = fused.fused_prim_bounce_plain(static, cfg, paths, su)
        torch.cuda.synchronize()
        lane_bad = torch.zeros(n, dtype=torch.bool, device=device)
        for a, b in zip((*out_k.origin, *out_k.direction, *out_k.color),
                        (*out_p.origin, *out_p.direction, *out_p.color)):
            lane_bad |= ~torch.isclose(a, b, rtol=STAGE_RTOL, atol=STAGE_ATOL)
        bn_diff = int((out_k.bounces != out_p.bounces).sum())
        share = float(lane_bad.float().mean())
        log(f"[21a] bounce kernel, bounce {d}: lanes with bounces differing {bn_diff}; lanes "
            f"outside rtol={STAGE_RTOL} atol={STAGE_ATOL}: {share:.5%}")
        if bn_diff / n > MAX_STAGE_LANE_SHARE or share > MAX_STAGE_LANE_SHARE:
            raise AssertionError("the bounce kernel disagrees with its plain version at 40 prims")
        paths = out_p
    base_key = prng.prng_key(0)
    film_k, alive_k = fused.fused_prim_iteration(static, cfg, cam, film_ops.new_film(n, device),
                                                 1, base_key)
    film_p, alive_p = fused.fused_prim_iteration_plain(static, cfg, cam,
                                                       film_ops.new_film(n, device), 1, base_key)
    torch.cuda.synchronize()
    log(f"[21b] iteration kernel vs plain, {prims} primitives, depth {depth}:")
    r_p = compare_films("vs fused_prim_iteration_plain", film_k, film_p)
    ak, ap = alive_k.cpu().numpy(), alive_p.cpu().numpy()
    log(f"  alive at depths 0-3 / the last 3: kernel {ak[:4].tolist()} / {ak[-3:].tolist()}, "
        f"plain {ap[:4].tolist()} / {ap[-3:].tolist()}; depths with a live ray: "
        f"{int((ak > 0).sum())} of {depth}")
    if not (r_p["finite"] and r_p["sum_rel"] <= MAX_SUM_REL
            and r_p["pixel_share"] <= MAX_PIXEL_SHARE):
        raise AssertionError(f"the iteration kernel disagrees with its plain version: {r_p}")
    if (np.abs(ak - ap) > np.maximum(MAX_ALIVE_REL * np.maximum(ap, 1), 2)).any():
        raise AssertionError("alive counts differ at 40 prims, depth 80")
    counters = {"fused_prim_iteration": fused.fused_prim_iteration,
                "fused_prim_bounce": fused.fused_prim_bounce}
    r, got = drive(make(), 4, counters)
    log(f"[21c] Renderer(generated scene) step_many(4): launches {got}")
    if got["fused_prim_iteration"] != 4:
        raise AssertionError("the Renderer did not take the iteration kernel at 40 prims")
    big = set_resolution(
        scene_from_dict(many_prims_scene(str(SCENE), prims, mats, depth=depth)), 800, 800)
    _, bstatic = build_device_scene(big, device)
    bcam = camera_state(derive_render_camera(big.state.camera))
    film_t = film_ops.new_film(bstatic.pixel_count, device)
    it = [0]

    def frame():
        it[0] += 1
        fused.fused_prim_iteration(bstatic, cfg, bcam, film_t, it[0], base_key)

    paths_t = {f"iteration kernel, {prims} prims, depth {depth}, 800x800": (frame, 5)}
    log_times("21d", smi, time_paths(paths_t, {k: 4 for k in paths_t}), paths_t,
              {k: 4 for k in paths_t}, {})

    # 21e: tables beyond the card's shared memory (1,600 primitives: 243 KB),
    # which the three kernels that read the scene then leave in device
    # memory: their other instantiations, at a small frame and depth 8 (the
    # plain version takes some 50,000 launches a bounce at this length).
    res_e, prims_e, mats_e, depth_e = 32, 1600, 200, 8
    scene = set_resolution(
        scene_from_dict(many_prims_scene(str(SCENE), prims_e, mats_e, depth=depth_e)), res_e, res_e)
    _, static = build_device_scene(scene, device)
    cam = camera_state(derive_render_camera(scene.state.camera))
    n = static.pixel_count
    table_bytes = prims_e * 152 + mats_e * 36
    log(f"[21e] {len(static.geoms)} primitives, {static.num_materials} materials, depth "
        f"{static.trace_depth}, {res_e}x{res_e}: tables of {table_bytes} bytes stay in device memory")
    if table_bytes <= 232448 or len(static.geoms) != prims_e:
        raise AssertionError("the tables of phase 21e fit the shared memory after all")
    idx = torch.arange(n, device=device)
    paths = camera_ops.generate_camera_rays(
        cam, static.width, static.height, static.trace_depth,
        prng.uniforms_at(prng.stage_key(ik, 0, 0), idx, 4, n))
    far = 0
    # A made-up mesh of mats_e triangles, the k-th of material k, its vertex
    # normals all +z.
    rows = torch.zeros((mats_e, mxu.SHADE_ROW), device=device)
    rows[:, [2, 5, 8]] = 1.0
    rows[:, 9] = torch.arange(mats_e, device=device).float()
    rows[:, 13], rows[:, 17] = 1.0, 1.0  # e1 = x, e2 = y
    mesh = types.SimpleNamespace(attrs_shade=rows)
    for d in range(3):
        skey = prng.stage_key(ik, d, 1)
        su = prng.uniforms_at(skey, idx, 3, n)
        # The mesh shade with a made-up mesh hit on every third lane.
        hit = (idx % 3 == 0) & paths.alive
        mesh_t = torch.where(hit, 0.5, 0.0).float()
        mesh_tri = torch.where(hit, idx % mats_e, -1).to(torch.int32)
        sargs = (static, cfg, paths, mesh_t, None, None, skey, n, "tlim", mesh)
        pairs = {
            "bounce": (fused.fused_prim_bounce(static, cfg, paths, su), None,
                       fused.fused_prim_bounce_plain(static, cfg, paths, su), None),
            "mesh shade": (*fused.fused_mesh_shade(*sargs, mesh_tri=mesh_tri),
                           *fused.fused_mesh_shade_plain(*sargs, mesh_tri=mesh_tri)),
        }
        torch.cuda.synchronize()
        for what, (out_k, tl_k, out_p, tl_p) in pairs.items():
            fk = [*out_k.origin, *out_k.direction, *out_k.color] + ([tl_k[0]] if tl_k else [])
            fp = [*out_p.origin, *out_p.direction, *out_p.color] + ([tl_p[0]] if tl_p else [])
            lane_bad = torch.zeros(n, dtype=torch.bool, device=device)
            for a, b in zip(fk, fp):
                lane_bad |= ~torch.isclose(a, b, rtol=STAGE_RTOL, atol=STAGE_ATOL)
            bn_diff = int((out_k.bounces != out_p.bounces).sum())
            share = float(lane_bad.float().mean())
            log(f"[21e] {what} kernel, bounce {d}: lanes with bounces differing {bn_diff}; "
                f"lanes outside rtol={STAGE_RTOL} atol={STAGE_ATOL}: {share:.5%}")
            if bn_diff / n > MAX_STAGE_LANE_SHARE or share > MAX_STAGE_LANE_SHARE:
                raise AssertionError(f"the {what} kernel disagrees with its plain version when "
                                     "it reads the tables from device memory")
        isect = intersect_scene(None, static, paths, cfg)
        far += int(((isect.material_id >= 40) & (isect.t > 0) & paths.alive).sum())
        paths = pairs["bounce"][2]
    log(f"[21e] hits on materials beyond the first 40 over 3 bounces: {far}")
    if far < 50:
        raise AssertionError("the far end of the long tables was hardly hit")
    film_k, alive_k = fused.fused_prim_iteration(static, cfg, cam, film_ops.new_film(n, device),
                                                 1, base_key)
    film_p, alive_p = fused.fused_prim_iteration_plain(static, cfg, cam,
                                                       film_ops.new_film(n, device), 1, base_key)
    torch.cuda.synchronize()
    log(f"[21e] iteration kernel vs plain, {prims_e} primitives, depth {depth_e}:")
    r_p = compare_films("vs fused_prim_iteration_plain", film_k, film_p)
    ak, ap = alive_k.cpu().numpy(), alive_p.cpu().numpy()
    log(f"  depths with a live ray: kernel {int((ak > 0).sum())}, plain {int((ap > 0).sum())} "
        f"of {depth_e}; largest difference of an alive count {int(np.abs(ak - ap).max())}")
    # 1,024 pixels: the pixel bar of the large frames is 5 of them.
    if not (r_p["finite"] and r_p["sum_rel"] <= 1e-3 and r_p["pixel_share"] <= 5 / n):
        raise AssertionError(f"the iteration kernel disagrees with its plain version: {r_p}")
    if (np.abs(ak - ap) > 2).any():
        raise AssertionError("alive counts differ at 1,600 primitives")
    return [], {}


def lobes_phases(device, smi: str) -> tuple:
    """Phase 26: one iteration of ``cornell_all_lobes.json`` at 800x800,
    depth 8: the iteration kernel's film and alive counts against the plain
    path's, its counting variant's (lobe_counts set) against its own bit
    for bit, and the variant's lobe tally against the plain path's and the
    benchmark reference's (``benchmark/reference``, ``Tracer.lobe_counts``)
    on the card, all equal; then both kernels timed by CUDA events."""
    from benchmark.reference import scene as ref_scene
    from benchmark.reference import tracer as ref_tracer
    from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu_torch.ops import film as film_ops
    from project3_cuda_path_tracer_2025_tpu_torch.ops import fused
    from project3_cuda_path_tracer_2025_tpu_torch.ops import shade as shade_ops
    from project3_cuda_path_tracer_2025_tpu_torch.scene import (
        build_device_scene, camera_state, derive_render_camera, load_scene,
    )
    from project3_cuda_path_tracer_2025_tpu_torch.utils import prng

    seed = 1_234_567_891
    scene = load_scene(str(SCENE_LOBES))
    _, static = build_device_scene(scene, device)
    cam = camera_state(derive_render_camera(scene.state.camera))
    cfg, key = RenderConfig(), prng.prng_key(seed)
    n, depth = static.pixel_count, static.trace_depth
    tally = lambda: torch.zeros((depth, len(shade_ops.LOBES)), dtype=torch.int32,
                                device=device)
    film_k, alive_k = fused.fused_prim_iteration(static, cfg, cam, film_ops.new_film(n, device),
                                                 1, key)
    lobes_c = tally()
    film_c, alive_c = fused.fused_prim_iteration(static, cfg, cam, film_ops.new_film(n, device),
                                                 1, key, lobe_counts=lobes_c)
    lobes_p = tally()
    film_p, alive_p = fused.fused_prim_iteration_plain(
        static, cfg, cam, film_ops.new_film(n, device), 1, key, lobes_p)
    torch.cuda.synchronize()
    doc = json.loads(SCENE_LOBES.read_text())
    ref = ref_scene.load(doc, str(SCENE_LOBES.parent))
    counts = ref_tracer.Tracer(ref, seed, device).lobe_counts(ref.render_camera(), 1)
    lobes_r = np.stack([counts[name] for name in ref_scene.LOBES], axis=1)
    log(f"[26] {static.width}x{static.height}, depth {depth}, seed {seed}; lobe tally "
        f"{list(shade_ops.LOBES)} a depth: {lobes_c.cpu().tolist()}")
    r = compare_films("iteration kernel vs fused_prim_iteration_plain", film_k, film_p)
    equal = int((film_np(film_k) == film_np(film_p)).all(axis=1).sum())
    log(f"  pixels bit-equal: {equal} of {n}")
    same_variant = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(film_c, film_k)) and torch.equal(alive_c, alive_k)
    if not same_variant:
        raise AssertionError("the counting variant's film or alive counts are not the kernel's")
    if not torch.equal(alive_k, alive_p):
        raise AssertionError(f"alive counts: kernel {alive_k.tolist()}, plain {alive_p.tolist()}")
    if not (torch.equal(lobes_c, lobes_p) and (lobes_c.cpu().numpy() == lobes_r).all()):
        raise AssertionError(f"lobe tallies: kernel {lobes_c.tolist()}, plain "
                             f"{lobes_p.tolist()}, reference {lobes_r.tolist()}")
    if not (r["finite"] and r["sum_rel"] <= MAX_SUM_REL and r["pixel_share"] <= MAX_PIXEL_SHARE):
        raise AssertionError(f"the iteration kernel disagrees with its plain version: {r}")
    film = film_ops.new_film(n, device)
    kernel = lambda: fused.fused_prim_iteration(static, cfg, cam, film, 1, key)
    counting = lambda: fused.fused_prim_iteration(static, cfg, cam, film, 1, key,
                                                  lobe_counts=lobes_c)
    for fn in (kernel, counting):
        fn()
    ms = {what: float(np.median([cuda_time_ms(fn, 20) for _ in range(3)]))
          for what, fn in (("kernel", kernel), ("counting variant", counting))}
    log(f"[26] ms a launch on {smi}: " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()))
    return [], {}


def bench_script_phase(device, smi: str) -> tuple:
    """Phase 22: ``scripts/torch_bench_scenes.py --quick`` as a subprocess on
    two scenes; its JSON lines parsed; a non-zero exit fails the run."""
    cmd = [sys.executable, str(ROOT / "scripts" / "torch_bench_scenes.py"), "--quick", "--spp",
           "8", "--batch", "4", "--scenes", "scenes/cornell_dof.json",
           "scenes/cornell_mesh_5k.json"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    recs = []
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            recs.append(json.loads(line))
    for r in recs:
        log(f"[22] {r.get('scene')}: {r.get('ms_per_frame')} ms/frame, "
            f"{r.get('mrays_per_s')} Mrays/s, finite {r.get('finite')}, on {r.get('card')}")
    if out.returncode != 0 or len(recs) != 2 or any(
            "error" in r or not r["finite"] or not r["ms_per_frame"] > 0 for r in recs):
        raise AssertionError(f"torch_bench_scenes.py failed (exit {out.returncode}):\n"
                             f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    return [], {}


def parallel_phases(device, smi: str) -> tuple:
    """Phase 23: multi-device and chunked rendering (``parallel``) at 800x800,
    depth 8, on the one card named nd times (each shard on a CUDA stream of
    its own): the camera draw of a block (the Threefry kernel with ``base``
    and ``rng_n``) against ``uniforms_at`` bit for bit; the main path,
    ``Renderer(devices=2)`` in pixel mode on cornell_dof.json, with the
    counters reset; pixel mode at nd = 2 and 4, ``pixel_chunks=8``, the 5k
    mesh and the wavefront at nd = 2 bit-equal to the unsharded
    ``megakernel_iteration`` / ``wavefront_iteration`` film; sample mode at
    nd = 2 against two single steps (§2's film comparison); then ms/frame
    by CUDA events.  nd shards on one card show the split's host cost, not
    a multi-GPU time."""
    from project3_cuda_path_tracer_2025_tpu_torch import parallel
    from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu_torch.models import (
        Renderer, megakernel_iteration, wavefront_iteration,
    )
    from project3_cuda_path_tracer_2025_tpu_torch.ops import film as film_ops
    from project3_cuda_path_tracer_2025_tpu_torch.ops import fused
    from project3_cuda_path_tracer_2025_tpu_torch.ops import intersect_mxu as mxu
    from project3_cuda_path_tracer_2025_tpu_torch.ops import scan
    from project3_cuda_path_tracer_2025_tpu_torch.scene import load_scene
    from project3_cuda_path_tracer_2025_tpu_torch.utils import prng

    # -- 23a. the camera draw of a block: kernel == plain, bit for bit --------
    n = 640_000
    key = prng.stage_key(prng.iteration_key(prng.prng_key(0), 1), 0, 0)
    shapes = [(0, n)] + [(d * n // nd, n // nd) for nd in (2, 4, 8) for d in range(nd)]
    u_err, u_bits = 0.0, 0
    for base, ln in shapes:
        got = fused.kernel_uniforms(key, ln, 4, device, base=base, rng_n=n)
        want = prng.uniforms_at(key, base + torch.arange(ln, device=device), 4, n)
        u_bits += bits_differ(got, want)
        u_err = max(u_err, float((got - want).abs().max()))
    torch.cuda.synchronize()
    log(f"[23a] Threefry kernel on {len(shapes)} blocks [4, ln] at base, rng_n={n} "
        f"(nd = 1, 2, 4, 8): values not bit-equal to uniforms_at {u_bits}, max abs diff {u_err}")
    if u_bits:
        raise AssertionError("the block draw of the Threefry kernel differs from uniforms_at")
    ln, base = n // 2, n // 2
    idx = base + torch.arange(ln, device=device)
    u_ms = cuda_time_ms(lambda: fused.kernel_uniforms(key, ln, 4, device, base=base, rng_n=n), 50)
    u_plain = cuda_time_ms(lambda: prng.uniforms_at(key, idx, 4, n), 5)
    u_bound = bound_ms(4 * ln * 4, 4 * ln * OPS_UNIFORM)
    log(f"    block [4, {ln}] at base {base} (shard 1 of 2): kernel {u_ms:.4f} ms, plain "
        f"uniforms_at {u_plain:.4f} ms, bound {u_bound[0]:.4f} ms ({u_bound[1]}) on {smi}")

    def reference(r, iterate, its):
        """The unsharded film of iterations ``its`` (the renderer's dev,
        static, camera and config)."""
        film = film_ops.new_film(r.static.pixel_count, device)
        for it in its:
            film, alive = iterate(r.dev, r.static, r.cfg, r._cam_state, film, it, r._base_key)
        return film, alive

    def bit_equal(tag, r, iterate, its):
        want, want_alive = reference(r, iterate, its)
        got = r._flat_film()
        torch.cuda.synchronize()
        bits = sum(bits_differ(a, b) for a, b in zip(got, want))
        alive_eq = np.array_equal(r._alive_counts, want_alive.cpu().numpy())
        img = r.image()
        log(f"[{tag}] film values not bit-equal to the unsharded film {bits}; alive counts "
            f"equal {alive_eq} ({r._alive_counts.tolist()}); film sum {img.sum():.3f}")
        if bits or not alive_eq or not np.isfinite(img).all() or not img.sum() > 0:
            raise AssertionError(f"{tag}: the film differs from the unsharded one")

    # -- 23b. the main path: Renderer(devices=2), pixel mode, counters reset ----
    counters = {"kernel_uniforms": fused.kernel_uniforms,
                "fused_prim_bounce": fused.fused_prim_bounce,
                "fused_prim_iteration": fused.fused_prim_iteration}
    scene = load_scene(str(SCENE))
    depth = scene.state.trace_depth
    r2 = Renderer(scene, RenderConfig(devices=2), shard_devices=[device] * 2)
    for c in counters.values():
        c.launches = 0
    r2.step_many(2)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    log(f"[23b] Renderer('{SCENE.name}', devices=2) on {[str(d) for d in r2._devices]}, "
        f"step_many(2): iteration {r2.iteration}, launches {launches}")
    if launches != {"kernel_uniforms": 4, "fused_prim_bounce": 4 * depth,
                    "fused_prim_iteration": 0}:
        raise AssertionError("the pixel-mode step did not launch the block draw and the "
                             "bounce kernel once a shard (and never the iteration kernel)")
    bit_equal("23b", r2, megakernel_iteration, (1, 2))
    renderers = {"prim pixel nd=2": r2}
    for tag, cfg, nd in (("prim pixel nd=4", RenderConfig(devices=4), 4),
                         ("prim pixel_chunks=8", RenderConfig(pixel_chunks=8), 1)):
        r = Renderer(scene, cfg, shard_devices=[device] * nd)
        r.step_many(2)
        log(f"    {tag}:")
        bit_equal("23b", r, megakernel_iteration, (1, 2))
        renderers[tag] = r
    rs = Renderer(scene, RenderConfig(devices=2, parallel_mode="sample"),
                  shard_devices=[device] * 2)
    rs.step()
    want, _ = reference(rs, megakernel_iteration, (1, 2))
    log(f"[23b] sample mode nd=2, one step (iteration {rs.iteration}) against two single steps:")
    res = compare_films("sample nd=2 vs 2 x megakernel_iteration", rs._flat_film(), want)
    if rs.iteration != 2 or not (res["finite"] and res["sum_rel"] <= MAX_SUM_REL
                                 and res["pixel_share"] <= MAX_PIXEL_SHARE):
        raise AssertionError(f"sample mode disagrees with two single steps: {res}")
    renderers["prim sample nd=2"] = rs

    # -- 23c. the 5k mesh and the wavefront in pixel mode, nd = 2 -----------------
    mesh_counters = {"mono_intersect": mxu.mono_intersect,
                     "fused_mesh_shade": fused.fused_mesh_shade,
                     "kernel_uniforms": fused.kernel_uniforms}
    mesh = load_scene(str(MESH_SCENE))
    rm = Renderer(mesh, RenderConfig(devices=2), shard_devices=[device] * 2)
    for c in mesh_counters.values():
        c.launches = 0
    rm.step()
    torch.cuda.synchronize()
    ml = {k: c.launches for k, c in mesh_counters.items()}
    log(f"[23c] Renderer('{MESH_SCENE.name}', devices=2) step: launches {ml}")
    if ml != {"mono_intersect": 2 * depth, "fused_mesh_shade": 2 * depth, "kernel_uniforms": 2}:
        raise AssertionError("the 5k mesh's pixel-mode step did not launch #4, #3 and the "
                             "block draw once a shard and bounce")
    bit_equal("23c", rm, megakernel_iteration, (1,))
    rw = Renderer(scene, RenderConfig(devices=2, integrator="wavefront", stream_compaction=True),
                  shard_devices=[device] * 2)
    scan.scan_flat.launches = 0
    rw.step()
    torch.cuda.synchronize()
    log(f"[23c] wavefront (compaction on), devices=2 step: scan launches "
        f"{scan.scan_flat.launches}")
    if not scan.scan_flat.launches:
        raise AssertionError("the wavefront's pixel-mode step launched no scan")
    bit_equal("23c", rw, wavefront_iteration, (1,))

    # -- 23d. ms/frame by CUDA events --------------------------------------------
    single = Renderer(scene)
    one = parallel.make_sharded_step({device: r2.dev}, r2.static, RenderConfig(), [device],
                                     "pixel")[0]
    film1 = parallel.sharded_film(r2.static, [device], "pixel")
    it1 = [0]

    def nd1():
        it1[0] += 1
        one(r2._cam_state, film1, it1[0], r2._base_key)

    def stepper(r):
        return lambda: r.step(sync=False)

    bounce_path = frame_fn(r2.dev, r2.static, r2._cam_state, RenderConfig(), r2._base_key,
                           device)
    mesh_single = Renderer(mesh)
    wf_film = film_ops.new_film(rw.static.pixel_count, device)
    wf_it = [0]

    def wave_unsharded():
        wf_it[0] += 1
        wavefront_iteration(rw.dev, rw.static, rw.cfg, rw._cam_state, wf_film, wf_it[0],
                            rw._base_key)

    paths_t = {
        "prim unsharded, iteration kernel (Renderer)": (stepper(single), 20),
        "prim unsharded megakernel_iteration": (bounce_path, 10),
        "prim pixel nd=1 (sharded step)": (nd1, 10),
        "prim pixel nd=2": (stepper(r2), 10),
        "prim pixel nd=4": (stepper(renderers["prim pixel nd=4"]), 10),
        "prim sample nd=2 (2 spp a call)": (stepper(rs), 5),
        "prim pixel_chunks=8": (stepper(renderers["prim pixel_chunks=8"]), 10),
        "5k mesh unsharded (Renderer)": (stepper(mesh_single), 3),
        "5k mesh pixel nd=2": (stepper(rm), 3),
        "wavefront unsharded": (wave_unsharded, 2),
        "wavefront pixel nd=2": (stepper(rw), 2),
    }
    rounds = {k: 3 for k in paths_t}
    times = {k: [] for k in paths_t}
    for fn, _ in paths_t.values():
        fn()  # warm-up
    torch.cuda.synchronize()
    order = list(paths_t)
    for rnd in range(3):
        for k in (order if rnd % 2 == 0 else order[::-1]):
            fn, reps = paths_t[k]
            times[k].append(cuda_time_ms(fn, reps))
    spp = {k: 2 if "sample" in k else 1 for k in paths_t}
    times = {k: [t / spp[k] for t in v] for k, v in times.items()}
    rays = {k: float(n + (rm if "mesh" in k else rw if "wavefront" in k else r2)
                     ._alive_counts.sum()) for k in paths_t}
    log("[23d] per frame (one spp; sample mode's call of 2 spp halved); nd shards on one "
        "card: the split's host cost, not a multi-GPU time")
    log_times("23d", smi, times, paths_t, rounds, rays)
    return [{
        "name": "kernel_uniforms",
        "route": "cuda",
        "source": f"{PKG}/csrc/fused_prim.cu",
        "replaces": "project3_cuda_path_tracer_2025_tpu/utils/prng.py:103 (uniforms_at, "
                    "XLA's Threefry; no Pallas kernel)",
        "launches": launches["kernel_uniforms"],
        "max_abs_err": u_err,
        "ms": u_ms,
        "plain_ms": u_plain,
        "bound_ms": u_bound[0],
        "bound_by": u_bound[1],
        "library_ms": None,
    }], {"prim pixel mode nd=2 (Renderer, cuda:0 twice)": (stepper(r2), "ptt_bounce_kernel")}


# ---------------------------------------------------------------------------
# Phase 24: bounce prefix tiers and the native BVH builder
# ---------------------------------------------------------------------------

TIERS = (4, 2)


def bvh_invariants(tree, verts: np.ndarray, leaf: int) -> None:
    """A tree's invariants, vectorised: pre-order numbering (the left child
    follows its parent), leaves of 1 to ``leaf`` triangles tiling
    ``tri_indices`` in order, a permutation of every triangle, leaf boxes
    holding their triangles, internal boxes the union of their children's,
    the root's miss link past the end.  Raises on a violation."""
    t, m = verts.shape[0], tree.num_nodes
    internal = tree.left >= 0
    leaves = np.nonzero(~internal)[0]
    l, r = tree.left[internal], tree.right[internal]
    s, c = tree.start[leaves], tree.tri_count[leaves]
    o = np.argsort(s)
    s, c, leaves = s[o], c[o], leaves[o]
    tri = tree.tri_indices
    owner = np.repeat(leaves, c)  # the leaf of each position of tri_indices
    v = verts[tri]  # [T, 3, 3] in leaf order
    checks = {
        "pre-order": np.array_equal(l, np.nonzero(internal)[0] + 1) and (r > l).all(),
        "leaf sizes": bool((c >= 1).all() and c.max() <= leaf
                           and (internal ^ (tree.tri_count > 0)).all()),
        "leaves tile the triangles": bool(s[0] == 0 and np.array_equal(s[1:], (s + c)[:-1])
                                          and s[-1] + c[-1] == t),
        "a permutation": np.array_equal(np.sort(tri), np.arange(t)),
        "leaf boxes": bool((v >= tree.aabb_min[owner][:, None, :]).all()
                           and (v <= tree.aabb_max[owner][:, None, :]).all()),
        "internal boxes": np.array_equal(
            tree.aabb_min[internal], np.minimum(tree.aabb_min[l], tree.aabb_min[r]))
        and np.array_equal(
            tree.aabb_max[internal], np.maximum(tree.aabb_max[l], tree.aabb_max[r])),
        "miss links": bool(tree.miss_link[0] == m),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"BVH invariants violated: {bad}")


# The rows a spied kernel wrapper was given: its ray or flag argument.
HEAD_ARG = {"mesh_intersect_mxu": lambda a: a[3].x, "fused_mesh_shade": lambda a: a[2].origin.x,
            "scan_flat": lambda a: a[0], "plan_prepass": lambda a: a[1].x}


def tensors(o) -> list:
    """The tensors of a nest of tuples (PathState, Vec3, carries)."""
    if isinstance(o, torch.Tensor):
        return [o]
    return [] if o is None else [x for e in o for x in tensors(e)]


class Spy:
    """Replaces ``module.name`` with a wrapper that hands each call's
    arguments to ``record`` before calling the function; ``with`` restores
    it.  The wrapper shares the function's attributes, so a wrapper that
    counts its launches through its module's name (``f.launches += 1``)
    counts on the function."""

    def __init__(self, module, name, record):
        self.module, self.name, self.record = module, name, record

    def __enter__(self):
        fn = self.fn = getattr(self.module, self.name)

        def run(*args, **kw):
            self.record(args, kw)
            return fn(*args, **kw)
        run.__dict__ = fn.__dict__
        setattr(self.module, self.name, run)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def tier_phases(device, smi: str) -> tuple:
    """Phase 24 at 800x800, depth 8: the native BVH builder (24a: the
    library's build seconds; the BVH build, native against NumPy on the 5k
    and 80k meshes, native alone on 500k and the 1.1 M-triangle knot, with
    each tree's invariants; the 5k "auto" film with the native tree against the NumPy
    tree, §2's bar) and prefix tiers (24b: ``bounce_prefix_tiers=(4, 2)``
    against ``()`` on the 5k, 20k and 80k "auto", 200k binned, textured-prim
    and textured-mesh frames and the ``cornell_dof`` wavefront with
    compaction on and "adaptive": films and alive counts bit-equal, the
    rows each bounce ran on, launches and host reads per frame, ms/frame by
    CUDA events, the two in turns; 24c: kernels #3 (modes plain, textured,
    precomputed), #4, #5, #7, #10, #11 and #12 on the heads the tiered
    frames gave them, bit-equal to their plain versions).  No new kernel:
    nothing is added to the kernels line."""
    import dataclasses

    from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu_torch.models import (
        megakernel_iteration, wavefront, wavefront_iteration,
    )
    from project3_cuda_path_tracer_2025_tpu_torch.native import bvh_native
    from project3_cuda_path_tracer_2025_tpu_torch.ops import film as film_ops
    from project3_cuda_path_tracer_2025_tpu_torch.ops import fused, intersect_mxu as mxu
    from project3_cuda_path_tracer_2025_tpu_torch.ops import scan
    from project3_cuda_path_tracer_2025_tpu_torch.scene import (
        build_device_scene, camera_state, derive_render_camera, load_scene,
    )
    from project3_cuda_path_tracer_2025_tpu_torch.scene.bvh import build_bvh
    from project3_cuda_path_tracer_2025_tpu_torch.utils import prng

    base_key = prng.prng_key(0)

    def scene_of(cached, path):
        if cached in LOADED:
            return LOADED[cached]
        scene = load_scene(str(path))
        dev, static = build_device_scene(scene, device)
        return scene, dev, static, camera_state(derive_render_camera(scene.state.camera))

    heads = {}  # (kernel wrapper, frame) -> [(args, kwargs)] of calls on a sliced head

    def keep(name, tag, n):
        def record(args, kwargs):
            if HEAD_ARG[name](args).shape[0] < n and len(heads.setdefault((name, tag), [])) < 2:
                heads[(name, tag)].append((args, kwargs))
        return record

    # -- 24a. the native BVH builder ----------------------------------------
    secs = bvh_native.compile_library(OUT_DIR / "native" / "libptt_bvh_builder.so")
    t0 = time.perf_counter()
    bvh_native.load()  # the package's own, built at its first use if no phase loaded a mesh
    log(f"[24a] native BVH library (csrc/bvh_builder.cpp) built with {bvh_native.CXX} "
        f"{' '.join(bvh_native.CXX_FLAGS)} in {secs:.2f} s; the package's own at "
        f"{bvh_native.library_path().relative_to(ROOT)} ready in "
        f"{time.perf_counter() - t0:.2f} s")
    big = OUT_DIR / "cornell_mesh_big.json"
    if not big.is_file():
        big = write_big_mesh()
    # Native against NumPy on 5k and 80k; the larger meshes' NumPy builds
    # (8.6 and 20.9 s, PERF.md section 6) are left to the native build and its
    # invariants.
    for name, path in (("5k", MESH_SCENE), ("80k", LARGE["80k"]), ("500k", LARGE["500k"]),
                       ("1.1 M knot", big)):
        key = {"80k": "80k", "500k": "500k", "1.1 M knot": "big"}.get(name)
        if key in LOADED:
            scene, parsed = LOADED[key][0], "cached"
        else:
            t0 = time.perf_counter()
            scene = load_scene(str(path), build_acceleration=False)
            parsed = f"parsed in {time.perf_counter() - t0:.2f} s"
        verts, cents = scene.tri_positions, scene.tri_centroids
        t0 = time.perf_counter()
        native = build_bvh(verts, cents, 4, use_native=True)
        t_nat = time.perf_counter() - t0
        bvh_invariants(native, verts, 4)
        if name not in ("5k", "80k"):
            log(f"    {name} ({verts.shape[0]} triangles; {parsed}): BVH build native "
                f"{t_nat:.3f} s ({native.num_nodes} nodes); invariants hold")
            continue
        t0 = time.perf_counter()
        numpy_tree = build_bvh(verts, cents, 4, use_native=False)
        t_np = time.perf_counter() - t0
        bvh_invariants(numpy_tree, verts, 4)
        log(f"    {name} ({verts.shape[0]} triangles; {parsed}): BVH build native "
            f"{t_nat:.3f} s ({native.num_nodes} nodes), NumPy {t_np:.3f} s "
            f"({numpy_tree.num_nodes} nodes), {t_np / t_nat:.1f}x; invariants hold for both; "
            f"leaf order {'equal' if np.array_equal(native.tri_indices, numpy_tree.tri_indices) else 'differs'}")

    films = {}
    for native in (True, False):
        scene = load_scene(str(MESH_SCENE), native_bvh=native)
        dev, static = build_device_scene(scene, device)
        cam = camera_state(derive_render_camera(scene.state.camera))
        film = film_ops.new_film(static.pixel_count, device)
        films[native] = megakernel_iteration(dev, static, RenderConfig(native_bvh=native), cam,
                                             film, 1, base_key)
    differ = int(torch.stack([a != b for a, b in zip(films[True][0], films[False][0])])
                 .any(0).sum())
    log(f"[24a] 5k 'auto' frame, native tree against the NumPy tree: {differ} of "
        f"{static.pixel_count} pixels differ; alive counts equal "
        f"{torch.equal(films[True][1], films[False][1])}")
    res = compare_films("5k native vs NumPy tree", films[True][0], films[False][0])
    if not (res["finite"] and res["sum_rel"] <= MAX_SUM_REL
            and res["pixel_share"] <= MAX_PIXEL_SHARE):
        raise AssertionError(f"the native tree's 5k film disagrees with the NumPy tree's: {res}")

    # -- 24b. tiers against none, frame by frame ---------------------------
    frames = (
        ("5k auto", MESH_SCENE, None, {}, "mesh"),
        ("20k auto", LARGE["20k"], "20k", {}, "mesh"),
        ("80k auto", LARGE["80k"], "80k", {}, "mesh"),
        ("200k binned", LARGE["200k"], "200k", dict(mxu_traversal="binned"), "mesh"),
        ("textured prims", PRIM_TEX, None, {}, "tex"),
        ("textured mesh", MESH_TEX, None, {}, "mesh"),
        ("wavefront, compaction on", SCENE, None,
         dict(integrator="wavefront", stream_compaction=True), "wavefront"),
        ("wavefront, adaptive", SCENE, None,
         dict(integrator="wavefront", stream_compaction="adaptive"), "wavefront"),
    )
    body_of = {"mesh": (fused, "_fused_mesh_bounce_at", 3),
               "tex": (fused, "_fused_tex_bounce_at", 3),
               "wavefront": (wavefront, "intersect_scene", 2)}
    counters = {c.__name__: c for c in (
        mxu.mono_intersect, mxu.planned_lanebest_intersect, mxu.streamed_intersect,
        mxu.binned_intersect, fused.fused_mesh_shade, scan.scan_flat)}
    reps = {"80k auto": 1, "200k binned": 1, "wavefront, compaction on": 1,
            "wavefront, adaptive": 1}
    log(f"[24b] bounce_prefix_tiers={TIERS} against () at 800x800, depth 8, one spp a frame, "
        f"on {smi}:")
    verdicts = {}
    for tag, path, cached, kw, kind in frames:
        scene, dev, static, cam = scene_of(cached, path)
        n = static.pixel_count
        iterate = wavefront_iteration if kind == "wavefront" else megakernel_iteration
        cfgs = {t: RenderConfig(bounce_prefix_tiers=t, **kw) for t in (TIERS, ())}
        rows, out = [], {}
        mod, fname, at = body_of[kind]
        for t, cfg in cfgs.items():
            rows.clear()
            before = {k: c.launches for k, c in counters.items()}
            film = film_ops.new_film(n, device)
            with Spy(mod, fname, lambda a, k: rows.append(a[at].pixel.shape[0])), \
                    Spy(mxu, "mesh_intersect_mxu", keep("mesh_intersect_mxu", tag, n)), \
                    Spy(fused, "fused_mesh_shade", keep("fused_mesh_shade", tag, n)), \
                    Spy(scan, "scan_flat", keep("scan_flat", tag, n)):
                film, alive = iterate(dev, static, cfg, cam, film, 1, base_key)
            torch.cuda.synchronize()
            launches = {k: c.launches - before[k] for k, c in counters.items()
                        if c.launches - before[k]}
            out[t] = (film, alive, list(rows), launches)
        (f1, a1, r1, l1), (f0, a0, r0, l0) = out[TIERS], out[()]
        bits = sum(bits_differ(a, b) for a, b in zip(f1, f0))
        alive_eq = torch.equal(a1, a0)
        log(f"  [24b] {tag} ({n} rays): film values not bit-equal {bits}, alive counts equal "
            f"{alive_eq} ({a1.tolist()})")
        log(f"        rows each bounce ran on, tiers {TIERS}: {r1}; (): {r0}")
        log(f"        launches a frame, tiers: {l1}; (): {l0}")
        if bits or not alive_eq:
            raise AssertionError(f"{tag}: the tiered film differs from the untiered one")
        if kind != "wavefront" or kw["stream_compaction"] is True:
            if not any(r < n for r in r1):
                raise AssertionError(f"{tag}: no tier engaged ({r1})")
        fns = {}
        for t, cfg in cfgs.items():
            film = film_ops.new_film(n, device)
            it = [1]

            def fn(cfg=cfg, film=film, it=it):
                it[0] += 1
                iterate(dev, static, cfg, cam, film, it[0], base_key)
            fns[t] = fn
        for t in cfgs:
            log(f"        host reads a frame, tiers {t}: {host_syncs(fns[t])}")
        times = {t: [] for t in cfgs}
        for fn in fns.values():
            fn()
        torch.cuda.synchronize()
        order = list(cfgs)
        for rnd in range(3):
            for t in (order if rnd % 2 == 0 else order[::-1]):
                times[t].append(cuda_time_ms(fns[t], reps.get(tag, 3)))
        med = {t: float(np.median(v)) for t, v in times.items()}
        spread = max(max(v) - min(v) for v in times.values())
        slower = med[TIERS] - med[()] > spread and any(r < n for r in r1)
        verdicts[tag] = slower
        log(f"        ms/frame by CUDA events on {smi}, median of 3 [min, max] "
            f"({reps.get(tag, 3)} frames a sample, in turns): tiers {TIERS} {med[TIERS]:.4f} "
            f"{[round(min(times[TIERS]), 4), round(max(times[TIERS]), 4)]}, () {med[()]:.4f} "
            f"{[round(min(times[()]), 4), round(max(times[()]), 4)]}; "
            f"tiers/() {med[TIERS] / med[()]:.4f}; slower beyond the spread: {slower}")
    log(f"[24b] frames where tiers engage and are slower than () beyond their spread: "
        f"{[k for k, v in verdicts.items() if v]}")

    # -- 24c. the kernels on sliced heads against their plain versions ------
    tag = "80k auto, PTT_PLAN_IMPL=pallas"
    scene, dev, static, cam = scene_of("80k", LARGE["80k"])
    with env_set(PTT_PLAN_IMPL="pallas"), \
            Spy(mxu, "plan_prepass", keep("plan_prepass", tag, static.pixel_count)):
        megakernel_iteration(dev, static, RenderConfig(bounce_prefix_tiers=TIERS), cam,
                             film_ops.new_film(static.pixel_count, device), 1, base_key)
    torch.cuda.synchronize()
    log("[24c] kernels on the sliced heads of the tiered frames against their plain versions:")
    checked = {}
    for (name, tag), calls in heads.items():
        for args, kw in calls:
            if name == "mesh_intersect_mxu":
                g = mxu.mesh_intersect_mxu(*args, **{**kw, "plain": False})
                w = mxu.mesh_intersect_mxu(*args, **{**kw, "plain": True})
                got, want = [g.t, g.tri], [w.t, w.tri]
                what = ("#10 binned" if kw.get("binned") else "#4 mono" if kw.get("mono")
                        else "#7 streamed" if kw.get("streamed") else "#5 planned"
                        if kw.get("planned") else "#9 sweep")
            elif name == "fused_mesh_shade":
                got = tensors(fused.fused_mesh_shade(*args, **kw))
                want = tensors(fused.fused_mesh_shade_plain(*args, **kw))
                what = f"#3 shade, mode {kw.get('mode', 'plain')!r}"
            elif name == "scan_flat":
                got, want = [scan.scan_flat(*args, **kw)], [scan.scan_flat_plain(*args, **kw)]
                what = "#12 scan_flat"
            else:
                got = list(mxu.plan_prepass(*args, **kw))
                want = list(mxu.plan_prepass_plain(*args, **kw))
                what = "#11 plan prepass"
            torch.cuda.synchronize()
            diff = sum(bits_differ(a, b) for a, b in zip(got, want))
            rows = HEAD_ARG[name](args).shape[0]
            checked.setdefault(what, []).append((tag, rows, diff))
            if diff or len(got) != len(want):
                raise AssertionError(f"{what} on a {rows}-row head of {tag}: {diff} values "
                                     "differ from its plain version")
    for what, cases in sorted(checked.items()):
        log(f"    {what}: bit-equal on {len(cases)} heads "
            f"({sorted({(t, r) for t, r, _ in cases})})")
    need = {"#3 shade, mode 'plain'", "#3 shade, mode 'textured'", "#3 shade, mode 'precomputed'",
            "#4 mono", "#5 planned", "#7 streamed", "#10 binned", "#11 plan prepass",
            "#12 scan_flat"}
    if not need <= set(checked):
        raise AssertionError(f"no sliced head reached {sorted(need - set(checked))}")
    return [], {}


def entry_point_phases(device, smi: str) -> tuple:
    """Phases 25a-c: the repo's entry points in the port.  25a runs
    ``bench_torch.py`` as a subprocess and prints its line (bench.py's keys,
    a value, a finite film, a mesh roofline without an error); 25b runs
    ``entry()``'s step on the card with the counters reset (the bounce
    kernel, eight launches) and holds it to the same step on the CPU (the
    film at §2's bar, alive counts equal); 25c runs every tag of
    ``dryrun_multichip(4)`` with ``cuda:0`` named four times, each tag's
    launches counted, holds each to the same tag on the CPU (the same bar)
    and each ``shardmap+*`` film to the unsharded Renderer's on the card
    (bit-equal), and needs #2, #3, #4, #7 and #10 launched by the tags."""
    from project3_cuda_path_tracer_2025_tpu_torch import bench, entry
    from project3_cuda_path_tracer_2025_tpu_torch.ops import fused
    from project3_cuda_path_tracer_2025_tpu_torch.ops import intersect_mxu as mxu
    from project3_cuda_path_tracer_2025_tpu_torch.ops import scan

    # -- 25a. bench_torch.py ---------------------------------------------------
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(ROOT / "bench_torch.py")], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT))
    lines = [x for x in out.stdout.splitlines() if x.startswith("{")]
    log(f"[25a] bench_torch.py (exit {out.returncode}, {time.perf_counter() - t0:.0f} s):")
    for x in lines:
        log("    " + x)
    rec = json.loads(lines[-1]) if lines else {}
    roof = rec.get("mesh_roofline") or {"error": "missing"}
    if out.returncode != 0 or set(rec) != set(bench.KEYS) or rec["value"] is None \
            or rec["film_finite"] is not True or "error" in roof \
            or any(roof.get(k) is None for k in ("kernel_ms_per_bounce", "bound_ms",
                                                  "share_of_bound")):
        raise AssertionError(f"bench_torch.py failed:\n{out.stdout[-2000:]}\n"
                             f"{out.stderr[-2000:]}")

    # -- 25b. entry(): the step on the card against the same step on the CPU --
    counters = {c.__name__: c for c in (
        fused.fused_prim_iteration, fused.fused_prim_bounce, fused.kernel_uniforms,
        fused.fused_mesh_shade, mxu.mono_intersect, mxu.streamed_intersect,
        mxu.binned_intersect, scan.scan_flat)}
    step, args = entry.entry(device)
    for c in counters.values():
        c.launches = 0
    film, alive = step(*args)
    torch.cuda.synchronize()
    got = {k: c.launches for k, c in counters.items() if c.launches}
    step_p, args_p = entry.entry("cpu")
    film_p, alive_p = step_p(*args_p)
    log(f"[25b] entry() step at 128x128 on the card: launches {got}")
    res = compare_films("vs entry('cpu') (the CPU's torch path)", film, film_p)
    a, ap = alive.cpu().numpy(), alive_p.numpy()
    log(f"  alive per depth: card {a.tolist()}, cpu {ap.tolist()}")
    if got.get("fused_prim_bounce") != 8 or not np.array_equal(a, ap) or not (
            res["finite"] and res["sum_rel"] <= MAX_SUM_REL
            and res["pixel_share"] <= MAX_PIXEL_SHARE):
        raise AssertionError("entry()'s step on the card disagrees with the CPU's")

    # -- 25c. dryrun_multichip(4) on cuda:0 named four times, each tag held
    #    to the same tag on ["cpu"] * 4 (the plain versions) at §2's bar
    #    with alive counts equal, and each shardmap+* tag's film to one
    #    unsharded Renderer's on the card, bit for bit -----------------------
    reached = set()
    for row in entry.TAGS:
        tag = row[0]
        for c in counters.values():
            c.launches = 0
        film, alive = entry.run_tag(row, 4, [device] * 4)
        torch.cuda.synchronize()
        got = {k: c.launches for k, c in counters.items() if c.launches}
        reached |= set(got)
        log(f"[25c] {tag}: launches {got}")
        film_p, alive_p = entry.run_tag(row, 4, ["cpu"] * 4)
        res = compare_films("vs the same tag on ['cpu'] * 4", film, film_p)
        log(f"  alive per depth: card {alive.tolist()}, cpu {alive_p.tolist()}")
        bad = not (np.array_equal(alive, alive_p) and res["finite"]
                   and res["sum_rel"] <= MAX_SUM_REL and res["pixel_share"] <= MAX_PIXEL_SHARE)
        if row[1] == "renderer":
            one, one_alive = entry.run_unsharded(row, 4, device)
            differ = int((film != one).any(axis=1).sum())
            # One step of four sample-mode shards is four frames: the alive
            # counts are of different frames.
            same_alive = row[5].get("parallel_mode") == "sample" \
                or np.array_equal(alive, one_alive)
            log(f"  vs one unsharded Renderer on the card: {differ} pixels not equal, "
                f"alive counts {'equal' if same_alive else 'differ'}")
            bad = bad or differ or not same_alive
        if bad:
            raise AssertionError(f"dry-run tag {tag} on the card disagrees with its reference")
    # The wavefront tag (32x32, 256 rays a shard) compacts with torch.cumsum:
    # scan_flat takes arrays of a [128, 128] tile or more, as the JAX
    # package's Pallas scan does.
    need = {"fused_prim_bounce", "fused_mesh_shade", "mono_intersect", "streamed_intersect",
            "binned_intersect"}
    if not need <= reached:
        raise AssertionError(f"no dry-run tag launched {sorted(need - reached)}")
    return [], {}


# The phases in groups that run whole, in this order (phases 1-2, the card
# and the build, always run; 9, the profile, goes last over the frames of the
# groups that ran).  needs: a group whose cached state this one reads.
GROUPS = (
    ("prim", (3, 4, 5, 6, 7), prim_phases, None,
     "the prim path: RNG, bounce and iteration kernels, Renderer on cornell_dof.json"),
    ("mesh", (8,), mesh_phases, None, "the mono mesh path on cornell_mesh_5k.json"),
    ("larger", (10, 11, 12), larger_mesh_phases, None,
     "planned (20k), streamed (80k, 500k) and binned (200k) traversals"),
    ("textures", (13, 14), texture_phases, None, "textured prims and textured meshes"),
    ("wavefront", (15,), wavefront_phases, None, "the scan kernel and the wavefront integrator"),
    ("slice5", (16, 17, 18, 19), slice5_phases, "larger",
     "the sweep, the chunked chains, the super-tile walk, the plan prepass kernel"),
    ("epilogue", (20,), epilogue_phases, None,
     "scripts/torch_profile_epilogue.py at 800x800 on the 5k and 20k meshes (#13)"),
    ("capacity", (21,), capacity_phases, None,
     "40 primitives, 40 materials, depth 80 through the prim kernels"),
    ("bench", (22,), bench_script_phase, None,
     "scripts/torch_bench_scenes.py --quick as a subprocess on two scenes"),
    ("parallel", (23,), parallel_phases, None,
     "multi-device (pixel, sample) and chunked rendering, cuda:0 named nd times"),
    ("tiers", (24,), tier_phases, None,
     "bounce prefix tiers against none on eight frames, the native BVH builder"),
    ("entry", (25,), entry_point_phases, None,
     "bench_torch.py; entry() and dryrun_multichip(4) (cuda:0 four times) against the CPU"),
    ("lobes", (26,), lobes_phases, None,
     "the iteration kernel's lobes and its lobe tally at 800x800 against the plain path and "
     "the benchmark's reference"),
)


def parse_phases(text: str) -> set:
    """"1-7,20" -> {1, ..., 7, 20}."""
    out = set()
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.update(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke test of the PyTorch/CUDA port on one GPU")
    ap.add_argument("--phases", default=None,
                    help="phases to run, e.g. 1-7,20 (default: all); a group of phases runs "
                    "whole, and a group whose state another needs runs before it")
    ap.add_argument("--list", action="store_true", help="list the phases and exit")
    args = ap.parse_args(argv)
    if args.list:
        print("1-2   the card, the kernels' build (always run)")
        for name, phases, _, needs, what in GROUPS:
            span = f"{phases[0]}-{phases[-1]}" if len(phases) > 1 else str(phases[0])
            print(f"{span:5s} {what}" + (f" (runs {needs} first)" if needs else ""))
        print("9     torch.profiler over whole frames of the groups that ran (last)")
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA GPU",
              file=sys.stderr)
        return 2
    wanted = parse_phases(args.phases) if args.phases else None
    chosen = [g for g in GROUPS if wanted is None or wanted & set(g[1])]
    for g in list(chosen):
        dep = next((d for d in GROUPS if d[0] == g[3]), None)
        if dep is not None and dep not in chosen:
            chosen.append(dep)
    chosen = [g for g in GROUPS if g in chosen]

    from project3_cuda_path_tracer_2025_tpu_torch.ops import kernels

    device = torch.device("cuda:0")
    smi = card_label("cuda")
    log(f"[1] card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}; phase groups: {[g[0] for g in chosen]}")

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    libs = kernels.load_all()
    log(f"[2] built {len(libs)} libraries for sm_90a in parallel in "
        f"{time.perf_counter() - t0:.1f} s")
    for lib in libs.values():
        log(f"    {lib.path.relative_to(ROOT)}: nvcc {lib.build_seconds:.1f} s")
        for line in lib.build_log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log("    ptxas: " + line.strip())

    kernels_line, frames = [], {}
    for name, _, fn, _, _ in chosen:
        t0 = time.perf_counter()
        k, f = fn(device, smi)
        kernels_line += k
        frames.update(f)
        log(f"    (phase group {name}: {time.perf_counter() - t0:.0f} s)")
    if wanted is None or 9 in wanted:
        t0 = time.perf_counter()
        profile_paths(frames)
        log(f"    (phase 9: {time.perf_counter() - t0:.0f} s)")

    print(smi)
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
