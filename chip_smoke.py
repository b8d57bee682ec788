"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``project3_cuda_path_tracer_2025_tpu_torch/csrc``
(one ``nvcc`` per library, started together), holds each against its plain
PyTorch version on the card, drives the main paths with the launch counters
reset -- the prim path (``Renderer`` on ``scenes/cornell_dof.json`` at
800x800, depth 8, and ``megakernel_iteration``, phases 1-7) and the mesh
path (``Renderer`` on ``scenes/cornell_mesh_5k.json`` at 800x800, depth 8,
phase 8) -- checks the results against the committed golden films, and
times the kernel paths against the plain versions with CUDA events.  Any
failure raises and exits non-zero.

Output: progress lines, then the card's ``nvidia-smi`` name and power
limit, then one JSON line describing the kernels, and last one JSON line
``{"ok": true, "device": {...}}``.  Needs no JAX and no network.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

PKG = "project3_cuda_path_tracer_2025_tpu_torch"
SCENE = ROOT / "scenes" / "cornell_dof.json"
SCENE_LOBES = ROOT / "scenes" / "cornell_all_lobes.json"
GOLDEN = ROOT / "tests" / "goldens" / "dof.npz"
MESH_SCENE = ROOT / "scenes" / "cornell_mesh_5k.json"
MESH_GOLDEN = ROOT / "tests" / "torch_goldens" / "mesh5k.npz"
OUT_DIR = ROOT / "build" / "chip_smoke"

# The card's published peaks (H100 SXM data sheet, at 700 W): HBM bytes/s
# and float32 operations/s outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12

# Float32 operations per call of the kernels' device functions, counted
# from csrc/prim_path.cuh and csrc/mesh_path.cuh: each add, multiply,
# division, square root, sin/cos, min/max, compare and abs is one, an fma
# two.  Transforms are counted at their folded minimum (a scale and a
# translation per row), scatter at the diffuse lobe, and integer work
# (Threefry, key packing) is left out, so the bounds are lower bounds.
OPS_BOX, OPS_SPHERE = 78, 60  # box_t, sphere_t
OPS_NEAREST = 25  # intersect_prims around the tests: compares, winner normal, flip
OPS_SCATTER = 100  # scatter (diffuse lobe, new origin, throughput)
OPS_RAYGEN = 45
OPS_MONO_RAY = 60  # features, reciprocal direction, root cull
OPS_MONO_TILE = 35  # member slab of one tile
OPS_MONO_PAIR = 41  # 19 fma, division, t, the acceptance tests
OPS_KEY_TILE, OPS_KEY_RAY = 28, 60  # coherence_key per tile / per ray
OPS_MERGE = 10  # mesh-hit merge and normal flip

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
TIMING_ROUNDS = 8


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls, by CUDA events."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def bound_ms(nbytes: float, ops: float) -> tuple:
    """The least time the card could take: (ms, "bytes" | "operations")."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def prim_ops(static) -> int:
    """Operations of one intersect_prims call over the scene's prims."""
    from project3_cuda_path_tracer_2025_tpu_torch.scene.types import GeomType

    return OPS_NEAREST + sum(
        OPS_BOX if g.gtype == int(GeomType.CUBE) else OPS_SPHERE for g in static.geoms
    )


def film_np(film) -> np.ndarray:
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


def profile_paths(paths: dict, frames: int = 3) -> None:
    """Phase 9: ``torch.profiler`` over ``frames`` back-to-back frames of
    each path (name -> zero-argument frame function): device busy time per
    frame (the sum of the kernels' and copies' device time; one stream, so
    nothing overlaps), wall time per frame under the profiler (inflated by
    its own host overhead), device launches per frame and the top device
    functions."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for name, fn in paths.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(frames):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / frames
        dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in dev) / 1e3 / frames
        count = sum(e.count for e in dev) / frames
        top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
        log(f"[9] {name}: device busy {busy:.4f} ms/frame, wall under the profiler "
            f"{wall:.4f} ms/frame ({busy / wall:.1%} busy), {count:.0f} device launches/frame")
        for e in top:
            log(f"      {e.self_device_time_total / 1e3 / frames:9.4f} ms/frame "
                f"x{e.count / frames:5.1f}  {e.key[:90]}")


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

    # -- 8a/8b. both kernels against their plain versions, on the camera rays
    #    and two bounces, in the main path's (sorted) order ----------------
    mono_err, shade_err = 0.0, 0.0
    mono_case = shade_case = None
    for d in range(3):
        tl = prim_t_min(static, cfg, paths.origin, paths.direction)
        perm = intersect_mxu.coherence_perm(tables, paths.origin, paths.direction, paths.alive,
                                            tl, cfg.ray_sort_bits, cfg.ray_sort_dir_bits,
                                            mode="signature")
        paths, (tl,) = permute_path_state(paths, perm, extra=(tl,))
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
        mt, mn, mm = fused.mesh_surface(tables, static, cfg, paths, tl)
        skey = prng.stage_key(ik, d, 1)
        for emit in fused.EMIT_MODES:
            sargs = (prim_static, cfg, paths, mt, mn, mm, skey, n, emit, tables.tile_aabb,
                     tables.center)
            got = fused.fused_mesh_shade(*sargs)
            want = fused.fused_mesh_shade_plain(*sargs)
            torch.cuda.synchronize()
            (gp, gc), (wp, wc) = (got, want) if emit else ((got, None), (want, None))
            fk = [*gp.origin, *gp.direction, *gp.color] + ([gc[0]] if emit else [])
            fp = [*wp.origin, *wp.direction, *wp.color] + ([wc[0]] if emit else [])
            lane_bad = torch.zeros(n, dtype=torch.bool, device=device)
            for a, b in zip(fk, fp):
                lane_bad |= ~torch.isclose(a, b, rtol=STAGE_RTOL, atol=STAGE_ATOL)
            bn_diff = int((gp.bounces != wp.bounces).sum())
            key_diff = int((gc[1] != wc[1]).sum()) if emit == "tlim+key" else 0
            err = max(float((a - b).abs().max()) for a, b in zip(fk, fp))
            share = float(lane_bad.float().mean())
            log(f"[8b] shade bounce {d} emit={emit or 'none'}: max abs diff {err:.3g}; lanes "
                f"with bounces differing {bn_diff}, keys differing {key_diff}, lanes outside "
                f"rtol={STAGE_RTOL} atol={STAGE_ATOL}: {share:.5%}")
            if key_diff or bn_diff / n > MAX_STAGE_LANE_SHARE or share > MAX_STAGE_LANE_SHARE:
                raise AssertionError("the mesh-shade kernel disagrees with its plain version")
            shade_err = max(shade_err, err)
            if emit == "tlim+key" and shade_case is None:
                shade_case = sargs
        paths = want[0]

    # -- 8c. one frame: the kernel path against the plain fused-mesh path,
    #    and sorted against unsorted ----------------------------------------
    base_key = prng.prng_key(0)
    frame = lambda c, plain=False: megakernel_iteration(
        dev, static, c, cam, film_ops.new_film(n, device), 1, base_key, plain=plain)
    film_s, alive_s = frame(cfg)
    film_u, alive_u = frame(RenderConfig(ray_sorting="off"))
    film_p, alive_p = frame(cfg, plain=True)
    torch.cuda.synchronize()
    log("[8c] one frame, kernel path vs the plain fused-mesh path (megakernel_iteration "
        "plain=True):")
    r_frame = compare_films("sorted kernel path vs plain", film_s, film_p)
    sorted_eq = all(torch.equal(a, b) for a, b in zip(film_s, film_u))
    log(f"  sorted and unsorted kernel films bit-identical: {sorted_eq}; alive per depth "
        f"kernel {alive_s.tolist()}, plain {alive_p.tolist()}")
    alive_rel = np.abs(alive_s.cpu().numpy() - alive_p.cpu().numpy()) / np.maximum(
        alive_p.cpu().numpy(), 1)
    if not (sorted_eq and torch.equal(alive_s, alive_u) and r_frame["finite"]
            and r_frame["sum_rel"] <= MAX_SUM_REL and r_frame["pixel_share"] <= MAX_PIXEL_SHARE
            and (alive_rel <= MAX_ALIVE_REL).all()):
        raise AssertionError("the mesh kernel path disagrees with the plain path")

    # -- 8d. the main path, counters reset ---------------------------------
    counters = (intersect_mxu.mono_intersect, fused.fused_mesh_shade,
                fused.fused_prim_iteration, fused.fused_prim_bounce)
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
            launches["fused_prim_iteration"], launches["fused_prim_bounce"]) != (
            4 * depth, 4 * depth, 0, 0):
        raise AssertionError("the mesh Renderer did not take the mesh kernels 8 times per spp")
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
        "mesh-shade kernel (1 bounce)": (lambda: fused.fused_mesh_shade(*shade_case), 20),
        "plain mesh shade (1 bounce)": (lambda: fused.fused_mesh_shade_plain(*shade_case), 1),
    }
    rounds = {k: (3 if k.startswith("plain") else TIMING_ROUNDS) for k in paths_t}
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
    tabs, _, ro, rd, active, tl, _ = mono_case
    act = active & intersect_mxu.root_hit_mask(tabs.tile_aabb, tabs.center, *ro, *rd, tl)
    osv = type(ro)(ro.x - tabs.center[0], ro.y - tabs.center[1], ro.z - tabs.center[2])
    inv = intersect_mxu._inv_dir(rd)
    pairs = 0
    for row in tabs.tile_aabb.tolist():
        member, _, _ = intersect_mxu._member_slab(row, osv, inv, tl)
        pairs += int((member & act).sum())
    mono_bound = bound_ms(
        n * (6 * 4 + 1 + 4 + 8) + tabs.coef.numel() * 4 + tabs.tile_aabb.numel() * 4,
        n * OPS_MONO_RAY + int(act.sum()) * ct * OPS_MONO_TILE
        + pairs * intersect_mxu.TRI_TILE * OPS_MONO_PAIR,
    )
    live = int(shade_case[2].alive.sum())
    shade_bound = bound_ms(
        n * (16 + 12) * 4,  # 16 planes in, 12 out
        live * (prim_ops(prim_static) + OPS_MERGE + OPS_SCATTER)
        + n * (prim_ops(prim_static) + OPS_KEY_RAY + ct * OPS_KEY_TILE),
    )
    log(f"    bounds: mono kernel {mono_bound[0]:.4f} ms ({mono_bound[1]}; {pairs} candidate "
        f"(ray, tile) pairs of {int(act.sum())} root-hitting rays), mesh-shade kernel "
        f"{shade_bound[0]:.4f} ms ({shade_bound[1]}; {live} live rays)")

    profiled = {
        "mesh kernel path, sorted": paths_t["mesh kernel path, sorted"][0],
        "mesh kernel path, unsorted": paths_t["mesh kernel path, unsorted"][0],
    }
    return [
        {
            "name": "mono_intersect",
            "route": "cuda",
            "source": f"{PKG}/csrc/fused_mesh.cu",
            "replaces": "project3_cuda_path_tracer_2025_tpu/ops/intersect_mxu.py:1423",
            "launches": launches["mono_intersect"],
            "max_abs_err": mono_err,
            "ms": ms["mono kernel (1 bounce)"],
            "plain_ms": ms["plain mono (1 bounce)"],
            "bound_ms": mono_bound[0],
            "bound_by": mono_bound[1],
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA GPU",
              file=sys.stderr)
        return 2

    from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer, megakernel_iteration
    from project3_cuda_path_tracer_2025_tpu_torch.ops import camera as camera_ops
    from project3_cuda_path_tracer_2025_tpu_torch.ops import fused, kernels
    from project3_cuda_path_tracer_2025_tpu_torch.ops import film as film_ops
    from project3_cuda_path_tracer_2025_tpu_torch.scene import (
        build_device_scene, camera_state, derive_render_camera, load_scene,
        set_resolution,
    )
    from project3_cuda_path_tracer_2025_tpu_torch.utils import prng

    device = torch.device("cuda:0")
    smi = nvidia_smi()
    log(f"[1] card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    libs = kernels.load_all()
    log(f"[2] built {len(libs)} libraries for sm_90a in parallel in "
        f"{time.perf_counter() - t0:.1f} s")
    for lib in libs.values():
        log(f"    {lib.path.relative_to(ROOT)}: nvcc {lib.build_seconds:.1f} s")
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log("    ptxas: " + line.strip())

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

    # -- 4. bounce kernel vs plain ------------------------------------------
    bounce_err = 0.0
    bounce_case = None
    for path in (SCENE, SCENE_LOBES):
        scene = load_scene(str(path))
        _, static = build_device_scene(scene, device)
        cfg = RenderConfig()
        cam = camera_state(derive_render_camera(scene.state.camera))
        n = static.pixel_count
        ik = prng.iteration_key(prng.prng_key(0), 1)
        cam_u = prng.uniforms_at(prng.stage_key(ik, 0, 0), torch.arange(n, device=device), 4, n)
        paths = camera_ops.generate_camera_rays(
            cam, static.width, static.height, static.trace_depth, cam_u)
        for d in range(2):
            su = prng.uniforms_at(prng.stage_key(ik, d, 1), torch.arange(n, device=device), 3, n)
            if bounce_case is None:  # timed in phase 7
                bounce_case = (static, cfg, paths, su)
            out_k = fused.fused_prim_bounce(static, cfg, paths, su)
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
            log(f"[4] bounce {d} {path.name} {static.width}x{static.height}: max abs diff "
                + " ".join(f"{k}={v:.3g}" for k, v in diffs.items())
                + f"; lanes with bounces differing: {bn_diff}; lanes outside "
                f"rtol={STAGE_RTOL} atol={STAGE_ATOL}: {share:.5%}")
            if bn_diff / n > MAX_STAGE_LANE_SHARE or share > MAX_STAGE_LANE_SHARE:
                raise AssertionError(
                    f"bounce kernel disagrees with its plain version on {path.name}")
            bounce_err = max(bounce_err, max(diffs.values()))
            paths = out_p

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

    b_static, b_cfg, b_paths, b_su = bounce_case

    def run_bounce_kernel():
        fused.fused_prim_bounce(b_static, b_cfg, b_paths, b_su)

    def run_bounce_plain():
        fused.fused_prim_bounce_plain(b_static, b_cfg, b_paths, b_su)

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
    nb = b_paths.pixel.shape[0]
    b_bound = bound_ms(nb * 92, nb * (prim_ops(b_static) + OPS_SCATTER))
    log(f"    bounds: iteration kernel {it_bound[0]:.4f} ms ({it_bound[1]}), "
        f"bounce kernel {b_bound[0]:.4f} ms ({b_bound[1]})")

    mesh_kernels, mesh_frames = mesh_phases(device, smi)
    profile_paths({
        "prim iteration kernel (Renderer default)": run_iter_kernel,
        "prim bounce-kernel path": run_bounce_path,
        **mesh_frames,
    })

    result = {"kernels": [
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
        *mesh_kernels,
    ]}
    print(smi)
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
