"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``project3_cuda_path_tracer_2025_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, drives the main
path (``Renderer`` on ``scenes/cornell_dof.json`` at 800x800, depth 8, and
``megakernel_iteration``) with the launch counters reset, checks the result
against the committed golden film, and times the kernel paths against the
plain path with CUDA events.  Any failure raises and exits non-zero.

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
OUT_DIR = ROOT / "build" / "chip_smoke"

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
    lib = kernels.load()
    log(f"[2] built {lib.path.relative_to(ROOT)} for sm_90a in {lib.build_seconds:.1f} s "
        f"(load {time.perf_counter() - t0:.1f} s)")
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
        },
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
