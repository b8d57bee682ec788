"""Packet-binned traversal measurement on the PyTorch/CUDA port (the port's
counterpart of ``scripts/bench_binned.py``): the intersect stage binned
against streamed on a mid-bounce population, bit-identity asserted (the
per-ray candidate contract), and with ``--profile`` the stages of the binned
pipeline (bins, kernel, reduce) and a sweep over the slot-list length.

The JAX script rebinds its module's ``PTT_BINNED_*`` globals; here the
pair budget, the slot-list length and the tiers are arguments of the stage
functions (``packet_bins``, ``binned_intersect``, ``mesh_intersect_mxu``).

    python scripts/torch_bench_binned.py scenes/cornell_mesh_200k.json [more.json]
    python scripts/torch_bench_binned.py --profile --depth 4 --tier 4 SCENE.json
    python scripts/torch_bench_binned.py --device cpu --res 8 --depth 1 scenes/cornell_mesh_20k.json
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.ops import intersect_mxu as mxu  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.ops.intersect import prim_t_min  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.scene import load_scene, set_resolution  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.utils import measure  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.utils.vec import Vec3  # noqa: E402


def mid_bounce_population(scn, res, depth, cfg, device):
    """Camera rays advanced ``depth`` bounces: the incoherent population the
    binned path targets."""
    path = scn if os.path.isabs(scn) else os.path.join(REPO, scn)
    r = Renderer(set_resolution(load_scene(path), res, res), cfg, device=device)
    paths = measure.advance_population(r, cfg, depth)
    t_lim = prim_t_min(r.static, cfg, paths.origin, paths.direction)
    print(f"\n=== {scn}: {r.static.num_triangles} tris, live {int(paths.alive.sum())}/"
          f"{r.static.pixel_count} (depth {depth}) ===", flush=True)
    return r, paths, t_lim


def ab_compare(scn, args, device) -> list:
    cfg = RenderConfig(mesh_intersector="mxu")
    r, paths, t_lim = mid_bounce_population(scn, args.res, args.depth, cfg, device)
    ntri, ptri = r.static.num_triangles, r.static.mxu_padded_tris

    def isect(mode_kw):
        return mxu.mesh_intersect_mxu(
            r.dev.mxu_mesh, ntri, ptri, paths.origin, paths.direction, paths.alive, t_lim,
            cfg.baby_epsilon, sort_rays=True, mesh_bounds=r.static.mesh_bounds,
            compute_uv=False, sort_mode="signature", **mode_kw)

    modes = {"streamed": dict(planned=True, streamed=True),
             "binned": dict(planned=True, streamed=True, binned=True,
                            binned_tiers=cfg.mxu_binned_tiers,
                            binned_budget_rays=r.static.pixel_count)}
    outs = {name: isect(kw) for name, kw in modes.items()}
    same_t = bool((outs["streamed"].t.view(torch.int32) == outs["binned"].t.view(torch.int32)).all())
    same_tri = bool((outs["streamed"].tri == outs["binned"].tri).all())
    print(f"bitexact t: {same_t}  tri: {same_tri}", flush=True)
    if not (same_t and same_tri):
        raise SystemExit("binned and streamed disagree: nothing is timed")
    before = mxu.binned_intersect.launches
    recs = measure.stage_records(
        "torch_bench_binned", device,
        {f"{name} intersect": (lambda kw=kw: isect(kw)) for name, kw in modes.items()},
        args.k, scene=os.path.basename(scn), res=args.res, depth=args.depth, bitexact=True)
    print(f"binned kernel launches while timing: {mxu.binned_intersect.launches - before}",
          flush=True)
    return recs


def profile(scn, args, device) -> list:
    """Stage-level profile over the sorted live prefix (tier 1/``--tier``)."""
    cfg = RenderConfig(mesh_intersector="mxu")
    r, paths, t_lim = mid_bounce_population(scn, args.res, args.depth, cfg, device)
    tab, n = r.dev.mxu_mesh, r.static.pixel_count
    ct = tab.tile_aabb.shape[0]
    ro, rd = paths.origin, paths.direction
    perm = mxu.coherence_perm(tab, ro, rd, paths.alive, t_lim, cfg.ray_sort_bits,
                              cfg.ray_sort_dir_bits, mode="signature")
    g = lambda a: a[perm].contiguous()
    ro, rd, tl = Vec3(*map(g, ro)), Vec3(*map(g, rd)), g(t_lim)
    live = g(paths.alive) & mxu.root_hit_mask(tab, ro, rd, tl)
    pr = mxu.plan_rays(tab, ro, rd, live, tl)
    n_pad = pr.tl.shape[0]
    npre = min(n_pad, ((n_pad // args.tier + mxu.RAY_TILE - 1) // mxu.RAY_TILE) * mxu.RAY_TILE)
    n_g = npre // mxu.BINNED_G
    cut = lambda v: Vec3(*(x[:npre] for x in v))
    # The production budget: anchored on max(npre, n / 4), whatever the tier.
    budget = mxu.pair_budget(max(npre, n_pad // 4), ct)

    def bins(topk=mxu.BINNED_TOPK):
        return mxu.packet_bins(tab.tile_aabb, cut(pr.os), cut(pr.d), pr.live[:npre],
                               pr.tl[:npre], budget, topk)

    b = bins()
    gp = mxu.RAY_TILE // mxu.BINNED_G
    print(f"  pairs: budget {budget}  used {int((b.vt >= 0).sum()) * gp}  "
          f"overflow {bool(b.overflow)}", flush=True)
    visits = lambda bb: mxu.binned_intersect(tab, ro, rd, live, tl, bb.vt, bb.src, n_g,
                                             cfg.baby_epsilon)
    pt, ptri = visits(b)

    def e2e(topk):
        bb = bins(topk)
        return mxu.binned_reduce(*visits(bb), bb, pr.tl[:npre], n_g)

    stages = {
        "packet_bins": bins,
        "binned kernel": lambda: visits(b),
        "binned_reduce": lambda: mxu.binned_reduce(pt, ptri, b, pr.tl[:npre], n_g),
        "binned e2e": lambda: e2e(mxu.BINNED_TOPK),
    }
    for topk in (0, 96, 128, 10**6):  # the variant sweep: slot-list length
        stages[f"e2e topk={topk}"] = lambda topk=topk: e2e(topk)
    return measure.stage_records("torch_bench_binned", device, stages, args.k,
                                 scene=os.path.basename(scn), res=args.res, depth=args.depth,
                                 tier=args.tier, prefix_rays=npre, pair_budget=budget)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scenes", nargs="+")
    ap.add_argument("--res", type=int, default=800)
    ap.add_argument("--depth", type=int, default=2, help="bounces to advance before measuring")
    ap.add_argument("--k", type=int, default=8, help="timed calls per stage")
    ap.add_argument("--profile", action="store_true",
                    help="stage-level profile instead of the A/B")
    ap.add_argument("--tier", type=int, default=4, help="profile: live-prefix divisor")
    measure.add_device_argument(ap)
    args = ap.parse_args(argv)
    device = measure.open_device(args.device)
    print(f"device: {device} ({measure.card_label(device)})", flush=True)
    for scn in args.scenes:
        (profile if args.profile else ab_compare)(scn, args, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
