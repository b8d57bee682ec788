"""Mesh-traversal diagnostics on the PyTorch/CUDA port (the port's
counterpart of ``scripts/diag_mesh_traversal.py``): where does a heavy-mesh
bounce go?

For a mid-bounce ray population (camera rays after one bounce), per sort
mode (off / morton / signature):

  * per-ray candidate-tile counts (the per-ray floor of any traversal),
  * per-block candidate UNION sizes (what a planned walk visits), summed
    over the chunks of a mesh beyond 32 tiles,
  * stage timings: key + argsort, root cull, the plan, the whole intersect.

One JSON line per sort mode with the counts, one per timed stage.

    python scripts/torch_diag_mesh_traversal.py --scene scenes/cornell_mesh_80k.json
    python scripts/torch_diag_mesh_traversal.py --device cpu --res 8 --k 1 \
        --scene scenes/cornell_mesh_20k.json
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.ops import intersect_mxu as mxu  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.ops.intersect import prim_t_min  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.scene import load_scene, set_resolution  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.utils import measure  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.utils.vec import Vec3  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default="scenes/cornell_mesh_80k.json")
    ap.add_argument("--res", type=int, default=800)
    ap.add_argument("--k", type=int, default=8, help="timed calls per stage")
    measure.add_device_argument(ap)
    args = ap.parse_args(argv)
    device = measure.open_device(args.device)
    card = measure.card_label(device)

    path = args.scene if os.path.isabs(args.scene) else os.path.join(REPO, args.scene)
    cfg = RenderConfig(mesh_intersector="mxu", ray_sorting="off")
    r = Renderer(set_resolution(load_scene(path), args.res, args.res), cfg, device=device)
    static, n, tables = r.static, r.static.pixel_count, r.dev.mxu_mesh
    ct = tables.tile_aabb.shape[0]
    common = dict(script="torch_diag_mesh_traversal", scene=os.path.basename(args.scene),
                  res=args.res, rays=n, tiles=ct, device=str(device), card=card)
    print(f"{args.scene}: {static.num_triangles} tris, {ct} tiles, {n} rays, device={device} "
          f"({card})", flush=True)

    paths = measure.advance_population(r, cfg, 1)
    ro, rd, active = paths.origin, paths.direction, paths.alive
    t_lim = prim_t_min(static, cfg, ro, rd)
    live = active & mxu.root_hit_mask(tables, ro, rd, t_lim)

    # ---- per-ray candidate counts (the k = 2 slab test the plan uses) ----
    pr = mxu.plan_rays(tables, ro, rd, live, t_lim)
    cnt_r = torch.zeros_like(pr.tl, dtype=torch.int32)
    for h, _ in mxu._pair_slabs(tables.tile_aabb, pr.os, pr.d, pr.live, pr.tl):
        cnt_r += h.sum(dim=1, dtype=torch.int32)
    cr = cnt_r[:n][live].cpu().numpy()
    n_live = int(live.sum())
    pct = lambda a, q: float(np.percentile(a, q)) if a.size else 0.0
    print(f"live rays: {n_live}/{n} ({100.0 * n_live / n:.1f}%)")
    print(f"per-ray candidates: mean {cr.mean() if cr.size else 0:.2f}  p50 {pct(cr, 50):.0f}  "
          f"p90 {pct(cr, 90):.0f}  p99 {pct(cr, 99):.0f}  max {cr.max() if cr.size else 0}  "
          f"sum {int(cr.sum())}")

    # ---- per-block unions under each sort ----
    chunk_tiles = min(ct, mxu.PLANNED_MAX_TILES)
    for mode in ("off", "morton", "signature"):
        if mode == "off":
            perm = torch.arange(n, device=device)
        else:
            perm = mxu.coherence_perm(tables, ro, rd, active, t_lim, cfg.ray_sort_bits,
                                      cfg.ray_sort_dir_bits, mode=mode)
        g = lambda a: a[perm]
        p = mxu.plan_rays(tables, Vec3(*map(g, ro)), Vec3(*map(g, rd)), g(live), g(t_lim))
        per_block = sum(
            mxu.build_tile_plan(tables.tile_aabb[g0:g0 + chunk_tiles], *p).cnt.long()
            for g0 in range(0, ct, chunk_tiles))
        blk_live = p.live.reshape(-1, mxu.RAY_TILE).any(dim=1)
        ub = per_block[blk_live].cpu().numpy()
        rec = dict(sort=mode, live_blocks=int(blk_live.sum()), blocks=int(blk_live.shape[0]),
                   union_mean=float(ub.mean()) if ub.size else 0.0, union_p50=pct(ub, 50),
                   union_p90=pct(ub, 90), union_max=int(ub.max()) if ub.size else 0,
                   union_sum=int(per_block.sum()), per_ray_sum=int(cr.sum()),
                   per_ray_floor_blocks=float(cr.sum()) / mxu.RAY_TILE, **common)
        measure.emit(rec)

    # ---- stage timings ----
    def intersect(sort_mode):
        return mxu.mesh_intersect_mxu(
            tables, static.num_triangles, static.mxu_padded_tris, ro, rd, active, t_lim,
            cfg.baby_epsilon, sort_rays=True, mesh_bounds=static.mesh_bounds, compute_uv=False,
            planned=True, sort_mode=sort_mode)

    stages = {
        f"key+argsort ({m})": (lambda m=m: mxu.coherence_perm(
            tables, ro, rd, active, t_lim, cfg.ray_sort_bits, cfg.ray_sort_dir_bits, mode=m))
        for m in ("signature", "morton")
    }
    stages["root cull alone"] = lambda: mxu.root_hit_mask(tables, ro, rd, t_lim)
    stages["plan (all chunks)"] = lambda: [
        mxu.build_tile_plan(tables.tile_aabb[g0:g0 + chunk_tiles], *pr)
        for g0 in range(0, ct, chunk_tiles)]
    stages["FULL intersect (signature)"] = lambda: intersect("signature")
    stages["FULL intersect (morton)"] = lambda: intersect("morton")
    measure.stage_records("torch_diag_mesh_traversal", device, stages, args.k,
                          **{k: v for k, v in common.items() if k not in ("script", "device",
                                                                          "card")})
    return 0


if __name__ == "__main__":
    sys.exit(main())
