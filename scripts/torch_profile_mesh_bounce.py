"""Per-stage profile of the fused mesh bounce on the PyTorch/CUDA port (the
port's counterpart of ``scripts/profile_mesh_bounce.py``).

Stages, timed independently with CUDA events on a mid-bounce population
(camera rays after one bounce):

  prim_t_min | signature key build | argsort | coherence_perm | permute
  apply | RNG draws | tile plan (torch, and with the prepass kernel) | mesh
  intersect on the SORTED state under "auto" and under each other traversal
  | unsorted A/B | attribute resolve | WHOLE fused bounce (sorted)

    python scripts/torch_profile_mesh_bounce.py --scene scenes/cornell_mesh_5k.json
    python scripts/torch_profile_mesh_bounce.py --device cpu --res 8 --k 1
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.ops import fused  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.ops import intersect_mxu as mxu  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.ops.compaction import permute_path_state  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.ops.intersect import prim_t_min  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.scene import load_scene, set_resolution  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.utils import measure, prng  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default="scenes/cornell_mesh_5k.json")
    ap.add_argument("--res", type=int, default=800)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--only", default=None, help="comma-separated substrings of stage names")
    measure.add_device_argument(ap)
    args = ap.parse_args(argv)
    device = measure.open_device(args.device)

    path = args.scene if os.path.isabs(args.scene) else os.path.join(REPO, args.scene)
    cfg = RenderConfig(mesh_intersector="mxu", ray_sorting="off")
    r = Renderer(set_resolution(load_scene(path), args.res, args.res), cfg, device=device)
    static, n, tables = r.static, r.static.pixel_count, r.dev.mxu_mesh
    ct = tables.tile_aabb.shape[0]
    print(f"{args.scene}: {static.num_triangles} tris, {ct} tiles, {n} rays, device={device} "
          f"({measure.card_label(device)})", flush=True)

    paths = measure.advance_population(r, cfg, 1)
    skey = prng.stage_key(prng.iteration_key(r._base_key, 1), 1, 1)
    flags = lambda mode: mxu.traversal_flags(mode, static.mxu_padded_tris,
                                             binned_tiers=cfg.mxu_binned_tiers,
                                             binned_budget_rays=n)
    t_lim0 = prim_t_min(static, cfg, paths.origin, paths.direction)
    key = lambda: mxu.signature_key(tables, paths.origin, paths.direction, paths.alive, t_lim0)
    key0 = key()
    perm = lambda: mxu.coherence_perm(tables, paths.origin, paths.direction, paths.alive, t_lim0,
                                      cfg.ray_sort_bits, cfg.ray_sort_dir_bits,
                                      mode="signature")
    perm0 = perm()
    # The kernel's production conditions: the persistent sort has packed the state.
    s_paths, (s_tlim,) = permute_path_state(paths, perm0, extra=(t_lim0,))
    s_live = s_paths.alive & mxu.root_hit_mask(tables, s_paths.origin, s_paths.direction, s_tlim)
    pr = mxu.plan_rays(tables, s_paths.origin, s_paths.direction, s_live, s_tlim)

    def isect(p, tl, mode):
        return mxu.mesh_intersect_mxu(
            tables, static.num_triangles, static.mxu_padded_tris, p.origin, p.direction,
            p.alive, tl, cfg.baby_epsilon, sort_rays=False, mesh_bounds=static.mesh_bounds,
            compute_uv=False, **flags(mode))

    mh0 = isect(s_paths, s_tlim, "auto")
    stages = {
        "prim_t_min": lambda: prim_t_min(static, cfg, paths.origin, paths.direction),
        "signature key build": key,
        "argsort(key)": lambda: torch.argsort(key0, stable=True),
        "coherence_perm (key+sort)": perm,
        "permute apply (per-field gather)": lambda: permute_path_state(paths, perm0,
                                                                       extra=(t_lim0,)),
        "rng uniforms_at x3": lambda: prng.uniforms_at(skey, paths.pixel, 3, n),
        "tile plan (torch)": lambda: mxu.plan_with_prefix(tables.tile_aabb, *pr, impl="xla")
        if ct <= mxu.STREAMED_MAX_TILES else None,
        "tile plan (prepass kernel)": lambda: mxu.plan_with_prefix(tables.tile_aabb, *pr,
                                                                   impl="pallas")
        if ct <= mxu.STREAMED_MAX_TILES else None,
        "mesh intersect auto (SORTED state)": lambda: isect(s_paths, s_tlim, "auto"),
    }
    for alt in ("sweep", "planned", "streamed", "binned"):
        if flags(alt) != flags("auto"):
            stages[f"mesh intersect {alt} (sorted)"] = lambda alt=alt: isect(s_paths, s_tlim, alt)
    stages.update({
        "mesh intersect auto (unsorted A/B)": lambda: isect(paths, t_lim0, "auto"),
        "attr resolve (shade rows gather)": lambda: mxu.resolve_shade_attributes(
            tables, static.mxu_padded_tris, mh0.tri),
        "WHOLE fused bounce (sorted)": lambda: fused.fused_mesh_bounce(
            r.dev, static, cfg.replace(ray_sorting="on"), paths, su_key=skey, resort=True,
            rng_n=n),
    })
    measure.stage_records("torch_profile_mesh_bounce", device, stages, args.k, args.only,
                          scene=os.path.basename(args.scene), res=args.res, rays=n, tiles=ct,
                          live=int(s_live.sum()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
