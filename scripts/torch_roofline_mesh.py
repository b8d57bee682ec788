"""Traversal roofline on the 5k mesh for the PyTorch/CUDA port (the port's
counterpart of ``scripts/roofline_mesh.py``).

Times the traversal ``mxu_traversal="auto"`` resolves to (on the 5k mesh
the mono walk, ``ptt_mono_kernel``) on the mid-bounce population of the
measuring scripts (``utils/measure.py::advance_population``: iteration 1's
camera rays after one bounce), sorted by the signature key as the frame
sorts it, over ``--k`` back-to-back calls by CUDA events.  Prints ONE JSON
line, which ``bench_torch.py`` merges into its own:

  kernel_ms_per_bounce  ms per traversal call (null on the CPU)
  visits                (ray block, tile) visits of the port's block
                        schedule: for mono every tile of each block with a
                        live, root-hitting ray; else the plan's entries
  plan_visits           the tile plan's entries over the same rays
  live_blocks           256-ray blocks the walk does not skip
  us_per_visit          kernel time per visit
  bound_ms, bound_by    the least time the card could take for the mono
                        walk's work on these rays (``utils/measure.py``'s
                        ``mono_work``: bytes over the card's memory rate
                        against float32 operations over its peak; null for
                        another traversal)
  share_of_bound        bound_ms / kernel_ms_per_bounce
  hbm_gbps              the bound's bytes over the kernel time
  card                  ``nvidia-smi``'s name and power limit

    python scripts/torch_roofline_mesh.py [--scene scenes/cornell_mesh_5k.json --res 800 --k 16]
    python scripts/torch_roofline_mesh.py --device cpu --res 8   # the plain walk, no times
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
from project3_cuda_path_tracer_2025_tpu_torch.scene import load_scene, set_resolution  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.utils import measure  # noqa: E402
from torch_profile_epilogue import capture_population  # noqa: E402


def run(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default="scenes/cornell_mesh_5k.json")
    ap.add_argument("--res", type=int, default=800)
    ap.add_argument("--k", type=int, default=16, help="timed traversal calls")
    measure.add_device_argument(ap)
    args = ap.parse_args(argv)
    device = measure.open_device(args.device)

    scene = set_resolution(load_scene(args.scene), args.res, args.res)
    cfg = RenderConfig(mesh_intersector="mxu", ray_sorting="off")
    r = Renderer(scene, cfg, device=device)
    static, tables = r.static, r.dev.mxu_mesh
    ct = tables.tile_aabb.shape[0]
    mode = mxu.resolve_traversal_mode("auto", static.mxu_padded_tris)
    flags = mxu.traversal_flags("auto", static.mxu_padded_tris,
                                binned_tiers=cfg.mxu_binned_tiers,
                                binned_budget_rays=static.pixel_count)
    paths, tl, live = capture_population(r, cfg, bounce0=False)
    ro, rd = paths.origin, paths.direction

    def traverse():
        return mxu.mesh_intersect_mxu(tables, static.num_triangles, static.mxu_padded_tris,
                                      ro, rd, live, tl, cfg.baby_epsilon, compute_uv=False,
                                      **flags)

    # Visits of the port's block schedule, from the same plan machinery.
    plan = mxu.plan_with_prefix(tables.tile_aabb, *mxu.plan_rays(tables, ro, rd, live, tl))
    plan_visits = int(plan.cnt.sum())
    if mode == "mono":
        block = torch.arange(live.shape[0], device=device) // mxu.RAY_TILE
        nb = int(block[-1]) + 1
        live_blocks = int((torch.zeros(nb, dtype=torch.int32, device=device)
                           .index_add(0, block, live.to(torch.int32)) > 0).sum())
        visits = live_blocks * ct
        nbytes, ops, _, _ = measure.mono_work((tables, static.num_triangles, ro, rd, live, tl,
                                               cfg.baby_epsilon))
        b_ms, b_by = measure.bound_ms(nbytes, ops)
    else:
        live_blocks, visits = int((plan.cnt > 0).sum()), plan_visits
        nbytes = b_ms = b_by = None

    ms = measure.timed_ms(device, traverse, args.k)
    sec = None if ms is None else ms / 1e3
    return measure.emit({
        "script": "torch_roofline_mesh",
        "mesh_scene": os.path.basename(args.scene),
        "traversal": mode,
        "kernel_ms_per_bounce": ms,
        "visits": visits,
        "plan_visits": plan_visits,
        "live_blocks": live_blocks,
        "us_per_visit": None if ms is None else ms * 1e3 / max(visits, 1),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "share_of_bound": None if ms is None or b_ms is None else b_ms / ms,
        "hbm_gbps": None if sec is None or nbytes is None else nbytes / sec / 1e9,
        "rays": static.pixel_count,
        "live_rays": int(live.sum()),
        "tiles": ct,
        "k": args.k,
        "card": measure.card_label(device),
    })


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
