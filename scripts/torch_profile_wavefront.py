"""Per-stage profile of the wavefront integrator on the PyTorch/CUDA port
(the port's counterpart of ``scripts/profile_wavefront.py``).

Times each bounce stage in isolation on a mid-bounce state (camera rays
after one bounce): raygen, intersect, intersect + shade, the compaction split
into scan / permutation build / apply, the material sort, and a whole bounce.
CUDA events over ``--k`` back-to-back calls; one JSON line per stage.

    python scripts/torch_profile_wavefront.py [--res 800 --k 32]
    python scripts/torch_profile_wavefront.py --device cpu --res 8 --k 1
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.ops import camera as camera_ops  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.ops import scan as scan_ops  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.ops import shade as shade_ops  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.ops.compaction import (  # noqa: E402
    compact_paths, front_pack_permutation, permute_path_state, sort_paths_by_material,
)
from project3_cuda_path_tracer_2025_tpu_torch.ops.intersect import intersect_scene  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.scene import load_scene, set_resolution  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.utils import measure, prng  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--res", type=int, default=800)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--scene", default="scenes/cornell_dof.json")
    ap.add_argument("--only", default=None, help="comma-separated substrings of stage names")
    measure.add_device_argument(ap)
    args = ap.parse_args(argv)
    device = measure.open_device(args.device)

    path = args.scene if os.path.isabs(args.scene) else os.path.join(REPO, args.scene)
    cfg = RenderConfig(integrator="wavefront")
    r = Renderer(set_resolution(load_scene(path), args.res, args.res), cfg, device=device)
    dev, static, n = r.dev, r.static, r.static.pixel_count
    ikey = prng.iteration_key(r._base_key, 1)
    cam_u = prng.uniforms(prng.stage_key(ikey, 0, 0), n, 4, device=device)
    paths = measure.advance_population(r, cfg, 1)  # a realistic mix of dead and live
    isect = intersect_scene(dev, static, paths, cfg)
    su_key = prng.stage_key(ikey, 1, 1)
    any_perm = torch.argsort(paths.pixel)

    def shade():
        su = prng.uniforms_at(su_key, paths.pixel, 3, n)
        return shade_ops.shade(dev, static, paths, intersect_scene(dev, static, paths, cfg), su,
                               cfg)

    stages = {
        "raygen": lambda: camera_ops.generate_camera_rays(
            r._cam_state, static.width, static.height, static.trace_depth, cam_u),
        "intersect": lambda: intersect_scene(dev, static, paths, cfg),
        "intersect+shade": shade,
        "scan (compact_indices)": lambda: scan_ops.compact_indices(paths.alive),
        "perm build (scan+scatter)": lambda: front_pack_permutation(paths.alive),
        "perm apply (per-field gather)": lambda: permute_path_state(paths, any_perm),
        "compact (build+apply)": lambda: compact_paths(paths),
        "material sort": lambda: sort_paths_by_material(paths, isect),
        "FULL bounce (i+s+c)": lambda: compact_paths(shade()),
    }
    print(f"n = {n} rays, k = {args.k}, device = {device} ({measure.card_label(device)}), "
          f"live {int(paths.alive.sum())}", flush=True)
    before = scan_ops.scan_flat.launches
    measure.stage_records("torch_profile_wavefront", device, stages, args.k, args.only,
                          scene=os.path.basename(args.scene), res=args.res, rays=n)
    print(f"scan kernel launches: {scan_ops.scan_flat.launches - before}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
