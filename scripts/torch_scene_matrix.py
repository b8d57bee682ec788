"""Render every in-repo scene on the PyTorch/CUDA port at low spp (the
port's counterpart of ``scripts/scene_matrix.py``): a finite film and sane
brightness per scene, ms/frame on the card.

Every ``scenes/*.json`` is swept.  A scene whose assets are not in the
repository (a texture or OBJ file the JSON points at) records its load error
as expected, not as a failure.  One JSON line per scene, then a count; exit
code 1 if a rendered scene is not finite or not sanely bright.

The scenes render in this process one after another: a new process takes
seconds to reach the card, and the sweep is many short renders
(``torch_bench_scenes.py`` isolates its configs in subprocesses).

    python scripts/torch_scene_matrix.py [--spp 4] [--res 200] [--out F]
    python scripts/torch_scene_matrix.py --device cpu --res 8 --spp 1 --only dof
"""

import argparse
import glob
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def render_scene(path, spp, batch, res, device) -> dict:
    import numpy as np

    from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer
    from project3_cuda_path_tracer_2025_tpu_torch.scene import load_scene, set_resolution
    from project3_cuda_path_tracer_2025_tpu_torch.utils.timers import PerformanceTimer

    name = os.path.basename(path)
    try:
        scene = load_scene(path)
    except (FileNotFoundError, OSError) as e:
        return dict(scene=name, load_error=str(e)[:160])
    if res:
        set_resolution(scene, res, res)
    r = Renderer(scene, RenderConfig(spp_per_launch=batch), device=device)
    r.step_many(batch)  # build + warm-up
    r.reset()
    timer = PerformanceTimer(device)
    timer.start()
    r.step_many(spp, sync=False)
    ms = timer.stop() / spp if device.type == "cuda" else None
    img = r.image_normalized()
    return dict(
        scene=name, tris=r.static.num_triangles, prims=len(r.static.geoms),
        ms_per_frame=ms, finite=bool(np.isfinite(img).all()),
        mean_rgb=[float(m) for m in img.reshape(-1, 3).mean(0)], max_rgb=float(img.max()),
    )


def main(argv=None) -> int:
    from project3_cuda_path_tracer_2025_tpu_torch.utils import measure

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--res", type=int, default=None, help="square res override (default: native)")
    ap.add_argument("--only", default=None, help="substring of the scene files to take")
    ap.add_argument("--out", default=None, help="also write the records to this JSON file")
    measure.add_device_argument(ap)
    args = ap.parse_args(argv)
    device = measure.open_device(args.device)
    card = measure.card_label(device)

    results, n_bad = [], 0
    for path in sorted(glob.glob(os.path.join(REPO, "scenes", "*.json"))):
        if args.only and args.only not in path:
            continue
        rec = render_scene(path, args.spp, args.batch, args.res, device)
        # Sanity: finite film, not black, not blown out.  The CLOSED box
        # renders legitimately dark: its camera sits outside the added front
        # wall, so camera rays bounce off the unlit exterior and die.
        if "load_error" in rec:
            rec["sane"] = None  # assets not in the repository: expected
        else:
            mean = sum(rec["mean_rgb"]) / 3.0
            rec["sane"] = bool(rec["finite"] and (1e-5 < mean < 5.0 or "closed" in rec["scene"]))
            n_bad += not rec["sane"]
        rec.update(script="torch_scene_matrix", spp=args.spp, device=str(device), card=card)
        measure.emit(rec)
        results.append(rec)

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    rendered = sum("finite" in r for r in results)
    skipped = sum("load_error" in r for r in results)
    print(f"# {rendered} rendered, {skipped} unloadable (assets not in the repository), "
          f"{n_bad} FAILED")
    return 1 if n_bad else 0


if __name__ == "__main__":
    sys.exit(main())
