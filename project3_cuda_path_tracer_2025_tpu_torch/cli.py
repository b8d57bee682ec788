"""Command-line renderer: the headless counterpart of the reference's app
shell (``src/main.cpp:341-393``).

    python -m project3_cuda_path_tracer_2025_tpu_torch.cli SCENEFILE.json [options]

Like the reference binary it takes a scene file, renders ITERATIONS spp and
writes ``{FILE}.{timestamp}.{N}samp.png``.  It renders on the CUDA device by
default; ``--device cpu`` is an explicit choice, never a fallback.  The JAX
package's other flags (integrator, toggles, mesh traversal, multi-device,
interactive shell) raise until their paths are ported (``ROADMAP.md``,
Queue 1: the rest of the CLI).
"""

from __future__ import annotations

import argparse
import os
import sys

# Flags of the JAX package's CLI that this one does not take yet.
_NOT_PORTED = (
    "--integrator", "--no-compaction", "--compaction", "--material-sort",
    "--no-bvh", "--raw-camera", "--ray-sorting",
    "--mxu-traversal", "--bounce-prefix-tiers", "--fused-bounce",
    "--spp-per-launch", "--cpu", "--pixel-chunks", "--devices",
    "--parallel-mode", "--preview-every", "--interactive",
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="project3_cuda_path_tracer_2025_tpu_torch",
        description="PyTorch/CUDA path tracer (port of the TPU path tracer)",
    )
    p.add_argument("scene", help="scene .json file (reference schema)")
    p.add_argument("--spp", type=int, default=None, help="override ITERATIONS")
    p.add_argument("--depth", type=int, default=None, help="override trace DEPTH")
    p.add_argument("--res", type=int, nargs=2, metavar=("W", "H"), default=None)
    p.add_argument("--out", default="img", help="output directory (default: img)")
    p.add_argument("--hdr", action="store_true", help="write Radiance .hdr too")
    p.add_argument("--no-mirror", action="store_true", help="disable saveImage x-mirror")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--mesh-intersector",
        choices=("auto", "mxu", "threaded", "brute"),
        default="auto",
        help="mesh intersection backend (auto: the mono traversal kernel on a "
        "CUDA device, the threaded BVH walk on the CPU)",
    )
    p.add_argument("--checkpoint", default=None, help="write a .npz checkpoint here at exit")
    p.add_argument("--resume", default=None, help="resume from a .npz checkpoint")
    p.add_argument("--checkpoint-every", type=int, default=0, help="checkpoint every N spp")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--quiet", action="store_true")
    p.add_argument(
        "--device", default="cuda",
        help="torch device to render on (default: cuda; 'cpu' runs the plain "
        "PyTorch versions of the kernels)",
    )
    return p


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    for a in argv:
        if a.split("=", 1)[0] in _NOT_PORTED:
            raise NotImplementedError(
                f"{a.split('=', 1)[0]} is not ported yet (ROADMAP.md, "
                "Queue 1: the rest of the CLI)"
            )
    args = build_parser().parse_args(argv)

    from .config import RenderConfig
    from .models import Renderer
    from .scene import load_scene, set_resolution

    if not os.path.exists(args.scene):
        print(f"Couldn't read from {args.scene}", file=sys.stderr)
        return 1

    print(f"Reading scene from {args.scene} ...")
    scene = load_scene(args.scene)
    if args.res:
        set_resolution(scene, *args.res)
    if args.depth is not None:
        scene.state.trace_depth = args.depth

    cfg = RenderConfig(
        mirror_output=not args.no_mirror, mesh_intersector=args.mesh_intersector
    )
    r = Renderer(scene, cfg, seed=args.seed, device=args.device)
    if args.resume:
        r.restore(args.resume)
        print(f"Resumed at iteration {r.iteration} from {args.resume}")

    total = args.spp if args.spp is not None else scene.state.iterations
    if not args.quiet:
        print(
            f"{r.static.width}x{r.static.height}, depth {r.static.trace_depth}, "
            f"{total} spp, device={r.device}, {len(r.static.geoms)} prims, "
            f"{r.static.num_triangles} triangles"
        )

    try:
        while r.iteration < total:
            r.step()
            it = r.iteration
            if not args.quiet and args.log_every and (
                it % args.log_every == 0 or it == total
            ):
                rays = float(r._alive_counts.sum() + r.static.pixel_count)
                print(
                    f"iter {it}/{total}  {r.stats.mean_ms:.2f} ms/frame  "
                    f"{r.stats.fps:.1f} FPS  {r.stats.mrays_per_s(rays):.1f} Mrays/s"
                )
            if args.checkpoint_every and it % args.checkpoint_every == 0 and args.checkpoint:
                r.checkpoint(args.checkpoint)
    except KeyboardInterrupt:
        print(f"\ninterrupted at iteration {r.iteration}; saving partial render")

    if args.checkpoint:
        r.checkpoint(args.checkpoint)
        print(f"checkpoint -> {args.checkpoint}")

    path = r.save(out_dir=args.out)
    print(f"Saved {path}.")
    if args.hdr:
        print(f"Saved {r.save(out_dir=args.out, hdr=True)}.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
