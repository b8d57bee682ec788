"""Command-line renderer: the headless counterpart of the reference's app
shell (``src/main.cpp:341-393``).

    python -m project3_cuda_path_tracer_2025_tpu_torch.cli SCENEFILE.json [options]

Like the reference binary it takes a scene file, renders ITERATIONS spp and
writes ``{FILE}.{timestamp}.{N}samp.png``.  It renders on the CUDA device by
default; ``--device cpu`` (or the JAX CLI's ``--cpu``) is an explicit choice,
never a fallback.  The toggles of the JAX package's CLI pass the same
``RenderConfig`` fields (``--no-bvh``, ``--raw-camera``, ``--ray-sorting``,
``--fused-bounce``, ``--bounce-prefix-tiers``, ``--spp-per-launch``,
``--devices``, ``--parallel-mode``, ``--pixel-chunks``, ``--preview-every``,
``--interactive``): it takes every flag of the JAX CLI.  ``--devices N``
shards over ``cuda:0`` .. ``cuda:{N-1}`` (or N times the CPU with
``--device cpu``).
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys


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
    p.add_argument(
        "--integrator",
        choices=("megakernel", "wavefront"),
        default="megakernel",
    )
    p.add_argument(
        "--no-compaction",
        action="store_true",
        help="disable stream compaction (wavefront, ref STREAM_COMPACTION=0)",
    )
    p.add_argument(
        "--compaction",
        choices=("on", "off", "adaptive"),
        default=None,
        help="wavefront compaction policy (adaptive = pack only once the "
        "live fraction drops below 1/2; image-identical, see RenderConfig)",
    )
    p.add_argument(
        "--material-sort",
        action="store_true",
        help="enable material sorting (ref MATERIAL_SORTING=1)",
    )
    p.add_argument(
        "--no-bvh",
        action="store_true",
        help="brute-force triangles (ref BVH_ACCELERATION=0)",
    )
    p.add_argument("--no-mirror", action="store_true", help="disable saveImage x-mirror")
    p.add_argument(
        "--raw-camera",
        action="store_true",
        help="render from EYE directly instead of the reference's spherical reconstruction",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--mesh-intersector",
        choices=("auto", "mxu", "threaded", "brute"),
        default="auto",
        help="mesh intersection backend (auto: the MXU tables' traversal kernels "
        "on a CUDA device, the threaded BVH walk on the CPU)",
    )
    p.add_argument(
        "--ray-sorting",
        choices=("auto", "on", "off"),
        default="auto",
        help="per-bounce ray-coherence sorting for the MXU intersector",
    )
    p.add_argument(
        "--mxu-traversal",
        choices=("auto", "sweep", "planned", "streamed", "binned", "mono"),
        default="auto",
        help="MXU intersector traversal (bit-identical results)",
    )
    p.add_argument(
        "--bounce-prefix-tiers", default="auto",
        help="comma-separated ray-count divisors (e.g. '4,2'), parsed as the JAX "
        "CLI parses them; 'auto' (default) and 'off' run no tiers, anything "
        "else raises until the tiers are ported",
    )
    p.add_argument(
        "--fused-bounce",
        choices=("auto", "on", "off"),
        default="auto",
        help="fused bounce kernels (auto: on a CUDA device)",
    )
    p.add_argument(
        "--spp-per-launch", type=int, default=1,
        help="samples traced per batch of launches (one timing and one log "
        "check per batch)",
    )
    p.add_argument("--cpu", action="store_true", help="alias of --device cpu")
    p.add_argument(
        "--pixel-chunks", type=int, default=0,
        help="split each iteration into C sequential dispatches over pixel "
        "blocks (bit-identical; C must divide the pixel count); 0 (auto) and "
        "1 run unchunked",
    )
    p.add_argument(
        "--devices", type=int, default=1,
        help="render across N devices (cuda:0 .. cuda:N-1; N times the CPU "
        "with --device cpu; 1 = single)",
    )
    p.add_argument(
        "--parallel-mode", choices=("pixel", "sample"), default="pixel",
        help="pixel: split the frame's pixels over the devices (bit-identical); "
        "sample: each device renders other spp of the full frame, films summed",
    )
    p.add_argument("--checkpoint", default=None, help="write a .npz checkpoint here at exit")
    p.add_argument("--resume", default=None, help="resume from a .npz checkpoint")
    p.add_argument("--checkpoint-every", type=int, default=0, help="checkpoint every N spp")
    p.add_argument(
        "--preview-every", type=int, default=0,
        help="write OUT/preview.png every N spp (the reference shows a live window)",
    )
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--quiet", action="store_true")
    p.add_argument(
        "--interactive", action="store_true",
        help="live in-terminal render with orbit-camera keys (the headless "
        "counterpart of the reference's GLFW window; needs a TTY)",
    )
    p.add_argument(
        "--device", default="cuda",
        help="torch device to render on (default: cuda; 'cpu' runs the plain "
        "PyTorch versions of the kernels)",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cpu:
        args.device = "cpu"

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

    compaction = (
        {"on": True, "off": False, "adaptive": "adaptive"}[args.compaction]
        if args.compaction is not None
        else (False if args.no_compaction else "adaptive")
    )
    cfg = RenderConfig(
        integrator=args.integrator,
        stream_compaction=compaction,
        material_sorting=args.material_sort,
        bvh_acceleration=not args.no_bvh,
        mirror_output=not args.no_mirror,
        spherical_camera_reconstruction=not args.raw_camera,
        mesh_intersector=args.mesh_intersector,
        ray_sorting=args.ray_sorting,
        mxu_traversal=args.mxu_traversal,
        bounce_prefix_tiers=(
            "auto"
            if args.bounce_prefix_tiers == "auto"
            else tuple(
                int(s)
                for s in args.bounce_prefix_tiers.replace("off", "").split(",")
                if s.strip()
            )
        ),
        fused_bounce=args.fused_bounce,
        spp_per_launch=args.spp_per_launch,
        devices=args.devices,
        parallel_mode=args.parallel_mode,
        pixel_chunks=args.pixel_chunks,
    )
    r = Renderer(scene, cfg, seed=args.seed, device=args.device)
    if args.resume:
        r.restore(args.resume)
        print(f"Resumed at iteration {r.iteration} from {args.resume}")

    total = args.spp if args.spp is not None else scene.state.iterations
    if args.interactive:
        from .interactive import InteractiveShell

        shell = InteractiveShell(r, out_dir=args.out)
        return shell.run(spp_per_frame=max(1, args.spp_per_launch), max_iters=total)
    if not args.quiet:
        print(
            f"{r.static.width}x{r.static.height}, depth {r.static.trace_depth}, "
            f"{total} spp, integrator={cfg.integrator}, "
            f"{r.static.num_triangles} tris, {len(r.static.geoms)} prims, "
            f"device={r.device}"
        )

    try:
        while r.iteration < total:
            r.step_many(min(max(1, args.spp_per_launch), total - r.iteration))
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
            if args.preview_every and it % args.preview_every == 0 and it < total:
                target = os.path.join(args.out, "preview.png")
                shutil.move(r.save(out_dir=args.out), target)
                if not args.quiet:
                    print(f"preview -> {target}")
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
