"""Closed-against-open box stream-compaction study on the PyTorch/CUDA port
(the port's counterpart of ``scripts/compaction_study.py``; the reference's
methodology: a scene pair differing only by a front wall, where closed-box
rays rarely terminate and compaction has nothing to remove).

Runs the wavefront integrator with compaction on and off, and the megakernel
(mask-only termination) for context, on ``scenes/cornell_mesh_5k.json`` and
``scenes/cornell_mesh_5k_closed.json``; one JSON line per (scene, config),
each config in its own subprocess (``torch_bench_scenes.bench_scene``).

    python scripts/torch_compaction_study.py [--res 800 --spp 32]
    python scripts/torch_compaction_study.py --device cpu --res 8 --spp 1 --batch 1
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_bench_scenes import bench_scene  # noqa: E402

SCENES = ("scenes/cornell_mesh_5k.json", "scenes/cornell_mesh_5k_closed.json")
CONFIGS = (
    {"integrator": "wavefront", "stream_compaction": True},
    {"integrator": "wavefront", "stream_compaction": False},
    {},  # megakernel (mask-only termination), the production path
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--res", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; 'cpu' times nothing)")
    args = ap.parse_args(argv)

    results, failed = [], 0
    for path in SCENES:
        for kw in CONFIGS:
            try:
                rec = bench_scene(path, kw, spp=args.spp, batch=args.batch, res=args.res,
                                  device=args.device, timeout=2400)
                rec["script"] = "torch_compaction_study"
                results.append(rec)
            except (RuntimeError, subprocess.TimeoutExpired) as e:
                rec = {"script": "torch_compaction_study", "scene": path, "error": str(e)[:300],
                       **kw}
                failed += 1
            print(json.dumps(rec), flush=True)
    print("== summary ==")
    for r in results:
        ms = "no time" if r["ms_per_frame"] is None else f"{r['ms_per_frame']:.3f} ms/frame"
        print(f"{r['scene']:32s} {r.get('integrator', 'megakernel'):10s} "
              f"compaction={r.get('stream_compaction', '-')!s:5s} {ms}  alive {r['depth_alive']}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
