"""The port's counterparts of the repo's ``__graft_entry__.py``.

* ``entry(device)`` -> ``(step, example_args)``: one megakernel step of
  ``scenes/cornell.json`` (a stand-in for the reference's file) cut to
  128x128; on the card every bounce is one launch of the bounce kernel.
* ``dryrun_multichip(n, devices)``: every tag of ``__graft_entry__.py``'s
  dry run, in its order and under its names, through ``parallel.dryrun``
  and ``Renderer(RenderConfig(devices=n))``, each asserting rays alive at
  depth 0 (the dry-run tags) and a finite film.

    python graft_entry_torch.py          # from the repo root, on the card

``devices`` names the shards' devices (default ``cuda:0`` .. ``cuda:{n-1}``,
which must exist); one card may be named n times (``["cuda:0"] * n``).
"""

from __future__ import annotations

import os
import pathlib
import sys

import numpy as np
import torch

from .config import RenderConfig
from .models import Renderer, megakernel_iteration
from .ops import film as film_ops
from .parallel import dryrun
from .scene import (
    build_device_scene, camera_state, derive_render_camera, load_scene, set_resolution,
)
from .utils import prng
from .utils.measure import open_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCENES = ROOT / "scenes"
# A stand-in for the reference tracer's cornell.json (scenes/cornell_dof.json
# with a pinhole camera): the port reads nothing outside its checkout.
SCENE = SCENES / "cornell.json"
MESH_SCENE = SCENES / "cornell_mesh_5k.json"
# __graft_entry__.py's textured tag reads cornell_prim_textured.json, whose
# texture lies outside the repo and loads in neither package; the in-repo
# stand-in has procedural textures in its place.
TEX_SCENE = SCENES / "cornell_prim_textured_local.json"
TEX_NOTE = ("cornell_prim_textured_local.json, the in-repo stand-in: "
            "cornell_prim_textured.json names a texture outside the repo")
MESH_CFG = dict(mesh_intersector="mxu", fused_bounce="on", ray_sorting="on")

# __graft_entry__.py's tags in order: (tag, "dryrun" | "renderer", scene,
# width, height, RenderConfig overrides).  "dryrun" is one pixel-mode step
# of parallel.dryrun; "renderer" one step of Renderer(devices=n).
TAGS = (
    ("megakernel", "dryrun", SCENE, 64, 64, {}),
    ("mesh+mxu", "dryrun", MESH_SCENE, 32, 32, dict(mesh_intersector="mxu")),
    ("wavefront", "dryrun", SCENE, 32, 32, dict(integrator="wavefront")),
    ("shardmap+fused-prim", "renderer", SCENE, 32, 32, dict(fused_bounce="on")),
    ("shardmap+fused-mesh", "renderer", MESH_SCENE, 32, 32,
     dict(MESH_CFG, bounce_prefix_tiers=(4, 2))),
    ("shardmap+streamed-traversal", "renderer", MESH_SCENE, 16, 16,
     dict(MESH_CFG, mxu_traversal="streamed")),
    ("shardmap+binned-traversal", "renderer", MESH_SCENE, 16, 16,
     dict(MESH_CFG, mxu_traversal="binned")),
    ("shardmap+fused-tex", "renderer", TEX_SCENE, 32, 32,
     dict(fused_bounce="on", ray_sorting="on", bounce_prefix_tiers=(4, 2))),
    ("shardmap+sample-parallel", "renderer", SCENE, 32, 32, dict(parallel_mode="sample")),
)


def entry(device="cuda"):
    """``(step, example_args)``: ``step(cam_state, film, iteration, key)``
    runs one ``megakernel_iteration`` at 128x128 with the default
    ``RenderConfig`` and returns ``(film, alive counts)``; the film is
    updated in place."""
    device = open_device(device)
    scene = set_resolution(load_scene(str(SCENE)), 128, 128)
    dev, static = build_device_scene(scene, device)
    cfg = RenderConfig()
    cam = camera_state(derive_render_camera(scene.state.camera))
    film = film_ops.new_film(static.pixel_count, device)

    def step(cam_state, film_state, iteration, key):
        return megakernel_iteration(dev, static, cfg, cam_state, film_state, iteration, key)

    return step, (cam, film, 1, prng.prng_key(0))


def run_tag(row, n_devices: int, devices=None) -> tuple:
    """One row of ``TAGS`` on ``n_devices`` shards; prints its line.
    Returns (film [N, 3] float32, alive counts per depth), on the host."""
    tag, kind, scene, w, h, kw = row
    note = f" (scene {TEX_NOTE})" if scene == TEX_SCENE else ""
    if kind == "dryrun":
        film, alive, devs = dryrun(n_devices, str(scene), width=w, height=h, devices=devices,
                                   **kw)
        counts = alive.cpu().numpy()
        if not (counts.shape[0] > 0 and counts[0] > 0):
            raise AssertionError(f"{tag}: no rays survived")
        img = torch.stack(list(film), 1).cpu().numpy()
        total = img.sum()
        if not np.isfinite(total):
            raise AssertionError(f"{tag}: film not finite")
        print(f"dryrun_multichip({n_devices}) [{tag}]: mesh={{'rays': {len(devs)}}} "
              f"alive={counts.tolist()} film_sum={total:.3f}{note}", flush=True)
        return img, counts
    # Renderer(devices=n), its own device the first shard's (default cuda).
    r = Renderer(set_resolution(load_scene(str(scene)), w, h),
                 RenderConfig(devices=n_devices, **kw),
                 device=torch.device(devices[0]) if devices else "cuda", shard_devices=devices)
    r.step()
    img = r.image().reshape(-1, 3)
    if not np.isfinite(img).all():
        raise AssertionError(f"{tag}: film not finite")
    print(f"dryrun_multichip({n_devices}) [{tag}]: iter={r.iteration} "
          f"film_sum={img.sum():.3f}{note}", flush=True)
    return img, np.asarray(r._alive_counts)


def run_unsharded(row, n_devices: int, device) -> tuple:
    """A ``"renderer"`` row's configuration on one unsharded ``Renderer`` on
    ``device``, the frames its ``n_devices`` shards render in one step (one
    frame; ``n_devices`` in sample mode).  Returns (film [N, 3], alive
    counts per depth of the last frame), on the host."""
    _, kind, scene, w, h, kw = row
    assert kind == "renderer", row[0]
    sample = kw.get("parallel_mode") == "sample"
    kw = {k: v for k, v in kw.items() if k != "parallel_mode"}
    r = Renderer(set_resolution(load_scene(str(scene)), w, h), RenderConfig(**kw),
                 device=device)
    if sample:
        r.step_many(n_devices)
    else:
        r.step()
    return r.image().reshape(-1, 3), np.asarray(r._alive_counts)


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Runs every row of ``TAGS`` on ``n_devices`` shards (``run_tag``).
    Returns tag -> (film [N, 3], alive counts)."""
    return {row[0]: run_tag(row, n_devices, devices) for row in TAGS}


def default_devices(n: int) -> list:
    """The cards that exist, in turn, for n shards: ``["cuda:0"] * n`` on
    one card, ``cuda:0`` .. ``cuda:{n-1}`` on n."""
    have = torch.cuda.device_count()
    if have < 1:
        raise RuntimeError("dryrun_multichip needs a CUDA GPU")
    return [f"cuda:{i % have}" for i in range(n)]


def main() -> int:
    """``entry()`` once on the card, then ``dryrun_multichip(NDEV)`` (default
    4) over the cards that exist, named in turn."""
    step, args = entry()
    film, alive = step(*args)
    torch.cuda.synchronize()
    print(f"entry() ran: alive={alive.cpu().tolist()} "
          f"film_sum={float(sum(f.sum() for f in film)):.3f}", flush=True)
    n = int(os.environ.get("NDEV", "4"))
    dryrun_multichip(n, default_devices(n))
    return 0


if __name__ == "__main__":
    sys.exit(main())
