"""Megakernel integrator: one spp iteration, bounce loop over the whole
frame.

The reference's iteration loop (``pathtrace()``, ``src/pathtrace.cu:639-787``)
launches a kernel chain per bounce.  This is the port of the JAX package's
``megakernel_iteration`` for prim-only scenes: raygen, trace_depth x
(intersect + shade), final gather, with the same ``(iteration, pixel,
depth)`` random streams.

On a CUDA device with ``fused_bounce`` "auto" or "on", each bounce is one
launch of the bounce kernel (``ops.fused.fused_prim_bounce``) and the
uniforms come from the Threefry kernel.  With "off", or ``shader="fake"``,
each bounce runs the unfused torch ops (the port of the JAX package's XLA
path), chosen only by explicit config, as in the JAX package.
Termination is the bounces mask.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import RenderConfig
from ..ops import camera as camera_ops
from ..ops import film as film_ops
from ..ops import fused
from ..ops import shade as shade_ops
from ..ops.intersect import intersect_scene
from ..scene.camera import CameraState
from ..scene.device import DeviceScene, SceneStatic
from ..utils import prng
from ..utils.vec import Vec3


def megakernel_iteration(
    dev: DeviceScene,
    static: SceneStatic,
    cfg: RenderConfig,
    cam: CameraState,
    film: Vec3,  # updated in place
    iteration: int,  # 1-based, like the reference
    base_key: tuple,
) -> Tuple[Vec3, torch.Tensor]:
    """One full spp iteration. Returns (film, alive_counts[depth])."""
    device = film.x.device
    depth = static.trace_depth
    n = static.pixel_count

    ikey = prng.iteration_key(base_key, iteration)
    cam_u = prng.uniforms(prng.stage_key(ikey, 0, 0), n, 4, device)
    paths = camera_ops.generate_camera_rays(
        cam, static.width, static.height, depth, cam_u
    )

    force = cfg.fused_bounce == "on"
    auto = cfg.fused_bounce == "auto" and device.type == "cuda"
    use_fused = (force or auto) and fused.fused_applicable(static, cfg)

    alive_counts = torch.zeros((depth,), dtype=torch.int32, device=device)
    for d in range(depth):
        su = prng.uniforms(prng.stage_key(ikey, d, 1), n, 3, device)
        if use_fused:
            paths = fused.fused_prim_bounce(static, cfg, paths, su)
        else:
            isect = intersect_scene(dev, static, paths, cfg)
            paths = shade_ops.shade(dev, static, paths, isect, su, cfg)
        alive_counts[d] = torch.sum(paths.alive.to(torch.int32))

    film = film_ops.accumulate(film, paths)
    return film, alive_counts
