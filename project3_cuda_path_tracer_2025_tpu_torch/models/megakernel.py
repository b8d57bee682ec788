"""Megakernel integrator: one spp iteration, bounce loop over the whole
frame.

The reference's iteration loop (``pathtrace()``, ``src/pathtrace.cu:639-787``)
launches a kernel chain per bounce.  This is the port of the JAX package's
``megakernel_iteration``: raygen, trace_depth x (intersect + shade), final
gather, with the same ``(iteration, pixel, depth)`` random streams.

On a CUDA device with ``fused_bounce`` "auto" or "on" (on the CPU with
"on", where the kernels' plain versions run):

* a prim-only scene runs one launch of the bounce kernel per bounce
  (``ops.fused.fused_prim_bounce``), with uniforms from the Threefry kernel;
* a mesh scene runs ``ops.fused.fused_mesh_bounce`` per bounce: the mono
  traversal kernel, then the mesh-shade kernel, which draws its uniforms
  inline and emits the next bounce's prim t_limit and sort key (threaded
  through ``mesh_carry``).  The path state stays in coherence order across
  bounces (resorted every ``ray_sort_every`` bounces) and the film
  scatter-adds by pixel id.

With "off", or ``shader="fake"``, each bounce runs the unfused torch ops
(the port of the JAX package's XLA path), chosen only by explicit config,
as in the JAX package.  Termination is the bounces mask.
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
    plain: bool = False,
) -> Tuple[Vec3, torch.Tensor]:
    """One full spp iteration. Returns (film, alive_counts[depth]).

    ``plain`` runs every kernel's plain PyTorch version in its place, on
    any device: the reference the kernel path is held to on the card."""
    device = film.x.device
    depth = static.trace_depth
    n = static.pixel_count
    idx = torch.arange(n, device=device)
    uniforms = (
        (lambda key, k: prng.uniforms_at(key, idx, k, n)) if plain
        else (lambda key, k: prng.uniforms(key, n, k, device))
    )

    ikey = prng.iteration_key(base_key, iteration)
    cam_u = uniforms(prng.stage_key(ikey, 0, 0), 4)
    paths = camera_ops.generate_camera_rays(
        cam, static.width, static.height, depth, cam_u
    )

    force = cfg.fused_bounce == "on"
    auto = cfg.fused_bounce == "auto" and device.type == "cuda"
    use_fused = (force or auto) and fused.fused_applicable(static, cfg)
    use_fused_mesh = (
        (force or auto) and not use_fused and fused.fused_mesh_applicable(static, cfg)
    )
    mesh_carry = None  # the mesh-shade kernel's (t_lim, key) for the next bounce

    alive_counts = torch.zeros((depth,), dtype=torch.int32, device=device)
    for d in range(depth):
        skey = prng.stage_key(ikey, d, 1)
        if use_fused_mesh:
            want = d < depth - 1
            out = fused.fused_mesh_bounce(
                dev, static, cfg, paths, su_key=skey,
                resort=(
                    d % max(1, cfg.ray_sort_every) == 0
                    and (d > 0 or cfg.ray_sort_first_bounce)
                ),
                rng_n=n, carry=mesh_carry, want_carry=want, plain=plain,
            )
            paths, mesh_carry = out if want else (out, None)
        elif use_fused:
            bounce = fused.fused_prim_bounce_plain if plain else fused.fused_prim_bounce
            paths = bounce(static, cfg, paths, uniforms(skey, 3))
        else:
            su = uniforms(skey, 3)
            isect = intersect_scene(dev, static, paths, cfg)
            paths = shade_ops.shade(dev, static, paths, isect, su, cfg)
        alive_counts[d] = torch.sum(paths.alive.to(torch.int32))

    film = film_ops.accumulate(film, paths, permuted=use_fused_mesh)
    return film, alive_counts
