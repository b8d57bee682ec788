"""Megakernel integrator: one spp iteration, bounce loop over the whole
frame.

The reference's iteration loop (``pathtrace()``, ``src/pathtrace.cu:639-787``)
launches a kernel chain per bounce.  This is the port of the JAX package's
``megakernel_iteration``: raygen, trace_depth x (intersect + shade), final
gather, with the same ``(iteration, pixel, depth)`` random streams.

On a CUDA device with ``fused_bounce`` "auto" or "on" (on the CPU with
"on", where the kernels' plain versions run):

* a prim-only scene runs one launch of the bounce kernel per bounce
  (``ops.fused.fused_prim_bounce``), which draws its uniforms inline at
  each ray's pixel (the camera's come from the Threefry kernel);
* a mesh scene runs ``ops.fused.fused_mesh_bounce`` per bounce: the
  traversal kernel ``cfg.mxu_traversal`` names or "auto" picks for the
  mesh's size (mono, planned, streamed or binned), then the mesh-shade
  kernel, which draws its uniforms inline and emits the next bounce's prim
  t_limit, the prim that gives it and the sort key (threaded through
  ``mesh_carry``: the next shade tests that prim alone, not every prim).
  The path state stays in coherence order across
  bounces (resorted every ``ray_sort_every`` bounces) and the film
  scatter-adds by pixel id.  A mesh with textures on its materials
  resolves albedo and the bump normal in torch between the two kernels and
  shades in the kernel's mode "textured";
* a scene with a textured or bump-mapped prim runs
  ``ops.fused.fused_tex_bounce`` per bounce: the whole intersect and surface
  in torch, the scatter in the mesh-shade kernel's mode "precomputed".

With prefix tiers (``RenderConfig.bounce_prefix_tiers``, by name: "auto"
runs none) and ray sorting on, the mesh and textured-prim bounces run over the
smallest prefix of the state that holds every alive ray (``fused.run_tiered``;
one host read a bounce), the textured prims liveness-packed from bounce 1
on (every ``ray_sort_every`` bounces); the film is the same bit for bit.

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
from ..utils.timers import span
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
    carry_winner: bool = True,
    shard: tuple = None,  # (block: range of global pixel ids, global N)
) -> Tuple[Vec3, torch.Tensor]:
    """One full spp iteration. Returns (film, alive_counts[depth]).

    ``plain`` runs every kernel's plain PyTorch version in its place, on
    any device: the reference the kernel path is held to on the card.
    ``carry_winner=False`` has a mesh scene's shade test every prim instead
    of taking the carried winner (``fused.fused_mesh_bounce``): the
    reference the carry is held to, the same film bit for bit.

    ``shard=(block, n_global)`` traces only the pixels of ``block``, a
    contiguous ``range`` of global pixel ids (the JAX package passes them
    as a vector; a range gives the first one without a read from the
    device), into ``film``, which holds those pixels (``parallel``, the
    chunked step).  Every draw is the whole frame's stream at the block's
    pixels (stream length ``n_global``), so the block's film equals the
    unsharded film's slice bit for bit."""
    device = film.x.device
    depth = static.trace_depth
    base, n, n_global = block_of(static, shard)
    idx = torch.arange(base, base + n, dtype=torch.int32, device=device)
    uniforms = (
        (lambda key, k: prng.uniforms_at(key, idx, k, n_global)) if plain
        else (lambda key, k: prng.uniforms(key, n, k, device, base=base, rng_n=n_global))
    )

    ikey = prng.iteration_key(base_key, iteration)
    cam_u = uniforms(prng.stage_key(ikey, 0, 0), 4)
    paths = camera_ops.generate_camera_rays(
        cam, static.width, static.height, depth, cam_u, idx=idx
    )

    force = cfg.fused_bounce == "on"
    auto = cfg.fused_bounce == "auto" and device.type == "cuda"
    use_fused = (force or auto) and fused.fused_applicable(static, cfg)
    use_fused_mesh = (
        (force or auto) and not use_fused and fused.fused_mesh_applicable(static, cfg)
    )
    use_fused_tex = (
        (force or auto) and not use_fused and not use_fused_mesh
        and fused.fused_tex_applicable(static, cfg)
    )
    # Liveness-packed (and prefix-tiered) textured-prim bounces: the film
    # then scatters by pixel.
    tex_sorted = use_fused_tex and fused.tex_sort_active(cfg, device)
    mesh_carry = None  # the mesh-shade kernel's (t_lim, key[, win]) for the next bounce

    alive_counts = torch.zeros((depth,), dtype=torch.int32, device=device)
    for d in range(depth):
        skey = prng.stage_key(ikey, d, 1)
        if use_fused_mesh:
            want = d < depth - 1
            with span("mesh.bounce"):
                out = fused.fused_mesh_bounce(
                    dev, static, cfg, paths, su_key=skey,
                    resort=(
                        d % max(1, cfg.ray_sort_every) == 0
                        and (d > 0 or cfg.ray_sort_first_bounce)
                    ),
                    rng_n=n_global, carry=mesh_carry, want_carry=want, plain=plain,
                    carry_winner=carry_winner,
                )
            paths, mesh_carry = out if want else (out, None)
        elif use_fused:
            bounce = fused.fused_prim_bounce_plain if plain else fused.fused_prim_bounce
            paths = bounce(static, cfg, paths, su_key=skey, rng_n=n_global)
        elif use_fused_tex:
            # The liveness pack from bounce 1 on: every camera ray is alive
            # at bounce 0, so a pack there is pure cost.
            paths = fused.fused_tex_bounce(
                dev, static, cfg, paths, su_key=skey, rng_n=n_global, plain=plain,
                resort=tex_sorted and d > 0 and d % max(1, cfg.ray_sort_every) == 0,
            )
        else:
            su = uniforms(skey, 3)
            isect = intersect_scene(dev, static, paths, cfg)
            paths = shade_ops.shade(dev, static, paths, isect, su, cfg)
        alive_counts[d] = torch.sum(paths.alive.to(torch.int32))

    with span("film.accumulate"):
        film = film_ops.accumulate(film, paths, permuted=use_fused_mesh or tex_sorted,
                                   base=base)
    return film, alive_counts


def block_of(static: SceneStatic, shard) -> tuple:
    """``(base, n, n_global)`` of an iteration's block: the whole frame
    without ``shard``, else the block's first pixel and length and the
    frame's pixel count."""
    n_global = static.pixel_count
    if shard is None:
        return 0, n_global, n_global
    block, n_global = shard
    if not isinstance(block, range) or block.step != 1 or not (
            0 <= block.start < block.stop <= n_global):
        raise ValueError(f"shard block {block!r}: give a range of pixel ids within "
                         f"[0, {n_global})")
    return block.start, len(block), n_global
