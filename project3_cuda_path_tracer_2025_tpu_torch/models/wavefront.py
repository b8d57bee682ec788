"""Wavefront integrator: per-bounce stages with compaction / material sort.

Port of the JAX package's ``models/wavefront.py``, the reference's own
architecture (``src/pathtrace.cu:696-771``): each bounce is intersect ->
[material sort] -> shade -> [stream compaction], the live count shrinking
like the reference's ``num_paths``.  Compaction is a stable front-pack
permutation of the whole state, built on the scan (``ops.scan``: the CUDA
scan kernel on the card, two launches per compacting bounce); the material
sort is a stable ``torch.argsort``.

RNG streams are keyed by pixel (drawn at each slot's pixel id), and the film
scatter-adds by pixel, so compaction and sorting do not change the image: a
wavefront film is bit-identical to the megakernel's unfused
(``fused_bounce="off"``) film of the same scene, seed and iteration.

``stream_compaction="adaptive"`` packs only once fewer than half the slots
are alive: the JAX package decides with a ``lax.cond`` on the device; here
the alive count is read to the host, one synchronizing read per bounce.

Prefix tiers (``RenderConfig.resolved_prefix_tiers``), with compaction on:
compaction packs every alive ray into a front prefix, so the whole bounce
-- intersect, material sort, draws, shade and the compaction itself --
runs over the smallest tier holding them (``fused.run_tiered``; one host
read a bounce), the dead tail untouched.  "adaptive" then compares the
alive count with the engaged tier's rows.  The film is the same bit for
bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import RenderConfig
from ..ops import camera as camera_ops
from ..ops import film as film_ops
from ..ops import shade as shade_ops
from ..ops.compaction import compact_paths, sort_paths_by_material
from ..ops.fused import run_tiered, tier_sizes
from ..ops.intersect import intersect_scene
from ..scene.camera import CameraState
from ..scene.device import DeviceScene, SceneStatic
from ..utils import prng
from ..utils.vec import Vec3
from .megakernel import block_of


def wavefront_iteration(
    dev: DeviceScene,
    static: SceneStatic,
    cfg: RenderConfig,
    cam: CameraState,
    film: Vec3,  # updated in place
    iteration: int,  # 1-based, like the reference
    base_key: tuple,
    shard: tuple = None,  # (block: range of global pixel ids, global N)
) -> Tuple[Vec3, torch.Tensor]:
    """One full spp iteration. Returns (film, alive_counts[depth]).
    ``shard``: one block of the frame, as in ``megakernel_iteration``."""
    device = film.x.device
    depth = static.trace_depth
    base, n, n_global = block_of(static, shard)
    ikey = prng.iteration_key(base_key, iteration)
    paths = camera_ops.generate_camera_rays(
        cam, static.width, static.height, depth,
        prng.uniforms(prng.stage_key(ikey, 0, 0), n, 4, device, base=base, rng_n=n_global),
        idx=torch.arange(base, base + n, dtype=torch.int32, device=device),
    )
    tiers = cfg.resolved_prefix_tiers(device)
    npres = tier_sizes(n, tiers) if tiers and cfg.stream_compaction else []
    alive_counts = torch.zeros((depth,), dtype=torch.int32, device=device)
    for d in range(depth):

        def stages(head, d=d):
            isect = intersect_scene(dev, static, head, cfg)
            if cfg.material_sorting:
                head, isect = sort_paths_by_material(head, isect)
            # Each slot draws its pixel's stream: permutations are invisible.
            su = prng.uniforms_at(prng.stage_key(ikey, d, 1), head.pixel, 3, n_global)
            head = shade_ops.shade(dev, static, head, isect, su, cfg)
            if cfg.stream_compaction == "adaptive":
                # Pack only when mostly dead: the permutation is pure overhead
                # on mostly-live bounces.  Image-identical either way.  A block
                # decides on its own rays, as the JAX package's shard does, and
                # a tier on its own rows.
                if 2 * int(torch.sum(head.alive.to(torch.int32))) < head.pixel.shape[0]:
                    head = compact_paths(head)[0]
            elif cfg.stream_compaction:
                head = compact_paths(head)[0]
            return head

        paths = run_tiered(paths, npres, stages)
        alive_counts[d] = torch.sum(paths.alive.to(torch.int32))
    film = film_ops.accumulate(film, paths, permuted=True, base=base)
    return film, alive_counts
