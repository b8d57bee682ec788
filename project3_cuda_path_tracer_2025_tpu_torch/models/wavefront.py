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
The JAX package's prefix tiers resolve to none in the port
(``RenderConfig.resolved_prefix_tiers``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import RenderConfig
from ..ops import camera as camera_ops
from ..ops import film as film_ops
from ..ops import shade as shade_ops
from ..ops.compaction import compact_paths, sort_paths_by_material
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
    alive_counts = torch.zeros((depth,), dtype=torch.int32, device=device)
    for d in range(depth):
        isect = intersect_scene(dev, static, paths, cfg)
        if cfg.material_sorting:
            paths, isect = sort_paths_by_material(paths, isect)
        # Each slot draws its pixel's stream: permutations are invisible.
        su = prng.uniforms_at(prng.stage_key(ikey, d, 1), paths.pixel, 3, n_global)
        paths = shade_ops.shade(dev, static, paths, isect, su, cfg)
        if cfg.stream_compaction == "adaptive":
            # Pack only when mostly dead: the permutation is pure overhead on
            # mostly-live bounces.  Image-identical either way.  A block
            # decides on its own rays, as the JAX package's shard does.
            if 2 * int(torch.sum(paths.alive.to(torch.int32))) < n:
                paths = compact_paths(paths)[0]
        elif cfg.stream_compaction:
            paths = compact_paths(paths)[0]
        alive_counts[d] = torch.sum(paths.alive.to(torch.int32))
    film = film_ops.accumulate(film, paths, permuted=True, base=base)
    return film, alive_counts
