"""Film accumulation.

``finalGather`` (``src/pathtrace.cu:624-633``) adds EVERY path's final color
to its pixel, once per iteration -- including paths that terminated with 0
(miss) and paths that exhausted their bounces still carrying throughput.
The film lives on the device as a Vec3 of [N] float32 tensors and is copied
to the host only on save.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.vec import Vec3
from .rays import PathState


def new_film(n: int, device="cpu") -> Vec3:
    return Vec3.zeros((n,), device=device)


def accumulate(film: Vec3, paths: PathState, permuted: bool = False, base: int = 0) -> Vec3:
    """film[pixel - base] += color, in place.  Slots in pixel order are a
    plain vector add; permuted slots (the fused mesh bounce's persistent
    sort, the wavefront's compaction) scatter-add by pixel id, which is
    exact: each pixel has one ray.  ``base`` is the first pixel of a block
    (a shard or chunk of the frame, ``parallel.shardmap``), whose film
    holds pixels ``[base, base + len(film))``; the sort permutes only
    within the block, so the shifted ids index its film exactly."""
    if permuted:
        idx = paths.pixel.long()
        if base:
            idx = idx - base
        for f, c in zip(film, paths.color):
            f.index_add_(0, idx, c)
        return film
    film.x.add_(paths.color.x)
    film.y.add_(paths.color.y)
    film.z.add_(paths.color.z)
    return film


def to_host_image(film: Vec3, width: int, height: int) -> np.ndarray:
    """[H, W, 3] float32 accumulator (still un-divided by iterations)."""
    arr = torch.stack([film.x, film.y, film.z], dim=-1)
    return arr.cpu().numpy().reshape(height, width, 3)
