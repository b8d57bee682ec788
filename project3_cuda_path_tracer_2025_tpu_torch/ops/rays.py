"""Path state (SoA NamedTuples of torch tensors).

Counterparts of ``PathSegment`` (``src/sceneStructs.h:128-134``) and
``ShadeableIntersection`` (``:147-157``): every field is a flat ``[N]``
tensor (``Vec3`` = three ``[N]`` tensors), N = W*H path slots that persist for
the whole iteration (termination is the ``bounces`` mask, not a shrinking
buffer).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.vec import Vec3


class PathState(NamedTuple):
    origin: Vec3  # ray.origin
    direction: Vec3  # ray.direction (kept normalized)
    color: Vec3  # throughput, starts at (1,1,1)
    pixel: torch.Tensor  # i32 pixel index
    bounces: torch.Tensor  # i32 remainingBounces; 0 = terminated

    @property
    def n(self) -> int:
        return self.pixel.shape[-1]

    @property
    def alive(self) -> torch.Tensor:
        return self.bounces > 0


class Intersections(NamedTuple):
    t: torch.Tensor  # f32; -1 = miss (reference convention)
    normal: Vec3  # surface normal, flipped toward the ray origin
    material_id: torch.Tensor  # i32
    uv_u: torch.Tensor  # f32 (0 for analytic prims)
    uv_v: torch.Tensor
    dpdu: Vec3  # triangle tangent frame (0 for prims)
    dpdv: Vec3
    is_triangle: torch.Tensor  # bool
