from . import (
    bsdf, camera, compaction, film, fused, intersect, intersect_mxu, kernels, scan, shade,
    texture,
)
from .rays import Intersections, PathState

__all__ = [
    "bsdf",
    "camera",
    "compaction",
    "film",
    "fused",
    "intersect",
    "intersect_mxu",
    "kernels",
    "scan",
    "shade",
    "texture",
    "Intersections",
    "PathState",
]
