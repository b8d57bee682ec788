from . import bsdf, camera, compaction, film, fused, intersect, intersect_mxu, kernels, shade
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
    "shade",
    "Intersections",
    "PathState",
]
