from . import bsdf, camera, film, fused, intersect, kernels, shade
from .rays import Intersections, PathState

__all__ = [
    "bsdf",
    "camera",
    "film",
    "fused",
    "intersect",
    "kernels",
    "shade",
    "Intersections",
    "PathState",
]
