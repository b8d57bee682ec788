"""The benchmark's frozen yardstick for roofline shares: the card's
published peaks, the least work a path-tracing iteration of analytic
primitives must do, and the least work a walk over a triangle mesh must do.

The operation counts are float32 operations of the reference tracer's
device functions (each add, multiply, division, square root, sine or
cosine, minimum, maximum, compare and absolute value is one; a fused
multiply-add two).  Transforms count at their folded minimum, the scatter
at the diffuse lobe, and the integer work of the draws not at all, so the
bound is a lower bound on the time, whatever implements the iteration.
"""

from __future__ import annotations

# One NVIDIA H100 SXM at 700 W (data sheet, dense): HBM bytes/s and float32
# operations/s outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12

OPS_BOX, OPS_SPHERE = 78, 60  # slab test of a box, roots of a sphere
OPS_NEAREST = 25  # the nearest-hit selection, winner normal and flip
OPS_SCATTER = 100  # diffuse scatter: new direction, origin, throughput
OPS_RAYGEN = 45  # camera ray
# A Moller-Trumbore test on precomputed edges, up to its first exit on the
# barycentric u: the direction crossed with an edge (9), the determinant (5),
# its guard (abs, compare: 2), the origin's offset from a corner (3), u's dot
# (5) and its two compares (2).  A test that rejects there does no more, so
# the rest (v, t and the nearest-hit compare) is counted nowhere.
OPS_TRIANGLE = 26
RAY_BYTES = 32  # a ray's origin and direction read (24), its t and id written (8)
TRIANGLE_BYTES = 36  # a triangle's three float32 corners, read once


def bound_ms(nbytes: float, ops: float) -> tuple:
    """The least time the card could take, and which of the two sets it:
    (ms, "bytes" | "operations")."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def iteration_work(pixels: int, boxes: int, spheres: int, alive: list) -> tuple:
    """(bytes, operations) of one spp iteration over ``pixels`` pixels of a
    scene of analytic primitives: the film read and written once and the
    alive counts written; a camera ray a pixel, then at each depth every
    path alive before it tests every primitive and scatters.  ``alive`` is
    the number of paths alive after each bounce."""
    depth = len(alive)
    live_before = [pixels] + [int(a) for a in alive[:-1]]
    per_ray = OPS_NEAREST + boxes * OPS_BOX + spheres * OPS_SPHERE + OPS_SCATTER
    return pixels * 24 + depth * 4, pixels * OPS_RAYGEN + sum(live_before) * per_ray


def walk_work(bounces: list) -> tuple:
    """(bytes, operations) of one whole-frame iteration's mesh walks: at each
    bounce every ray alive before it reads its ray and writes its hit, each
    distinct triangle whose box some ray's segment enters is read once, and
    each such (ray, triangle) pair is tested.  ``bounces``: [rays, pairs,
    triangles] a bounce (``Tracer.walk_counts``)."""
    rays, pairs, tris = (sum(int(b[i]) for b in bounces) for i in range(3))
    return rays * RAY_BYTES + tris * TRIANGLE_BYTES, pairs * OPS_TRIANGLE
