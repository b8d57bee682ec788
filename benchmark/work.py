"""The benchmark's frozen yardstick for roofline shares: the card's
published peaks, the least work a path-tracing iteration of analytic
primitives must do, and the least work a walk over a triangle mesh must do.

The operation counts are float32 operations of the reference tracer's
device functions (each add, multiply, division, square root, sine or
cosine, minimum, maximum, compare and absolute value is one; a fused
multiply-add two; a select and a negation none).  Transforms count at
their folded minimum, each scatter at its lobe's (the diffuse lobe where no
other is counted), a lobe's data-dependent branch at its cheaper side, and
the integer work of the draws not at all, so the bound is a lower bound on
the time, whatever implements the iteration.
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
# The other lobes of scatterRay (src/interactions.cu), each from its hit
# point (ro + rd t: 3 fused = 6) to its new origin, direction and
# throughput.  Shared parts: a normalize is a dot (5), a square root, a
# reciprocal and three products (10); a reflection i - 2 dot(n, i) n is a dot,
# a product and three fused (12); an origin off the surface by an epsilon
# along a unit vector three fused (6); the throughput three products (3).
# Mirror: reflect (12), normalize (10), origin along the normal (6), colour
# times albedo (3).
OPS_MIRROR = 6 + 12 + 10 + 6 + 3
# Transmissive: entering (a dot and a compare: 6), eta = 1/IOR (1), the ray
# and the side's normal normalized (20), glm::refract (cos a dot: 5; k = 1 -
# eta^2 (1 - cos^2): 5; its compare 1; sqrt(max(k, 0)) 2; i eta - n (eta cos
# + k'): 3 products, one fused and three fused: 11), the total internal
# reflection test on the result's length (a dot, a square root, a compare: 7),
# normalize (10), origin along the new direction (6), colour (3).
OPS_TRANSMISSIVE = 6 + 6 + 1 + 20 + 24 + 7 + 10 + 6 + 3
# Glass: cos (a dot: 5), FresnelDielectricEval (clamp 2; the side's compare,
# |cos|: 2; sin_i, cos_t = sqrt(max(1 - x^2, 0)): 4 each; sin_t 2; each of the
# two ratios two products, a difference, a sum and a division: 10; their
# squares' mean: a product, a fused and a product: 4; in all 28), the choice's
# compare (1), then the cheaper side, the reflection (12); normalize (10),
# origin along the new direction (6), colour (3).
OPS_GLASS = 6 + 5 + 28 + 1 + 12 + 10 + 6 + 3
# Cook-Torrance: wo = -normalize(rd) (10); F0 = 0.04 + (albedo - 0.04)
# metallic (a difference and a fused a channel: 9); cos clamped (a dot, min,
# max: 7); Schlick's F (1 - cos 1, its fifth power 3, a difference and a fused
# a channel 9: 13); the choice (max of three, clamp, compare: 5); then the
# cheaper side, the diffuse sample: the concentric disk (19), the frame (19),
# the direction (15) and its normalize (10), its pdf (1), f = albedo / pi (3)
# times 1 - F (6), pdf times 1 - max F (2): 75; normalize (10), cos (a dot and
# a max: 6), the pdf's compare (1), f cos / pdf (a division and three
# products: 4), origin along the new direction (6), colour (3).
OPS_MICROFACET = 6 + 10 + 9 + 7 + 13 + 5 + 75 + 10 + 6 + 1 + 4 + 6 + 3
OPS_LOBE = {"diffuse": OPS_SCATTER, "mirror": OPS_MIRROR, "transmissive": OPS_TRANSMISSIVE,
            "glass": OPS_GLASS, "microfacet": OPS_MICROFACET}
RAY_BYTES = 32  # a ray's origin and direction read (24), its t and id written (8)
TRIANGLE_BYTES = 36  # a triangle's three float32 corners, read once


def bound_ms(nbytes: float, ops: float) -> tuple:
    """The least time the card could take, and which of the two sets it:
    (ms, "bytes" | "operations")."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def iteration_work(pixels: int, boxes: int, spheres: int, alive: list,
                   lobes: dict = None) -> tuple:
    """(bytes, operations) of one spp iteration over ``pixels`` pixels of a
    scene of analytic primitives: the film read and written once and the
    alive counts written; a camera ray a pixel, then at each depth every
    path alive before it tests every primitive and scatters.  ``alive`` is
    the number of paths alive after each bounce.  ``lobes``, where the scene
    has a lobe besides the diffuse: the paths each lobe scatters at each
    bounce (``Tracer.lobe_counts``), each charged its lobe's operations in
    place of the diffuse's; a path that misses or ends on a light is
    charged the diffuse scatter's, as without ``lobes``."""
    depth = len(alive)
    live_before = [pixels] + [int(a) for a in alive[:-1]]
    per_ray = OPS_NEAREST + boxes * OPS_BOX + spheres * OPS_SPHERE + OPS_SCATTER
    ops = pixels * OPS_RAYGEN + sum(live_before) * per_ray
    for name, counts in (lobes or {}).items():
        ops += (OPS_LOBE[name] - OPS_SCATTER) * sum(int(c) for c in counts)
    return pixels * 24 + depth * 4, ops


def walk_work(bounces: list) -> tuple:
    """(bytes, operations) of one whole-frame iteration's mesh walks: at each
    bounce every ray alive before it reads its ray and writes its hit, each
    distinct triangle whose box some ray's segment enters is read once, and
    each such (ray, triangle) pair is tested.  ``bounces``: [rays, pairs,
    triangles] a bounce (``Tracer.walk_counts``)."""
    rays, pairs, tris = (sum(int(b[i]) for b in bounces) for i in range(3))
    return rays * RAY_BYTES + tris * TRIANGLE_BYTES, pairs * OPS_TRIANGLE
