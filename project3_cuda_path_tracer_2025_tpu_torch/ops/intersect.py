"""Intersection engine for analytic primitives.

Parity targets:

* ``boxIntersectionTest`` (``src/intersections.cu:3-57``): slab test in
  object space (unit cube [-0.5, 0.5]^3), object-space direction normalized,
  returned t is the *world distance* |origin - hit point|, hit point advanced
  by the 1e-4 ray epsilon (``getPointOnRay``, ``src/intersections.h:29-32``).
* ``sphereIntersectionTest`` (``:59-109``): radius-0.5 unit sphere.
* ``computeIntersections`` (``src/pathtrace.cu:298-448``): nearest-hit
  resolution over the analytic prims, final normal flip toward the ray.

Dense tensor ops over [N] rays; the prims are an unrolled Python loop over
the scene's constant transforms.  Triangle meshes are not ported yet
(``ROADMAP.md``, Queue 1: meshes).
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from ..scene.device import DeviceScene, GeomConst, SceneStatic
from ..scene.types import GeomType
from ..utils import vec
from ..utils.vec import Vec3, f32
from .rays import Intersections, PathState

FLT_MAX = 3.402823466e38


def box_intersection(
    g: GeomConst, ro: Vec3, rd: Vec3, ray_eps: float
) -> tuple[torch.Tensor, Vec3, Vec3]:
    """Returns (t_world [-1 = miss], world hit point, world normal)."""
    qo = vec.transform_point(g.inverse, ro)
    qd = vec.normalize(vec.transform_vector(g.inverse, rd))

    tmin = torch.full_like(qo.x, -1e38)
    tmax = torch.full_like(qo.x, 1e38)
    zero = torch.zeros_like(qo.x)
    tmin_n = Vec3(zero, zero, zero)
    tmax_n = Vec3(zero, zero, zero)

    for axis in range(3):
        o = (qo.x, qo.y, qo.z)[axis]
        d = (qd.x, qd.y, qd.z)[axis]
        # Reference divides with no zero guard (src/intersections.cu:21-24);
        # IEEE inf/nan comparisons below match CUDA.  One reciprocal
        # replaces the two divisions.
        inv = 1.0 / d
        t1 = (-0.5 - o) * inv
        t2 = (0.5 - o) * inv
        ta = torch.minimum(t1, t2)
        tb = torch.maximum(t1, t2)
        sign = torch.where(t2 < t1, 1.0, -1.0)
        n_axis = [zero, zero, zero]
        n_axis[axis] = sign
        n = Vec3(*n_axis)

        upd_min = (ta > 0) & (ta > tmin)
        tmin = torch.where(upd_min, ta, tmin)
        tmin_n = vec.where(upd_min, n, tmin_n)
        upd_max = tb < tmax
        tmax = torch.where(upd_max, tb, tmax)
        tmax_n = vec.where(upd_max, n, tmax_n)

    hit = (tmax >= tmin) & (tmax > 0)
    inside = tmin <= 0
    t_obj = torch.where(inside, tmax, tmin)
    n_obj = vec.where(inside, tmax_n, tmin_n)

    p_obj = qo + qd * (t_obj - f32(ray_eps))  # getPointOnRay
    p_world = vec.transform_point(g.transform, p_obj)
    normal = vec.normalize(vec.transform_vector(g.inv_transpose, n_obj))
    t_world = vec.length(ro - p_world)
    return torch.where(hit, t_world, -1.0), p_world, normal


def sphere_intersection(
    g: GeomConst, ro: Vec3, rd: Vec3, ray_eps: float
) -> tuple[torch.Tensor, Vec3, Vec3]:
    """Unit sphere (radius 0.5) in object space (src/intersections.cu:59-109)."""
    o = vec.transform_point(g.inverse, ro)
    d = vec.normalize(vec.transform_vector(g.inverse, rd))

    v_dot_d = vec.dot(o, d)
    radicand = v_dot_d * v_dot_d - (vec.dot(o, o) - 0.25)
    has_root = radicand >= 0

    sq = torch.sqrt(torch.clamp_min(radicand, 0.0))
    t1 = -v_dot_d + sq
    t2 = -v_dot_d - sq

    both_neg = (t1 < 0) & (t2 < 0)
    both_pos = (t1 > 0) & (t2 > 0)
    t_obj = torch.where(both_pos, torch.minimum(t1, t2), torch.maximum(t1, t2))
    hit = has_root & ~both_neg

    p_obj = o + d * (t_obj - f32(ray_eps))
    p_world = vec.transform_point(g.transform, p_obj)
    # Sphere normal: invTranspose * object-space point (not flipped here;
    # the flip toward the ray happens in intersect_scene).
    normal = vec.normalize(vec.transform_vector(g.inv_transpose, p_obj))
    t_world = vec.length(ro - p_world)
    return torch.where(hit, t_world, -1.0), p_world, normal


def _prim_intersection(g: GeomConst, ro: Vec3, rd: Vec3, ray_eps: float):
    if g.gtype == int(GeomType.CUBE):
        return box_intersection(g, ro, rd, ray_eps)
    return sphere_intersection(g, ro, rd, ray_eps)


def prim_t_min(static: SceneStatic, cfg: RenderConfig, ro: Vec3, rd: Vec3):
    """Nearest analytic-prim t per ray (FLT_MAX = none): the mesh
    intersector's t_limit prune."""
    t_min = torch.full_like(ro.x, FLT_MAX)
    for g in static.geoms:
        t, _, _ = _prim_intersection(g, ro, rd, cfg.ray_advance_epsilon)
        t_min = torch.minimum(t_min, torch.where(t > 0.0, t, FLT_MAX))
    return t_min


def intersect_scene(
    dev: DeviceScene | None,
    static: SceneStatic,
    paths: PathState,
    cfg: RenderConfig,
) -> Intersections:
    """Nearest hit over the analytic prims, with the reference's final
    normal flip toward the ray (``src/pathtrace.cu:423-446``)."""
    if static.has_triangles:
        raise NotImplementedError(
            "mesh intersection is not ported yet (ROADMAP.md, Queue 1: meshes)"
        )
    ro, rd = paths.origin, paths.direction
    zero = torch.zeros_like(ro.x)

    t_min = torch.full_like(ro.x, FLT_MAX)
    hit_any = torch.zeros_like(ro.x, dtype=torch.bool)
    normal = Vec3(zero, zero, zero)
    mat_id = torch.full_like(ro.x, -1, dtype=torch.int32)

    for g in static.geoms:
        t, _, nrm = _prim_intersection(g, ro, rd, cfg.ray_advance_epsilon)
        closer = (t > 0.0) & (t < t_min)
        t_min = torch.where(closer, t, t_min)
        hit_any = hit_any | closer
        normal = vec.where(closer, nrm, normal)
        mat_id = torch.where(closer, g.material_id, mat_id)

    # Flip normal to face the ray origin (src/pathtrace.cu:429-431).
    flip = vec.dot(rd, normal) > 0.0
    normal = vec.where(flip, -normal, normal)

    return Intersections(
        t=torch.where(hit_any, t_min, -1.0),
        normal=normal,
        material_id=torch.where(hit_any, mat_id, 0),
        uv_u=zero,
        uv_v=zero,
        dpdu=Vec3(zero, zero, zero),
        dpdv=Vec3(zero, zero, zero),
        is_triangle=torch.zeros_like(hit_any),
    )
