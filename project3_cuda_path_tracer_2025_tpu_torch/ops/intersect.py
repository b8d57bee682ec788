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
the scene's constant transforms.  Meshes (``bvhMeshIntersectionTest``,
``src/intersections.cu:148-234``) go through one of three intersectors, as
in the JAX package: the MXU tables' mono traversal (``ops.intersect_mxu``,
a CUDA kernel on the card), the threaded-BVH walk, or the brute-force
oracle.  All three return the same closest hit (strictly closer wins, the
lowest triangle id on a tie).
"""

from __future__ import annotations

from typing import NamedTuple

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


class MeshHit(NamedTuple):
    t: torch.Tensor  # best triangle t (t_limit when none)
    tri: torch.Tensor  # i32 best triangle index (-1 = none)
    u: torch.Tensor
    v: torch.Tensor


def triangle_intersection(ro: Vec3, rd: Vec3, v0: Vec3, v1: Vec3, v2: Vec3,
                          baby_eps: float):
    """Moller-Trumbore (``intersectTriangle``, ``src/intersections.cu:112-145``);
    returns (hit mask, t, u, v)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = vec.cross(rd, e2)
    det = vec.dot(e1, pvec)
    det_ok = torch.abs(det) >= f32(baby_eps)
    inv_det = 1.0 / torch.where(det_ok, det, 1.0)
    tvec = ro - v0
    u = vec.dot(tvec, pvec) * inv_det
    qvec = vec.cross(tvec, e1)
    v = vec.dot(rd, qvec) * inv_det
    t = vec.dot(e2, qvec) * inv_det
    hit = (
        det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > f32(baby_eps))
    )
    return hit, t, u, v


def _first_min(vals: torch.Tensor, ids: torch.Tensor):
    """Row minimum of ``vals`` [R, K] and the lowest of ``ids`` [K] that
    attains it."""
    vmin = torch.min(vals, dim=1, keepdim=True).values
    big = torch.iinfo(ids.dtype).max
    first = torch.min(torch.where(vals <= vmin, ids[None, :], big), dim=1).values
    return vmin[:, 0], first


def mesh_intersect_bvh(
    dev: DeviceScene,
    static: SceneStatic,
    ro: Vec3,
    rd: Vec3,
    active: torch.Tensor,
    t_limit: torch.Tensor,
    baby_eps: float,
) -> MeshHit:
    """Threaded-BVH closest hit: each ray walks its direction octant's
    pre-order layout (near child first) with one node cursor and no stack,
    pruning on the AABB entry distance against its best t.  Each step
    gathers one 16-float node record and the leaf's [leaf_size, 12]
    triangle block; only the rays still walking take part in a step."""
    m = static.num_nodes
    k_leaf = static.leaf_size
    nodes, tris = dev.bvh.nodes, dev.bvh.tris
    num_tris = static.num_triangles
    device = ro.x.device
    base = (
        (rd.x < 0).to(torch.int32) + 2 * (rd.y < 0).to(torch.int32)
        + 4 * (rd.z < 0).to(torch.int32)
    ) * m
    node = torch.where(active, 0, m).to(torch.int32)
    best_t = t_limit.to(torch.float32).clone()
    best_tri = torch.full_like(node, -1)
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    inv = Vec3(1.0 / rd.x, 1.0 / rd.y, 1.0 / rd.z)
    kar = torch.arange(k_leaf, dtype=torch.int32, device=device)
    while True:
        ids = torch.nonzero(node < m).flatten()
        if ids.numel() == 0:
            break
        nidx = node[ids]
        rec = nodes[(base[ids] + nidx).long()]  # [R, 16]
        o = Vec3(ro.x[ids], ro.y[ids], ro.z[ids])
        iv = Vec3(inv.x[ids], inv.y[ids], inv.z[ids])
        bt = best_t[ids]
        t1x, t2x = (rec[:, 0] - o.x) * iv.x, (rec[:, 3] - o.x) * iv.x
        t1y, t2y = (rec[:, 1] - o.y) * iv.y, (rec[:, 4] - o.y) * iv.y
        t1z, t2z = (rec[:, 2] - o.z) * iv.z, (rec[:, 5] - o.z) * iv.z
        tlo = torch.maximum(
            torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)),
            torch.minimum(t1z, t2z),
        )
        thi = torch.minimum(
            torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)),
            torch.maximum(t1z, t2z),
        )
        aabb_hit = (thi >= tlo) & (thi > 0.0) & (tlo < bt)
        miss_link = rec[:, 6].to(torch.int32)
        start = rec[:, 7].to(torch.int32)
        count = rec[:, 8].to(torch.int32)
        is_leaf = count > 0
        leaf = torch.nonzero(aabb_hit & is_leaf).flatten()
        if leaf.numel():
            r = ids[leaf]
            tri_idx = torch.clamp(start[leaf, None] + kar[None, :], 0, num_tris - 1)
            blk = tris[tri_idx.long()]  # [L, K, 12]
            col = lambda a: Vec3(blk[..., a], blk[..., a + 1], blk[..., a + 2])
            v0, e1, e2 = col(0), col(3), col(6)
            d = Vec3(rd.x[r, None], rd.y[r, None], rd.z[r, None])
            oo = Vec3(ro.x[r, None], ro.y[r, None], ro.z[r, None])
            pvec = vec.cross(d, e2)
            det = vec.dot(e1, pvec)
            det_ok = torch.abs(det) >= f32(baby_eps)
            inv_det = 1.0 / torch.where(det_ok, det, 1.0)
            tvec = oo - v0
            u = vec.dot(tvec, pvec) * inv_det
            qvec = vec.cross(tvec, e1)
            v = vec.dot(d, qvec) * inv_det
            tt = vec.dot(e2, qvec) * inv_det
            hit = (
                det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
                & (tt > f32(baby_eps))
            )
            btl = bt[leaf, None]
            valid = (kar[None, :] < count[leaf, None]) & hit
            ttm = torch.where(valid & (tt > 0.0) & (tt < btl), tt, FLT_MAX)
            cand_t, kb = _first_min(ttm, kar)
            closer = cand_t < btl[:, 0]
            rows = torch.arange(leaf.numel(), device=device)
            kb = kb.long()
            best_t[r] = torch.where(closer, cand_t, best_t[r])
            best_tri[r] = torch.where(closer, tri_idx[rows, kb], best_tri[r])
            best_u[r] = torch.where(closer, u[rows, kb], best_u[r])
            best_v[r] = torch.where(closer, v[rows, kb], best_v[r])
        descend = aabb_hit & ~is_leaf
        node[ids] = torch.where(descend, nidx + 1, miss_link)
    return MeshHit(t=best_t, tri=best_tri, u=best_u, v=best_v)


def mesh_intersect_brute(
    dev: DeviceScene,
    static: SceneStatic,
    ro: Vec3,
    rd: Vec3,
    active: torch.Tensor,
    t_limit: torch.Tensor,
    baby_eps: float,
) -> MeshHit:
    """Brute-force sweep over every triangle: the oracle for the other
    intersectors (the reference's ``NAIVE_MESH_LOADING`` path,
    ``src/pathtrace.cu:365-395``).  Strictly closer wins, so the lowest
    triangle index wins ties; blocks of triangles are tested at once and
    merged in order, which keeps that rule."""
    n = ro.x.shape[0]
    t_cnt = static.num_triangles
    tr = dev.triangles
    device = ro.x.device
    best_t = t_limit.to(torch.float32).clone()
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=device)
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    o = Vec3(ro.x[:, None], ro.y[:, None], ro.z[:, None])
    d = Vec3(rd.x[:, None], rd.y[:, None], rd.z[:, None])
    lim = best_t[:, None].clone()
    block = max(1, min(t_cnt, (1 << 21) // max(n, 1)))
    rows = torch.arange(n, device=device)
    for s in range(0, t_cnt, block):
        e = min(t_cnt, s + block)
        row = lambda v3: Vec3(v3.x[None, s:e], v3.y[None, s:e], v3.z[None, s:e])
        hit, t, u, v = triangle_intersection(o, d, row(tr.v0), row(tr.v1), row(tr.v2),
                                             baby_eps)
        ok = active[:, None] & hit & (t > 0.0) & (t < lim)
        cand = torch.where(ok, t, float("inf"))
        ids = torch.arange(s, e, dtype=torch.int32, device=device)
        cmin, first = _first_min(cand, ids)
        closer = cmin < best_t
        j = (first.long() - s).clamp(0, e - s - 1)
        best_t = torch.where(closer, cmin, best_t)
        best_tri = torch.where(closer, first, best_tri)
        best_u = torch.where(closer, u[rows, j], best_u)
        best_v = torch.where(closer, v[rows, j], best_v)
    return MeshHit(t=best_t, tri=best_tri, u=best_u, v=best_v)


def resolve_mesh_intersector(cfg: RenderConfig, device) -> str:
    """``cfg.mesh_intersector`` for a device: "auto" is the MXU tables'
    traversal on a CUDA device and the threaded walk on the CPU;
    ``bvh_acceleration=False`` turns auto/threaded into brute force."""
    mode = cfg.mesh_intersector
    if not cfg.bvh_acceleration and mode in ("auto", "threaded"):
        return "brute"
    if mode == "auto":
        return "mxu" if torch.device(device).type == "cuda" else "threaded"
    return mode


def ray_sorting_on(cfg: RenderConfig, device) -> bool:
    """``cfg.ray_sorting``: "auto" sorts on a CUDA device, not on the CPU."""
    return cfg.ray_sorting == "on" or (
        cfg.ray_sorting == "auto" and torch.device(device).type == "cuda"
    )


def intersect_scene(
    dev: DeviceScene | None,
    static: SceneStatic,
    paths: PathState,
    cfg: RenderConfig,
) -> Intersections:
    """Nearest hit over the analytic prims + mesh, with the reference's final
    normal flip toward the ray (``src/pathtrace.cu:423-446``)."""
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

    is_tri = torch.zeros_like(hit_any)
    uv_u = uv_v = zero
    dpdu = dpdv = Vec3(zero, zero, zero)

    if static.has_triangles:
        active = paths.alive
        mode = resolve_mesh_intersector(cfg, ro.x.device)
        if mode == "mxu":
            from . import intersect_mxu

            mh = intersect_mxu.mesh_intersect_mxu(
                dev.mxu_mesh, static.num_triangles, static.mxu_padded_tris,
                ro, rd, active, t_min, cfg.baby_epsilon,
                sort_rays=ray_sorting_on(cfg, ro.x.device),
                sort_bits=cfg.ray_sort_bits,
                sort_dir_bits=cfg.ray_sort_dir_bits,
                mesh_bounds=static.mesh_bounds,
                compute_uv=False,  # derived below from the resolved rows
                **intersect_mxu.traversal_flags(
                    cfg.mxu_traversal, static.mxu_padded_tris
                ),
            )
            at = intersect_mxu.resolve_attributes(
                dev.mxu_mesh, static.mxu_padded_tris, mh.tri
            )
            uu, vv = intersect_mxu.winner_uv(
                dev.mxu_mesh, static.mxu_padded_tris, mh.tri, ro, rd,
                cfg.baby_epsilon, attr_rows=at,
            )
            mh = mh._replace(u=uu, v=vv)
            cols = lambda a: Vec3(at[:, a], at[:, a + 1], at[:, a + 2])
            n0, n1, n2 = cols(0), cols(3), cols(6)
            w = 1.0 - mh.u - mh.v
            tri_uv_u = at[:, 9] * w + at[:, 11] * mh.u + at[:, 13] * mh.v
            tri_uv_v = at[:, 10] * w + at[:, 12] * mh.u + at[:, 14] * mh.v
            tri_dpdu, tri_dpdv = cols(15), cols(18)
            tri_mat = at[:, 21].to(torch.int32)
        else:
            if mode == "threaded":
                mh = mesh_intersect_bvh(dev, static, ro, rd, active, t_min,
                                        cfg.baby_epsilon)
            elif mode == "brute":
                mh = mesh_intersect_brute(dev, static, ro, rd, active, t_min,
                                          cfg.baby_epsilon)
            else:
                raise ValueError(f"mesh_intersector={mode!r}")
            w = 1.0 - mh.u - mh.v
            tidx = torch.clamp(mh.tri, 0, static.num_triangles - 1).long()
            tris = dev.triangles
            n0, n1, n2 = (vec.select_gather(x, tidx) for x in (tris.n0, tris.n1, tris.n2))
            tri_uv_u = tris.uv0u[tidx] * w + tris.uv1u[tidx] * mh.u + tris.uv2u[tidx] * mh.v
            tri_uv_v = tris.uv0v[tidx] * w + tris.uv1v[tidx] * mh.u + tris.uv2v[tidx] * mh.v
            tri_dpdu = vec.select_gather(tris.dpdu, tidx)
            tri_dpdv = vec.select_gather(tris.dpdv, tidx)
            tri_mat = tris.material_id[tidx]
        tri_hit = mh.tri >= 0
        tri_normal = vec.normalize(n0 * w + n1 * mh.u + n2 * mh.v)
        t_min = torch.where(tri_hit, mh.t, t_min)
        hit_any = hit_any | tri_hit
        normal = vec.where(tri_hit, tri_normal, normal)
        mat_id = torch.where(tri_hit, tri_mat, mat_id)
        is_tri = tri_hit
        uv_u = torch.where(tri_hit, tri_uv_u, zero)
        uv_v = torch.where(tri_hit, tri_uv_v, zero)
        dpdu = vec.where(tri_hit, tri_dpdu, dpdu)
        dpdv = vec.where(tri_hit, tri_dpdv, dpdv)

    # Flip normal to face the ray origin (src/pathtrace.cu:429-431).
    flip = vec.dot(rd, normal) > 0.0
    normal = vec.where(flip, -normal, normal)

    return Intersections(
        t=torch.where(hit_any, t_min, -1.0),
        normal=normal,
        material_id=torch.where(hit_any, mat_id, 0),
        uv_u=uv_u,
        uv_v=uv_v,
        dpdu=dpdu,
        dpdv=dpdv,
        is_triangle=is_tri,
    )
