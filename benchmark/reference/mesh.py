"""Nearest hit of rays against a triangle mesh, for the plain reference.

The triangles are grouped by the Morton order of their centroids into
groups of ``GROUP``, each with an axis-aligned box rounded outward.  A ray
tests every box, and every triangle of each box it enters nearer than its
limit (Moller-Trumbore, the reference's ``intersectTriangle``): the same
nearest hit as testing every triangle, found with less work.  The hit is
shaded with the winner's vertex normals, interpolated at its barycentric
coordinates.  Nothing here comes from the program's BVH, tiles or tables.

``walk_count`` counts the least work of any exact nearest-hit walk whose
nodes are axis-aligned boxes: the triangles whose own box a ray's segment
up to its nearest hit enters.  Every box that holds such a triangle holds
its box too, so the walk has to reach and test each of them.
"""

from __future__ import annotations

import numpy as np
import torch

GROUP = 64
BABY_EPSILON = 1e-5
RAY_CHUNK = 8192
PAIR_CHUNK = 1 << 15


def _morton(c: np.ndarray) -> np.ndarray:
    lo, hi = c.min(0), c.max(0)
    q = ((c - lo) / np.maximum(hi - lo, 1e-30) * 1023).astype(np.int64).clip(0, 1023)
    code = np.zeros(len(c), np.int64)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
    return code


class MeshIndex:
    def __init__(self, mesh, device, dtype):
        v = mesh.vertices.astype(np.float64)
        order = np.argsort(_morton(v.mean(axis=1)), kind="stable")
        t = len(order)
        groups = -(-t // GROUP)
        pad = groups * GROUP - t
        ids = np.concatenate([order, np.full(pad, -1)]).reshape(groups, GROUP)
        verts = np.concatenate([v[order], np.zeros((pad, 3, 3))]).reshape(groups, GROUP, 3, 3)
        valid = ids >= 0
        big = np.where(valid[..., None, None], verts, np.nan)
        lo = np.nanmin(big, axis=(1, 2)).astype(np.float32)
        hi = np.nanmax(big, axis=(1, 2)).astype(np.float32)
        span = float(np.max(hi - lo)) + 1.0
        lo = np.nextafter(lo - 1e-6 * span, -np.inf, dtype=np.float32)
        hi = np.nextafter(hi + 1e-6 * span, np.inf, dtype=np.float32)

        tv = lambda a: torch.as_tensor(a, device=device)
        corners = mesh.vertices[np.maximum(ids, 0)]  # [G, GROUP, 3, 3] float32
        self.lo, self.hi = tv(lo).to(dtype), tv(hi).to(dtype)  # [G, 3]
        self.verts = tv(corners).to(dtype)
        self.valid = tv(valid)
        self.normals = tv(mesh.vertex_normals).to(dtype)  # [T, 3, 3], file order
        # Each triangle's own box, exact in float32 (its corners' extremes).
        self.tri_lo = tv(corners.min(axis=2)).to(dtype)  # [G, GROUP, 3]
        self.tri_hi = tv(corners.max(axis=2)).to(dtype)
        self.ids = tv(ids)
        self.triangles = t
        self.material = mesh.material
        self.dtype = dtype

    def nearest(self, ro, rd, t_limit):
        """(t, normal) of the nearest triangle hit closer than ``t_limit``
        (t = the dtype's largest value where there is none): the normal is
        ``normalize(n0 (1 - u - v) + n1 u + n2 v)`` of the winner's vertex
        normals."""
        big = torch.finfo(self.dtype).max
        n = ro[0].numel()
        best_t = torch.full_like(ro[0], big)
        best_id = torch.full((n,), -1, dtype=torch.int64, device=ro[0].device)
        for s in range(0, n, RAY_CHUNK):
            sl = slice(s, s + RAY_CHUNK)
            o = tuple(c[sl] for c in ro)
            d = tuple(c[sl] for c in rd)
            t, tri = self._search(o, d, t_limit[sl])
            best_t[sl], best_id[sl] = t, tri
        hit = best_id >= 0
        tri = torch.clamp_min(best_id, 0)
        v = self.verts.reshape(-1, 3, 3)[self._slot(tri)]
        _, t, u, w = _triangle(ro, rd, v[:, 0], v[:, 1], v[:, 2])
        nrm = self.normals[tri]  # [N, 3 corners, 3]
        b = 1.0 - u - w
        nx = [nrm[:, 0, i] * b + nrm[:, 1, i] * u + nrm[:, 2, i] * w for i in range(3)]
        inv = 1.0 / torch.sqrt(nx[0] * nx[0] + nx[1] * nx[1] + nx[2] * nx[2])
        zero = torch.zeros_like(t)
        normal = tuple(torch.where(hit, c * inv, zero) for c in nx)
        return torch.where(hit, best_t, big), normal

    def _slot(self, tri):
        """Position of each triangle id in the grouped layout."""
        if not hasattr(self, "_slots"):
            flat = self.ids.reshape(-1)
            slots = torch.zeros(int(flat.max()) + 1, dtype=torch.int64, device=flat.device)
            keep = flat >= 0
            slots[flat[keep]] = torch.nonzero(keep).flatten()
            self._slots = slots
        return self._slots[tri]

    def walk_count(self, ro, rd, t_end, entered) -> int:
        """The (ray, triangle) pairs whose triangle's own box the ray's
        segment from its origin to ``t_end`` (its nearest hit over the whole
        scene; the dtype's largest value where it escapes) enters; each such
        triangle is set in ``entered`` [T] bool.  A group's box holds its
        triangles' boxes, so only the groups the segment enters are looked
        into."""
        pairs = 0
        for s in range(0, ro[0].numel(), RAY_CHUNK):
            sl = slice(s, s + RAY_CHUNK)
            o = tuple(c[sl] for c in ro)
            inv = [1.0 / c[sl] for c in rd]
            ray, grp = torch.nonzero(_enters(self.lo[None], self.hi[None], o, inv,
                                             t_end[sl], strict=False), as_tuple=True)
            for p in range(0, ray.numel(), PAIR_CHUNK):
                r, g = ray[p:p + PAIR_CHUNK], grp[p:p + PAIR_CHUNK]
                hit = _enters(self.tri_lo[g], self.tri_hi[g], tuple(c[r] for c in o),
                              [c[r] for c in inv], t_end[sl][r], strict=False)
                hit &= self.valid[g]
                pairs += int(hit.sum())
                entered[self.ids[g][hit]] = True
        return pairs

    def _search(self, ro, rd, t_limit):
        inv = [1.0 / c for c in rd]
        enter = _enters(self.lo[None], self.hi[None], ro, inv, t_limit)
        ray, grp = torch.nonzero(enter, as_tuple=True)
        big = torch.finfo(self.dtype).max
        pair_t, pair_id = [], []
        for s in range(0, ray.numel(), PAIR_CHUNK):
            r, g = ray[s:s + PAIR_CHUNK], grp[s:s + PAIR_CHUNK]
            v = self.verts[g]  # [P, GROUP, 3, 3]
            o = tuple(c[r][:, None] for c in ro)
            d = tuple(c[r][:, None] for c in rd)
            hit, t, _, _ = _triangle(o, d, v[..., 0, :], v[..., 1, :], v[..., 2, :])
            ok = hit & self.valid[g] & (t < t_limit[r][:, None])
            t = torch.where(ok, t, big)
            tmin, arg = torch.min(t, dim=1)
            pair_t.append(tmin)
            pair_id.append(torch.where(tmin < big, self.ids[g, arg], -1))
        best_t = torch.full_like(ro[0], big)
        none = torch.iinfo(torch.int64).max
        best_id = torch.full(ro[0].shape, none, dtype=torch.int64, device=ro[0].device)
        if pair_t:
            pair_t, pair_id = torch.cat(pair_t), torch.cat(pair_id)
            best_t.scatter_reduce_(0, ray, pair_t, "amin")
            # The lowest triangle id among the pairs that reach the minimum.
            at_min = (pair_t == best_t[ray]) & (pair_id >= 0)
            best_id.scatter_reduce_(0, ray, torch.where(at_min, pair_id, none), "amin")
        return best_t, torch.where(best_id == none, -1, best_id)


def _enters(lo, hi, ro, inv, t_limit, strict=True):
    """Slab test of rays against boxes ``lo``/``hi`` [R or 1, B, 3]: the
    ray's segment from its origin to ``t_limit`` enters the box (before the
    limit, or with ``strict`` False up to it).  Returns [R, B] bool."""
    near = far = None
    for a in range(3):
        t1 = (lo[..., a] - ro[a][:, None]) * inv[a][:, None]
        t2 = (hi[..., a] - ro[a][:, None]) * inv[a][:, None]
        lo_t, hi_t = torch.minimum(t1, t2), torch.maximum(t1, t2)
        near = lo_t if near is None else torch.maximum(near, lo_t)
        far = hi_t if far is None else torch.minimum(far, hi_t)
    before = near < t_limit[:, None] if strict else near <= t_limit[:, None]
    return (far >= near) & (far > 0) & before


def _triangle(ro, rd, v0, v1, v2):
    """Moller-Trumbore; vertices [..., 3] and ray components broadcastable
    to them.  Returns (hit, t, u, v)."""
    col = lambda a: (a[..., 0], a[..., 1], a[..., 2])
    p0 = col(v0)
    e1 = tuple(a - b for a, b in zip(col(v1), p0))
    e2 = tuple(a - b for a, b in zip(col(v2), p0))
    cross = lambda a, b: (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                          a[0] * b[1] - a[1] * b[0])
    dot = lambda a, b: a[0] * b[0] + a[1] * b[1] + a[2] * b[2]
    pvec = cross(rd, e2)
    det = dot(e1, pvec)
    det_ok = torch.abs(det) >= float(np.float32(BABY_EPSILON))
    inv_det = 1.0 / torch.where(det_ok, det, 1.0)
    tvec = tuple(a - b for a, b in zip(ro, p0))
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(rd, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = (det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > float(np.float32(BABY_EPSILON))))
    return hit, t, u, v
