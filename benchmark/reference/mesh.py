"""Nearest hit of rays against a triangle mesh, for the plain reference.

The triangles are grouped by the Morton order of their centroids into
groups of ``GROUP``, each with an axis-aligned box rounded outward.  A ray
tests every box, and every triangle of each box it enters nearer than its
limit (Moller-Trumbore, the reference's ``intersectTriangle``): the same
nearest hit as testing every triangle, found with less work.  Nothing here
comes from the program's BVH, tiles or tables.
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
        self.lo, self.hi = tv(lo).to(dtype), tv(hi).to(dtype)  # [G, 3]
        self.verts = tv(mesh.vertices[np.maximum(ids, 0)]).to(dtype)  # [G, GROUP, 3, 3]
        self.valid = tv(valid)
        self.normals = tv(mesh.normals).to(dtype)  # [T, 3], file order
        self.ids = tv(ids)
        self.material = mesh.material
        self.dtype = dtype

    def nearest(self, ro, rd, t_limit):
        """(t, flat normal) of the nearest triangle hit closer than
        ``t_limit`` (t = the dtype's largest value where there is none)."""
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
        nrm = self.normals[tri]
        b = 1.0 - u - w
        nx = [nrm[:, i] * b + nrm[:, i] * u + nrm[:, i] * w for i in range(3)]
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

    def _search(self, ro, rd, t_limit):
        inv = [1.0 / c for c in rd]
        near = far = None
        for a in range(3):
            t1 = (self.lo[None, :, a] - ro[a][:, None]) * inv[a][:, None]
            t2 = (self.hi[None, :, a] - ro[a][:, None]) * inv[a][:, None]
            lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
            near = lo if near is None else torch.maximum(near, lo)
            far = hi if far is None else torch.minimum(far, hi)
        enter = (far >= near) & (far > 0) & (near < t_limit[:, None])
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
