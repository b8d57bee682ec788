"""Mesh closest hit for meshes of up to 8 tiles: the host side of the JAX
package's MXU intersector, and its mono traversal as a CUDA kernel.

The JAX package (``project3_cuda_path_tracer_2025_tpu/ops/intersect_mxu.py``)
writes Moller-Trumbore as bilinear forms: with the ray feature
``R = [d, o x d, o, 1]`` (origin recentred on the mesh), the four numerators
``det, u*det, v*det, t*det`` of every triangle are ``R @ F`` for a
per-triangle column block ``F`` of 19 nonzero coefficients
(``build_mxu_tables``).  Its Pallas kernels run that product on the TPU's
matrix unit, tile by tile of 1,024 triangles.  The result is fixed by the
candidate contract (``:106-133`` there): for each ray, the minimum ``t``
over the tiles whose widened slab the ray itself enters before its
``t_limit``, hits confined to that slab interval, ties to the lowest
triangle id.  Any traversal that covers those candidates gives it.

This module keeps the tables, culls, sort keys and attribute resolves as
torch code, and ports the traversal that ``mxu_traversal="auto"`` picks up
to ``MONO_MAX_TILES`` tiles, ``_mono_kernel``: ``mono_intersect`` launches
``csrc/fused_mesh.cu::ptt_mono_kernel`` on CUDA tensors and runs
``mono_intersect_plain`` on CPU tensors.  Both evaluate each candidate pair
with the same float32 operations in the same order (each numerator is a
chain of fused multiply-adds in the fixed order of ``MONO_COEF``, never a
matmul; ``fma32`` gives the plain version the kernel's single rounding),
so they agree bit for bit, and with the JAX package's ``jnp.dot`` on the
CPU, which accumulates in the same order.  The planned, streamed, binned
and sweep traversals raise (``ROADMAP.md``, Queue 2 #5-#10).  The port reads no ``PTT_*`` environment
variable: the constants below are the JAX package's defaults.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..utils.vec import Vec3, f32
from . import kernels
from .intersect import MeshHit

RAY_TILE = 256  # rays per block of the JAX kernels (padding unit)
TRI_TILE = 1024  # triangles per tile
GROUP_TILES = 1
GROUP_TRIS = TRI_TILE * GROUP_TILES
NUM_F = 16  # padded ray-feature width (10 used)
CHUNK_TRIS = 32 * 1024  # the JAX package's VMEM-resident table bound
MONO_MAX_TILES = 8  # mono traversal band (tiles)
BINNED_AUTO_MIN = 128 * 1024
BINNED_AUTO_MAX = 320 * 1024
KEY_INLINE_MAX_CT = 24  # the shade kernel emits sort keys up to this many tiles

SLAB_EPS_REL = 4e-6
SLAB_EPS_ABS = 1e-4
INT_MAX = 0x7FFFFFFF
DEAD_KEY = (1 << 30) + 1  # coherence key of a dead ray

# The mono kernel's per-triangle coefficient row (``MXUMeshTables.coef``):
# which feature rows of which numerator, in summation order.  det sums
# features 0-2, u and v features 0-5, t features 6-9, each left to right.
MONO_COEF = (("det", range(0, 3)), ("u", range(0, 6)), ("v", range(0, 6)),
             ("t", range(6, 10)))
COEF_W = 20  # 19 coefficients + 1 pad


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, Queue 2 #5-#10: the "
        "traversals for larger meshes)"
    )


def _widen_slab(tlo, thi, k=1):
    """Lower ``tlo`` and raise ``thi`` by relative + absolute margins
    (``k=2`` for culls that must be supersets of the k=1 member test)."""
    return (
        tlo - f32(k * SLAB_EPS_REL) * torch.abs(tlo) - f32(k * SLAB_EPS_ABS),
        thi + f32(k * SLAB_EPS_REL) * torch.abs(thi) + f32(k * SLAB_EPS_ABS),
    )


def _slab(lo, hi, os, inv):
    """Slab entry/exit of rays (``os``: recentred origins, ``inv``:
    reciprocal directions, both Vec3 of [R]) against one box given as six
    floats; the axis order of the min/max chains is the kernels'."""
    t1x, t2x = (lo[0] - os.x) * inv.x, (hi[0] - os.x) * inv.x
    t1y, t2y = (lo[1] - os.y) * inv.y, (hi[1] - os.y) * inv.y
    t1z, t2z = (lo[2] - os.z) * inv.z, (hi[2] - os.z) * inv.z
    tlo = torch.maximum(
        torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)),
        torch.minimum(t1z, t2z),
    )
    thi = torch.minimum(
        torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)),
        torch.maximum(t1z, t2z),
    )
    return tlo, thi


def _member_slab(row, os, inv, tlim):
    """Per-ray candidate test against one tile row (``row``: 8 floats):
    can the ray enter the box before its t_limit?  Returns (member, tlo,
    thi) with the k=1 widened interval -- THE candidate-set definition."""
    tlo, thi = _slab(row[0:3], row[3:6], os, inv)
    tlo, thi = _widen_slab(tlo, thi)
    member = (thi >= tlo) & (thi > 0.0) & (tlo < tlim)
    return member, tlo, thi


def _inv_dir(d: Vec3) -> Vec3:
    """1 / d with exact zeros replaced by 1e-20 (never an inf from a 0)."""
    return Vec3(*(1.0 / torch.where(c == 0.0, 1e-20, c) for c in d))


class MXUMeshTables(NamedTuple):
    """Per-triangle tables of the mesh (leaf order, padded to whole tiles).

    ``features``, ``tile_aabb``, ``attrs``, ``attrs_shade`` and ``center``
    are the JAX package's arrays exactly.  ``coef`` is ``features``
    re-laid out as one row per triangle in ``MONO_COEF`` order, the layout
    the mono kernel reads.  (The JAX package's ``group_aabb`` serves only
    the sweep traversal, which is not ported.)"""

    features: torch.Tensor  # [NUM_F, 4*Tp] f32: (det|u|v|t) columns per tile
    tile_aabb: torch.Tensor  # [Ct, 8] f32: xyz min, xyz max (recentred), pad
    attrs: torch.Tensor  # [Tp, 40] f32
    attrs_shade: torch.Tensor  # [Tp, 24] f32
    center: torch.Tensor  # [3] f32
    coef: torch.Tensor  # [Tp, COEF_W] f32


def mono_coefficients(features: torch.Tensor) -> torch.Tensor:
    """``features`` [NUM_F, 4*Tp] -> [Tp, COEF_W] rows in ``MONO_COEF``
    order (the same float32 values, re-laid out)."""
    tp = features.shape[1] // 4
    q = features.reshape(NUM_F, tp // TRI_TILE, 4, TRI_TILE)
    q = q.permute(1, 3, 2, 0).reshape(tp, 4, NUM_F)  # [tri, numerator, feature]
    cols = [q[:, i, list(rows)] for i, (_, rows) in enumerate(MONO_COEF)]
    pad = torch.zeros((tp, COEF_W - 19), dtype=features.dtype, device=features.device)
    return torch.cat(cols + [pad], dim=1).contiguous()


def build_mxu_tables(
    pos: np.ndarray,  # [T, 3, 3] leaf-ordered triangle vertices
    nrm: np.ndarray,  # [T, 3, 3]
    uv: np.ndarray,  # [T, 3, 2]
    dpdu: np.ndarray,  # [T, 3]
    dpdv: np.ndarray,  # [T, 3]
    mat: np.ndarray,  # [T]
    device="cpu",
) -> MXUMeshTables:
    """The JAX package's ``build_mxu_tables`` (float64 host arithmetic,
    float32 tables), without the super-tile padding (off by default)."""
    t = pos.shape[0]
    tp = ((t + GROUP_TRIS - 1) // GROUP_TRIS) * GROUP_TRIS
    center = pos.reshape(-1, 3).mean(axis=0).astype(np.float32)

    v0 = pos[:, 0].astype(np.float64) - center
    e1 = (pos[:, 1] - pos[:, 0]).astype(np.float64)
    e2 = (pos[:, 2] - pos[:, 0]).astype(np.float64)
    a = np.cross(e2, e1)
    e2xv0 = np.cross(e2, v0)
    v0xe1 = np.cross(v0, e1)
    e1xe2 = np.cross(e1, e2)
    v0_dot = np.einsum("ij,ij->i", v0, e1xe2)

    feat = np.zeros((NUM_F, 4 * tp), np.float32)
    k = TRI_TILE
    gidx = np.arange(t)
    det_c = (gidx // k) * 4 * k + gidx % k
    u_c, v_c, t_c = det_c + k, det_c + 2 * k, det_c + 3 * k
    feat[0:3, det_c] = a.T  # det = d . (e2 x e1)
    feat[0:3, u_c] = -e2xv0.T  # u_num = (o x d) . e2 - d . (e2 x v0)
    feat[3:6, u_c] = e2.T
    feat[0:3, v_c] = -v0xe1.T  # v_num = -(o x d) . e1 - d . (v0 x e1)
    feat[3:6, v_c] = -e1.T
    feat[6:9, t_c] = e1xe2.T  # t_num = o . (e1 x e2) - v0 . (e1 x e2)
    feat[9, t_c] = -v0_dot
    # Padded (fake) triangles keep all-zero features: det == 0, never hit.

    shifted = pos.astype(np.float64) - center
    ct = tp // TRI_TILE
    tile_aabb = np.zeros((ct, 8), np.float32)
    for i in range(ct):
        lo = i * TRI_TILE
        if lo >= t:  # empty padding tile: inverted bounds never hit
            tile_aabb[i, 0:3] = 1e30
            tile_aabb[i, 3:6] = -1e30
            continue
        tv = shifted[lo:min(t, lo + TRI_TILE)].reshape(-1, 3)
        bmin, bmax = tv.min(axis=0), tv.max(axis=0)
        # Round outward, so a tile's float32 box holds every vertex.
        lo32, hi32 = bmin.astype(np.float32), bmax.astype(np.float32)
        lo32 = np.where(lo32.astype(np.float64) > bmin,
                        np.nextafter(lo32, np.float32(-np.inf)), lo32)
        hi32 = np.where(hi32.astype(np.float64) < bmax,
                        np.nextafter(hi32, np.float32(np.inf)), hi32)
        tile_aabb[i, 0:3] = lo32
        tile_aabb[i, 3:6] = hi32

    attrs = np.zeros((tp, 40), np.float32)
    attrs[:t, 0:3] = nrm[:, 0]
    attrs[:t, 3:6] = nrm[:, 1]
    attrs[:t, 6:9] = nrm[:, 2]
    attrs[:t, 9:11] = uv[:, 0]
    attrs[:t, 11:13] = uv[:, 1]
    attrs[:t, 13:15] = uv[:, 2]
    attrs[:t, 15:18] = dpdu
    attrs[:t, 18:21] = dpdv
    attrs[:t, 21] = mat.astype(np.float32)
    attrs[:t, 24:27] = pos[:, 0]
    attrs[:t, 27:30] = pos[:, 1] - pos[:, 0]
    attrs[:t, 30:33] = pos[:, 2] - pos[:, 0]
    attrs_shade = np.zeros((tp, 24), np.float32)
    attrs_shade[:, 0:9] = attrs[:, 0:9]  # vertex normals
    attrs_shade[:, 9] = attrs[:, 21]  # material id
    attrs_shade[:, 10:19] = attrs[:, 24:33]  # v0, e1, e2
    return tables_from_arrays(feat, tile_aabb, attrs, attrs_shade, center, device)


def tables_from_arrays(features, tile_aabb, attrs, attrs_shade, center,
                       device="cpu") -> MXUMeshTables:
    """``MXUMeshTables`` from numpy arrays (copied), adding ``coef``."""
    f = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    features = f(features)
    return MXUMeshTables(
        features=features, tile_aabb=f(tile_aabb), attrs=f(attrs),
        attrs_shade=f(attrs_shade), center=f(center),
        coef=mono_coefficients(features),
    )


def root_hit_mask(tile_aabb, center, ox, oy, oz, dx, dy, dz, t_limit):
    """Per-ray BVH-root test against the envelope of the tile boxes (k=2
    widening): False only where no tile can be a candidate."""
    lo = torch.min(tile_aabb[:, 0:3], dim=0).values
    hi = torch.max(tile_aabb[:, 3:6], dim=0).values
    os = Vec3(ox - center[0], oy - center[1], oz - center[2])
    tlo, thi = _slab(lo, hi, os, _inv_dir(Vec3(dx, dy, dz)))
    tlo, thi = _widen_slab(tlo, thi, k=2)
    return (thi >= tlo) & (thi > 0.0) & (tlo < t_limit)


# ---------------------------------------------------------------------------
# Coherence sort keys (any permutation is bit-exact downstream: these only
# decide which rays share a block, i.e. speed).
# ---------------------------------------------------------------------------

def _morton_spread3(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits of v to every 3rd bit (int32)."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _quant_dir(d: torch.Tensor, dscale: int) -> torch.Tensor:
    t = torch.clamp((d + 1.0) * 0.5, 0.0, 1.0)
    return (t * float(dscale)).to(torch.int32)


def _dir_morton(dx, dy, dz, bits: int) -> torch.Tensor:
    s = (1 << bits) - 1
    return (
        _morton_spread3(_quant_dir(dx, s))
        | (_morton_spread3(_quant_dir(dy, s)) << 1)
        | (_morton_spread3(_quant_dir(dz, s)) << 2)
    )


def _coherence_keys(osx, osy, osz, dxp, dyp, dzp, live, lo, hi, pos_bits: int,
                    dir_bits: int = 3) -> torch.Tensor:
    """6D key: coarse position morton (major), direction morton (minor);
    dead rays get 1 << 30.  ``lo``/``hi``: the mesh box, recentred."""
    span = torch.clamp_min(hi - lo, 1e-6)
    pscale = float((1 << pos_bits) - 1)

    def qp(o, axis):
        t = torch.clamp((o - lo[axis]) / span[axis], 0.0, 1.0)
        return (t * pscale).to(torch.int32)

    pos_code = (
        _morton_spread3(qp(osx, 0))
        | (_morton_spread3(qp(osy, 1)) << 1)
        | (_morton_spread3(qp(osz, 2)) << 2)
    )
    key = (pos_code << (3 * dir_bits)) | _dir_morton(dxp, dyp, dzp, dir_bits)
    return torch.where(live > 0.0, key, 1 << 30)


def _key_layout(ct: int):
    bits_id = max(1, (ct - 1).bit_length()) if ct > 1 else 1
    n_sig = 3 if 3 * bits_id <= 30 else 2
    dir_total = min(6, 30 - n_sig * bits_id)
    return bits_id, n_sig, dir_total


def _pack_candidates(tlo, hit, tile_id, id_mask):
    """Coarse monotone bits of tlo with the low bits replaced by the tile
    id: one int, min-reducible, unique per tile."""
    b = torch.maximum(tlo, torch.zeros_like(tlo)).view(torch.int32)
    return torch.where(hit, (b & ~id_mask) | tile_id, INT_MAX)


def _finish_signature(tops, bits_id, dir_total, dx, dy, dz):
    id_mask = (1 << bits_id) - 1
    ids = [torch.where(t == INT_MAX, id_mask, t & id_mask) for t in tops]
    sig = ids[0]
    for idk in ids[1:]:
        sig = (sig << bits_id) | idk
    if dir_total >= 3:
        db = dir_total // 3
        sig = (sig << (3 * db)) | _dir_morton(dx, dy, dz, db)
    return sig


def _signature_keys(tile_aabb, osx, osy, osz, dx, dy, dz, live, t_limit):
    """Traversal-signature key: the ids of the ray's nearest candidate
    tiles, front to back, then a direction morton; 1 << 30 for rays that
    are not live.  Built over chunks of 16 tiles as [N, 16] passes."""
    ct = tile_aabb.shape[0]
    bits_id, n_sig, dir_total = _key_layout(ct)
    id_mask = (1 << bits_id) - 1
    inv = _inv_dir(Vec3(dx, dy, dz))
    livem = live > 0.0
    os = Vec3(osx[:, None], osy[:, None], osz[:, None])
    inv2 = Vec3(inv.x[:, None], inv.y[:, None], inv.z[:, None])
    top = torch.full((osx.shape[0], n_sig), INT_MAX, dtype=torch.int32,
                     device=osx.device)
    for c0 in range(0, ct, 16):
        rows = tile_aabb[c0:c0 + 16]
        lo = [rows[None, :, a] for a in range(3)]
        hi = [rows[None, :, 3 + a] for a in range(3)]
        tlo, thi = _slab(lo, hi, os, inv2)
        hit = (thi >= tlo) & (thi > 0.0) & (tlo < t_limit[:, None]) & livem[:, None]
        tid = torch.arange(c0, c0 + rows.shape[0], dtype=torch.int32,
                           device=osx.device)[None, :]
        cand = torch.cat([top, _pack_candidates(tlo, hit, tid, id_mask)], dim=1)
        new_top = []
        for _ in range(n_sig):
            m = torch.min(cand, dim=1, keepdim=True).values
            new_top.append(m[:, 0])
            cand = torch.where(cand == m, INT_MAX, cand)
        top = torch.stack(new_top, dim=1)
    sig = _finish_signature(list(top.unbind(1)), bits_id, dir_total, dx, dy, dz)
    return torch.where(livem, sig, 1 << 30)


def coherence_key_planes(aabb_rows, cx, cy, cz, ox, oy, oz, dx, dy, dz, alive,
                         t_limit) -> torch.Tensor:
    """The coherence key as the fused shade kernel emits it: root mask,
    signature by incremental sorted insertion over the tiles, one tile at a
    time, and the three-level layering (live & root < live & prim-only <
    dead).  ``aabb_rows``: [ct, 8] recentred tile bounds; ``cx/cy/cz``: the
    recentring offset; ``t_limit``: the next bounce's prim prune.  The
    mesh-shade kernel computes the same key per ray (``csrc/mesh_path.cuh``,
    ``coherence_key``)."""
    rows = [[float(v) for v in r] for r in aabb_rows.tolist()]
    ct = len(rows)
    bits_id, n_sig, dir_total = _key_layout(ct)
    id_mask = (1 << bits_id) - 1
    os = Vec3(ox - cx, oy - cy, oz - cz)
    inv = _inv_dir(Vec3(dx, dy, dz))
    r_lo = [min(r[a] for r in rows) for a in range(3)]
    r_hi = [max(r[3 + a] for r in rows) for a in range(3)]
    tlo_r, thi_r = _slab(r_lo, r_hi, os, inv)
    tlo_r, thi_r = _widen_slab(tlo_r, thi_r, k=2)
    livem = alive & (thi_r >= tlo_r) & (thi_r > 0.0) & (tlo_r < t_limit)
    tops = [torch.full(ox.shape, INT_MAX, dtype=torch.int32, device=ox.device)
            for _ in range(n_sig)]
    for c, r in enumerate(rows):
        tlo, thi = _slab(r[0:3], r[3:6], os, inv)
        hit = (thi >= tlo) & (thi > 0.0) & (tlo < t_limit) & livem
        p = _pack_candidates(tlo, hit, c, id_mask)
        for k in range(n_sig):
            lo_k = torch.minimum(tops[k], p)
            p = torch.maximum(tops[k], p)
            tops[k] = lo_k
    sig = _finish_signature(tops, bits_id, dir_total, dx, dy, dz)
    key = torch.where(livem, sig, 1 << 30)
    return torch.where(alive, key, DEAD_KEY)


def coherence_perm(tables: MXUMeshTables, ro: Vec3, rd: Vec3, active, t_limit,
                   sort_bits: int, sort_dir_bits: int, mode: str = "morton"):
    """Stable sort order of the whole bounce state by coherence key
    (live & root < live & prim-only < dead)."""
    root = root_hit_mask(tables.tile_aabb, tables.center, *ro, *rd, t_limit)
    live = (active & root).to(torch.float32)
    c = tables.center
    os = (ro.x - c[0], ro.y - c[1], ro.z - c[2])
    if mode == "signature":
        key = _signature_keys(tables.tile_aabb, *os, *rd, live, t_limit)
    else:
        lo = torch.min(tables.tile_aabb[:, 0:3], dim=0).values
        hi = torch.max(tables.tile_aabb[:, 3:6], dim=0).values
        key = _coherence_keys(*os, *rd, live, lo, hi, sort_bits, sort_dir_bits)
    key = torch.where(active, key, DEAD_KEY)
    return torch.argsort(key, stable=True)


# ---------------------------------------------------------------------------
# The mono traversal  (replaces ops/intersect_mxu.py::_mono_kernel)
# ---------------------------------------------------------------------------

def _mt_hit(det, u_num, v_num, t_num, t_lo, t_hi, baby_eps):
    """Moller-Trumbore acceptance on the numerators -> (hit, t); the JAX
    package's ``_mt_hit`` term for term, including the sign-bit XOR that
    replaces the multiplication by sign(det)."""
    abs_det = torch.abs(det)
    det_ok = abs_det >= f32(baby_eps)
    inv_det = 1.0 / torch.where(det_ok, det, 1.0)
    tt = t_num * inv_det
    sign = det.view(torch.int32) & -(2**31)
    us = (u_num.view(torch.int32) ^ sign).view(torch.float32)
    vs = (v_num.view(torch.int32) ^ sign).view(torch.float32)
    hit = (
        det_ok
        & (torch.minimum(us, vs) >= 0.0)
        & (us + vs <= abs_det)
        & (tt >= t_lo)
        & (tt <= t_hi)
    )
    return hit, tt


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``fma(a, b, c)``, rounded once, from float64 arithmetic.

    The product of two float32 values is exact in float64.  The sum is
    rounded to odd (nearest, then moved one float64 ulp toward the exact
    value if that makes the last bit odd), and a round-to-odd result with
    29 spare bits rounds to the nearest float32 exactly as the exact sum
    would: no double rounding."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)  # exact: s + err == p + cd
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf"))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _numerators(feat, coef):
    """The four numerators of rays x triangles: ``feat`` 10 tensors [R, 1],
    ``coef`` [K, COEF_W].  Each is a chain of fused multiply-adds over its
    features in ascending order from 0, the order in which the JAX
    package's ``jnp.dot`` accumulates on the CPU (and ``fmaf`` in the
    kernel)."""
    out, col = [], 0
    for _, rows in MONO_COEF:
        acc = torch.zeros((), dtype=torch.float32, device=coef.device)
        for f in rows:
            acc = fma32(feat[f], coef[None, :, col], acc)
            col += 1
        out.append(acc)
    return out


def _ray_features(ro: Vec3, rd: Vec3, center):
    """The ray's 10 features in the recentred frame, in ``_run``'s order."""
    osx, osy, osz = ro.x - center[0], ro.y - center[1], ro.z - center[2]
    dx, dy, dz = rd
    return [
        dx, dy, dz,
        osy * dz - osz * dy, osz * dx - osx * dz, osx * dy - osy * dx,
        osx, osy, osz, torch.ones_like(osx),
    ]


def mono_intersect_plain(tables: MXUMeshTables, num_tris: int, ro: Vec3,
                         rd: Vec3, active, t_limit, baby_eps: float):
    """The plain PyTorch version of the mono kernel -> (t, tri).

    Walks the tiles in ascending order, and in each tile only the rays the
    tile is a candidate for, a chunk of rays x 1,024 triangles at a time, so
    memory stays bounded at any ray count."""
    n = ro.x.shape[0]
    device = ro.x.device
    chunk = 1 << 16 if device.type == "cuda" else 1 << 12
    tlim = t_limit.to(torch.float32)
    act = active & root_hit_mask(tables.tile_aabb, tables.center, *ro, *rd, tlim)
    feat_all = _ray_features(ro, rd, tables.center)
    inv_all = _inv_dir(rd)
    os_all = Vec3(*feat_all[6:9])
    eps_succ = float(np.nextafter(np.float32(baby_eps), np.float32(np.inf)))
    best_t = torch.full((n,), float("inf"), dtype=torch.float32, device=device)
    best_tri = torch.full((n,), INT_MAX, dtype=torch.int32, device=device)
    lane = torch.arange(TRI_TILE, dtype=torch.int32, device=device)[None, :]
    for c, row in enumerate(tables.tile_aabb.tolist()):
        member, s_tlo, s_thi = _member_slab(row, os_all, inv_all, tlim)
        ids = torch.nonzero(member & act).flatten()
        coef = tables.coef[c * TRI_TILE:(c + 1) * TRI_TILE]
        for s in range(0, ids.shape[0], chunk):
            i = ids[s:s + chunk]
            feat = [f[i][:, None] for f in feat_all]
            t_lo = torch.maximum(s_tlo[i], torch.full_like(s_tlo[i], eps_succ))[:, None]
            t_hi = s_thi[i][:, None]
            hit, tt = _mt_hit(*_numerators(feat, coef), t_lo, t_hi, baby_eps)
            cand = torch.where(hit, tt, float("inf"))
            tmin = torch.min(cand, dim=1, keepdim=True).values
            jmin = torch.min(torch.where(cand <= tmin, lane, INT_MAX), dim=1).values
            upd = tmin[:, 0] < best_t[i]  # strict: the lower tile keeps a tie
            best_t[i] = torch.where(upd, tmin[:, 0], best_t[i])
            best_tri[i] = torch.where(upd, c * TRI_TILE + jmin, best_tri[i])
    hitrow = best_t < tlim
    t = torch.where(hitrow, best_t, tlim)
    tri = torch.where(hitrow, best_tri, -1)
    return t, torch.where(tri >= num_tris, -1, tri)


def _check_rays(what, planes, n, device):
    for p in planes:
        if p.device != device or p.dtype != torch.float32 or p.shape != (n,) \
                or not p.is_contiguous():
            raise ValueError(
                f"{what}: expected contiguous float32 [{n}] on {device}, got "
                f"{p.dtype} {tuple(p.shape)} on {p.device}"
            )


def mono_intersect(tables: MXUMeshTables, num_tris: int, ro: Vec3, rd: Vec3,
                   active, t_limit, baby_eps: float):
    """Closest ``(t, tri)`` per ray over a mesh of at most ``MONO_MAX_TILES``
    tiles: one launch of ``ptt_mono_kernel`` on CUDA tensors, the plain
    version on CPU tensors.  Inactive and root-culled rays return
    ``(t_limit, -1)``."""
    device = ro.x.device
    if device.type == "cpu":
        return mono_intersect_plain(tables, num_tris, ro, rd, active, t_limit, baby_eps)
    if device.type != "cuda":
        raise ValueError(
            f"mono_intersect: the kernel takes CUDA tensors (the wrapper runs "
            f"its plain version on CPU tensors), got {device}"
        )
    n = ro.x.shape[0]
    ct = tables.tile_aabb.shape[0]
    if ct > MONO_MAX_TILES:
        raise _not_ported(f"the mono traversal of {ct} tiles")
    _check_rays("mono_intersect rays", [*ro, *rd, t_limit], n, device)
    if active.dtype != torch.bool or active.shape != (n,) or active.device != device \
            or not active.is_contiguous():
        raise ValueError(f"mono_intersect active: expected contiguous bool [{n}] on {device}")
    for name, tab, shape in (("coef", tables.coef, (ct * TRI_TILE, COEF_W)),
                             ("tile_aabb", tables.tile_aabb, (ct, 8)),
                             ("center", tables.center, (3,))):
        if tab.device != device or tab.dtype != torch.float32 or tuple(tab.shape) != shape \
                or not tab.is_contiguous():
            raise ValueError(f"mono_intersect {name}: expected contiguous float32 "
                             f"{shape} on {device}")
    lib = kernels.load("fused_mesh")
    out_t = torch.empty((n,), dtype=torch.float32, device=device)
    out_tri = torch.empty((n,), dtype=torch.int32, device=device)
    a = kernels.PttMonoArgs()
    a.ray[:] = [p.data_ptr() for p in (*ro, *rd)]
    a.active = active.data_ptr()
    a.tlim = t_limit.data_ptr()
    a.coef = tables.coef.data_ptr()
    a.tile_aabb = tables.tile_aabb.data_ptr()
    a.center = tables.center.data_ptr()
    a.out_t, a.out_tri = out_t.data_ptr(), out_tri.data_ptr()
    a.baby_eps = f32(baby_eps)
    a.eps_succ = float(np.nextafter(np.float32(baby_eps), np.float32(np.inf)))
    a.n, a.ct, a.num_tris = n, ct, num_tris
    code = lib.lib.ptt_launch_mono(ctypes.byref(a), kernels.stream_handle(device))
    lib.check(code, "mono_intersect")
    mono_intersect.launches += 1
    return out_t, out_tri


mono_intersect.launches = 0


# ---------------------------------------------------------------------------
# Traversal selection and the intersector entry point
# ---------------------------------------------------------------------------

def resolve_traversal_mode(mode: str, padded_tris: int) -> str:
    """"auto" -> mono up to ``MONO_MAX_TILES`` tiles, else what the JAX
    package picks (planned, binned, streamed)."""
    if mode != "auto":
        return mode
    if padded_tris <= MONO_MAX_TILES * TRI_TILE:
        return "mono"
    if padded_tris <= CHUNK_TRIS:
        return "planned"
    if BINNED_AUTO_MIN < padded_tris <= BINNED_AUTO_MAX:
        return "binned"
    return "streamed"


def traversal_flags(mode: str, padded_tris: int) -> dict:
    """``RenderConfig.mxu_traversal`` -> the intersector's flags.  Only the
    mono traversal is ported; the rest raise."""
    mode = resolve_traversal_mode(mode, padded_tris)
    if mode == "mono":
        if padded_tris > MONO_MAX_TILES * TRI_TILE:
            raise _not_ported(f"the mono traversal of {padded_tris} triangles")
        return dict(mono=True)
    if mode in ("sweep", "planned", "streamed", "binned"):
        raise _not_ported(f"mxu_traversal={mode!r} ({padded_tris} padded triangles)")
    raise ValueError(f"unknown mxu_traversal mode: {mode!r}")


def mesh_intersect_mxu(
    tables: MXUMeshTables,
    num_tris: int,
    padded_tris: int,
    ro: Vec3,
    rd: Vec3,
    active: torch.Tensor,
    t_limit: torch.Tensor,
    baby_eps: float,
    sort_rays: bool = False,
    sort_bits: int = 3,
    sort_dir_bits: int = 3,
    mesh_bounds: tuple = (0.0, 0.0, 0.0, 1.0, 1.0, 1.0),
    compute_uv: bool = True,
    sort_mode: str = "morton",
    mono: bool = False,
    plain: bool = False,
) -> MeshHit:
    """Closest hit over the mesh (``mono=True``: the mono traversal, the
    only one ported).  With ``sort_rays`` the rays go through the kernel in
    coherence order and the results are scattered back (a pure
    permutation: identical results).  (u, v) are recomputed from the
    winner's geometry when ``compute_uv``.  ``plain`` runs the traversal's
    plain version on any device."""
    if not mono:
        raise _not_ported("the sweep traversal (mono=False)")
    if padded_tris > MONO_MAX_TILES * TRI_TILE:
        raise _not_ported(f"the mono traversal of {padded_tris} triangles")
    active = active.contiguous()
    t_limit = t_limit.to(torch.float32).contiguous()
    traverse = mono_intersect_plain if plain else mono_intersect
    if sort_rays:
        c = tables.center
        os = (ro.x - c[0], ro.y - c[1], ro.z - c[2])
        root = root_hit_mask(tables.tile_aabb, c, *ro, *rd, t_limit)
        live = (active & root).to(torch.float32)
        if sort_mode == "signature":
            key = _signature_keys(tables.tile_aabb, *os, *rd, live, t_limit)
        else:
            b = torch.tensor(mesh_bounds, dtype=torch.float32, device=c.device)
            key = _coherence_keys(*os, *rd, live, b[:3] - c, b[3:] - c,
                                  sort_bits, sort_dir_bits)
        perm = torch.argsort(key, stable=True)
        sro, srd = Vec3(*(p[perm] for p in ro)), Vec3(*(p[perm] for p in rd))
        t_s, tri_s = traverse(tables, num_tris, sro, srd, active[perm],
                              t_limit[perm], baby_eps)
        t, tri = torch.empty_like(t_s), torch.empty_like(tri_s)
        t[perm], tri[perm] = t_s, tri_s
    else:
        ro = Vec3(*(p.contiguous() for p in ro))
        rd = Vec3(*(p.contiguous() for p in rd))
        t, tri = traverse(tables, num_tris, ro, rd, active, t_limit, baby_eps)
    if compute_uv:
        u, v = winner_uv(tables, padded_tris, tri, ro, rd, baby_eps)
    else:
        u = v = torch.zeros_like(t)
    return MeshHit(t=t, tri=tri, u=u, v=v)


# ---------------------------------------------------------------------------
# Winner attributes
# ---------------------------------------------------------------------------

def winner_uv(tables, padded_tris, tri, ro, rd, baby_eps, attr_rows=None):
    """Per-ray (u, v) of the winning triangle (one row gather unless the
    caller passes the resolved rows)."""
    if attr_rows is None:
        attr_rows = resolve_attributes(tables, padded_tris, tri)
    return winner_uv_from_geom(
        attr_rows[:, 24:27], attr_rows[:, 27:30], attr_rows[:, 30:33],
        tri, ro, rd, baby_eps,
    )


def winner_uv_from_geom(v0, e1, e2, tri, ro, rd, baby_eps):
    """(u, v) of the winning triangle from its (v0, e1, e2) rows [N, 3]:
    the elementwise Moller-Trumbore of the JAX package."""
    from ..utils import vec

    cols = lambda a: Vec3(a[:, 0], a[:, 1], a[:, 2])
    v0, e1, e2 = cols(v0), cols(e1), cols(e2)
    pvec = vec.cross(rd, e2)
    det = vec.dot(e1, pvec)
    det_ok = torch.abs(det) >= f32(baby_eps)
    inv_det = 1.0 / torch.where(det_ok, det, 1.0)
    tvec = ro - v0
    u = vec.dot(tvec, pvec) * inv_det
    qvec = vec.cross(tvec, e1)
    v = vec.dot(rd, qvec) * inv_det
    miss = tri < 0
    return torch.where(miss, 0.0, u), torch.where(miss, 0.0, v)


def resolve_attributes(tables: MXUMeshTables, padded_tris: int, tri):
    """Per-ray triangle attribute rows [N, 40] (zero rows for tri == -1), by
    a row gather (the JAX package's one-hot matmul mode gives the same
    values)."""
    safe = torch.clamp(tri, 0, padded_tris - 1).long()
    return torch.where((tri >= 0)[:, None], tables.attrs[safe], 0.0)


def resolve_shade_attributes(tables: MXUMeshTables, padded_tris: int, tri):
    """Slim rows [N, 24] for the untextured fused path: n0 n1 n2 (0:9),
    mat (9), v0 e1 e2 (10:19)."""
    safe = torch.clamp(tri, 0, padded_tris - 1).long()
    return torch.where((tri >= 0)[:, None], tables.attrs_shade[safe], 0.0)
