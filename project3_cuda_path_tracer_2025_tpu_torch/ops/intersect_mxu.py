"""Mesh closest hit over tiles of 1,024 triangles: the host side of the
JAX package's MXU intersector, and its traversals as CUDA kernels.

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

This module keeps the tables, culls, sort keys, the tile plan, the packet
bins and the attribute resolves as torch code, and ports every traversal of
the JAX package as a CUDA kernel, each behind a wrapper that launches it on
CUDA tensors and runs its plain version on CPU tensors:

* up to ``MONO_MAX_TILES`` tiles, ``_mono_kernel``: ``mono_intersect``
  (``csrc/mesh_walk.cu``), plain ``mono_intersect_plain``;
* up to 32 tiles a call, the planned walks ``_planned_kernel_lanebest`` and
  ``_planned_kernel``: ``planned_lanebest_intersect``, ``planned_intersect``;
* up to 1,024 tiles, ``_streamed_kernel``: ``streamed_intersect``, and with
  ``PTT_STREAM_SUPER`` its super-tile form ``_streamed_super_kernel``:
  ``streamed_super_intersect``, plain ``streamed_super_plain``
  (the walks share the plain version ``walk_plain``; kernels in
  ``csrc/mesh_walk.cu``);
* in the binned band, ``_binned_kernel``: ``binned_intersect``, plain
  ``binned_intersect_plain``;
* up to 32 tiles a call, the sweep ``_intersect_kernel`` (every flag off:
  each tile in ascending order, no plan): ``sweep_intersect``, plain
  ``sweep_intersect_plain``;
* the plan's per-(ray block, tile) slab stage ``_plan_prepass_kernel``
  (``plan_impl="pallas"`` / ``PTT_PLAN_IMPL=pallas``, the JAX package's
  switch): ``plan_prepass``, plain ``plan_prepass_plain``;
* the two kernel variants of the JAX package's ``scripts/profile_epilogue.py``
  (its op-level A/B of the walk's epilogue), which take tiles in ascending
  id and so fold with a strict "<": ``lb_asc_kernel`` as ``lb_asc_intersect``
  (plain ``lb_asc_plain``) over ``ascending_plan``, and ``mono_kernel`` as
  ``epilogue_mono_intersect`` (plain ``epilogue_mono_plain``; flavors
  "full" and "gate").  Their "mm" flavors are timing floors with wrong
  results by design.  No traversal of ``_traverse`` takes them: the
  measuring script ``scripts/torch_profile_epilogue.py`` does.

A mesh of more tiles than one call of the planned walk or the sweep holds
(``chunk_tris``) runs as the JAX package's chunked chain, ``_chain``: a call
per chunk of tiles, the running closest hit handed to the next chunk as its
t_limit.  Beyond the streamed plan's 1,024 tiles, "streamed" and "binned"
fall back to that chain.

Every traversal evaluates each candidate pair with the same float32
operations in the same order (each numerator is a chain of fused
multiply-adds in the fixed order of ``MONO_COEF``, never a matmul;
``fma32`` gives the plain versions the kernels' single rounding), so kernel
and plain version agree bit for bit, and with the JAX package's
``jnp.dot`` on the CPU, which accumulates in the same order.  Of the JAX
package's ``PTT_*`` environment variables the port reads
``PTT_PLANNED_EPILOGUE``, which chooses between the two planned kernels,
``PTT_STREAM_SUPER`` ("0", the default: off; "1": on; anything else: on
beyond ``STREAM_SUPER_MIN`` triangles; read when tables are built and when
a traversal runs) and ``PTT_PLAN_IMPL`` ("pallas" selects the plan prepass
kernel), each as it does there; the constants below are the JAX package's
defaults.

Where the JAX package branches on a device value with ``lax.cond`` (the
plan's live-prefix tiers, the binned tiers and its overflow fallback), the
port reads the value to the host and takes the same branch: one small copy
per bounce (two for an engaged binned tier; none for the sweep, which has
no plan; still one for a planned chain, whose chunks share it), so the
kernels launched are the ones the JAX package would run.
"""

from __future__ import annotations

import ctypes
from os import environ
from typing import NamedTuple

import numpy as np
import torch

from ..utils.timers import host_read, span
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
PLANNED_MAX_TILES = CHUNK_TRIS // TRI_TILE  # the planned walks' table
LANEBEST_MAX_TILES = 24  # the lane-best planned epilogue's band
STREAMED_MAX_TILES = 8 * 128  # the streamed plan's capacity (~1M triangles)
PLAN_BUDGET = 700_000  # the planned walk's plan-size guard (blocks x tiles x 8)
BINNED_AUTO_MIN = 128 * 1024
BINNED_AUTO_MAX = 320 * 1024
BINNED_G = 8  # rays per packet
BINNED_PAIR_MEAN = 14  # pair budget per packet
BINNED_PREFIX_TIERS = (8, 4)  # live-prefix tiers when the caller names none
BINNED_TOPK = 128  # per-packet slot list length
SUPER_TILES = 8  # tiles per super-tile of the super streamed walk
STREAM_SUPER_MIN = 320 * 1024  # PTT_STREAM_SUPER's "auto" band starts beyond this

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


def stream_super_enabled(padded_tris: int) -> bool:
    """``PTT_STREAM_SUPER``, read at call time: "0" (default) off, "1" on,
    anything else on beyond ``STREAM_SUPER_MIN`` triangles."""
    mode = environ.get("PTT_STREAM_SUPER", "0")
    if mode == "0":
        return False
    if mode == "1":
        return True
    return padded_tris > STREAM_SUPER_MIN


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
    the traversal kernels read.  The JAX package's ``group_aabb`` is the
    coarse level of its sweep's two-level cull; with ``GROUP_TILES == 1`` a
    group is a tile and the sweep skips that level, so the port's sweep has
    the single level and the tables carry no ``group_aabb``."""

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
    float32 tables).  With the super-tile walk switched on
    (``stream_super_enabled``) a table beyond ``CHUNK_TRIS`` is padded to a
    whole number of super-tiles with never-hit tiles, as there, so every
    plan and bin shape equals the JAX package's."""
    t = pos.shape[0]
    tp = ((t + GROUP_TRIS - 1) // GROUP_TRIS) * GROUP_TRIS
    if tp > CHUNK_TRIS and stream_super_enabled(tp):
        span = SUPER_TILES * TRI_TILE
        tp = ((tp + span - 1) // span) * span
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


def tables_from_arrays(features, tile_aabb, attrs=None, attrs_shade=None, center=(0, 0, 0),
                       device="cpu") -> MXUMeshTables:
    """``MXUMeshTables`` from numpy arrays (copied), adding ``coef``.  Any
    whole number of tiles is taken (a table the JAX package padded to whole
    super-tiles, or a synthetic one); ``attrs``/``attrs_shade`` None gives
    zero rows, for tables that only a traversal reads."""
    f = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    features = f(features)
    tp = features.shape[1] // 4
    if attrs is None:
        attrs = np.zeros((tp, 40), np.float32)
    if attrs_shade is None:
        attrs_shade = np.zeros((tp, 24), np.float32)
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
    mesh-shade and prelude kernels compute the same key per ray at any
    number of tiles (``csrc/mesh_path.cuh``, ``coherence_key``)."""
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


def sort_key(tables: MXUMeshTables, ro: Vec3, rd: Vec3, active, t_limit,
             sort_bits: int, sort_dir_bits: int, mode: str = "morton",
             mesh_bounds=None) -> torch.Tensor:
    """The coherence key built in torch (live & root < live & prim-only <
    dead), in the span ``mesh.key_glue``: in a trace, one span for each
    bounce whose key the kernels did not give.  In mode "signature" it is
    the key the mesh-shade and prelude kernels emit
    (``coherence_key_planes``) bit for bit; mode "morton" quantises the
    origins within ``mesh_bounds`` (the mesh's [6] world bounds), or
    without them within the tile boxes' envelope."""
    with span("mesh.key_glue"):
        c = tables.center
        root = root_hit_mask(tables.tile_aabb, c, *ro, *rd, t_limit)
        live = (active & root).to(torch.float32)
        os = (ro.x - c[0], ro.y - c[1], ro.z - c[2])
        if mode == "signature":
            key = _signature_keys(tables.tile_aabb, *os, *rd, live, t_limit)
        else:
            if mesh_bounds is None:
                lo = torch.min(tables.tile_aabb[:, 0:3], dim=0).values
                hi = torch.max(tables.tile_aabb[:, 3:6], dim=0).values
            else:
                b = torch.tensor(mesh_bounds, dtype=torch.float32, device=c.device)
                lo, hi = b[:3] - c, b[3:] - c
            key = _coherence_keys(*os, *rd, live, lo, hi, sort_bits, sort_dir_bits)
        return torch.where(active, key, DEAD_KEY)


def coherence_perm(tables: MXUMeshTables, ro: Vec3, rd: Vec3, active, t_limit,
                   sort_bits: int, sort_dir_bits: int, mode: str = "morton"):
    """Stable sort order of the whole bounce state by coherence key
    (``sort_key``)."""
    key = sort_key(tables, ro, rd, active, t_limit, sort_bits, sort_dir_bits, mode)
    return torch.argsort(key, stable=True)


# ---------------------------------------------------------------------------
# The per-pair evaluation shared by the plain versions, and the mono
# traversal  (replaces ops/intersect_mxu.py::_mono_kernel)
# ---------------------------------------------------------------------------

def _mt_hit(det, u_num, v_num, t_num, t_lo, t_hi, baby_eps):
    """Moller-Trumbore acceptance on the numerators -> (hit, t); the JAX
    package's ``_mt_hit`` term for term, including the sign-bit XOR that
    replaces the multiplication by sign(det).  The JAX package's walks and
    binned kernel use ``_mt_hit_legacy``, value-identical to it (the proof
    is in ``_mt_hit``'s docstring there), so the port keeps one form."""
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


def _tile_min(coef_tile, feat, s_tlo, s_thi, eps_succ, baby_eps, lane):
    """One tile of 1,024 triangles against rays [R]: the ray's row minimum
    of accepted t (inf for none) and the lowest lane at it.  ``feat``: the
    10 feature tensors [R, 1]; ``s_tlo``/``s_thi``: the k=1 member slab."""
    t_lo = torch.maximum(s_tlo, torch.full_like(s_tlo, eps_succ))[:, None]
    hit, tt = _mt_hit(*_numerators(feat, coef_tile), t_lo, s_thi[:, None], baby_eps)
    cand = torch.where(hit, tt, float("inf"))
    tmin = torch.min(cand, dim=1, keepdim=True).values
    jmin = torch.min(torch.where(cand <= tmin, lane, INT_MAX), dim=1).values
    return tmin[:, 0], jmin


def _eps_succ(baby_eps: float) -> float:
    return float(np.nextafter(np.float32(baby_eps), np.float32(np.inf)))


def _chunk(device) -> int:
    """Rays per [R, 1,024] evaluation in the plain versions (bounds memory)."""
    return 1 << 16 if device.type == "cuda" else 1 << 12


class _RayFeatures(NamedTuple):
    feat: list  # the 10 features [n]
    os: Vec3  # recentred origins
    inv: Vec3  # reciprocal directions


def _features(tables: MXUMeshTables, ro: Vec3, rd: Vec3) -> _RayFeatures:
    feat = _ray_features(ro, rd, tables.center)
    return _RayFeatures(feat, Vec3(*feat[6:9]), _inv_dir(rd))


def _eval_tile(tables, c, feat, i, s_tlo, s_thi, baby_eps):
    """Rays ``i`` (members of tile ``c``) against the tile, a chunk at a
    time: (row min t, the global id at it).  ``feat`` (the 10 feature
    tensors), ``s_tlo`` and ``s_thi`` are indexed by ``i``."""
    coef = tables.coef[c * TRI_TILE:(c + 1) * TRI_TILE]
    lane = torch.arange(TRI_TILE, dtype=torch.int32, device=coef.device)[None, :]
    out_t = [torch.empty((0,), dtype=torch.float32, device=coef.device)]
    out_j = [torch.empty((0,), dtype=torch.int32, device=coef.device)]
    step = _chunk(coef.device)
    for s in range(0, i.shape[0], step):
        k = i[s:s + step]
        tmin, jmin = _tile_min(coef, [f[k][:, None] for f in feat], s_tlo[k], s_thi[k],
                               _eps_succ(baby_eps), baby_eps, lane)
        out_t.append(tmin)
        out_j.append(jmin)
    return torch.cat(out_t), c * TRI_TILE + torch.cat(out_j)


def mono_intersect_plain(tables: MXUMeshTables, num_tris: int, ro: Vec3,
                         rd: Vec3, active, t_limit, baby_eps: float):
    """The plain PyTorch version of the mono kernel -> (t, tri).

    Walks the tiles in ascending order, and in each tile only the rays the
    tile is a candidate for, a chunk of rays x 1,024 triangles at a time, so
    memory stays bounded at any ray count."""
    n = ro.x.shape[0]
    device = ro.x.device
    tlim = t_limit.to(torch.float32)
    act = active & root_hit_mask(tables.tile_aabb, tables.center, *ro, *rd, tlim)
    rf = _features(tables, ro, rd)
    best_t = torch.full((n,), float("inf"), dtype=torch.float32, device=device)
    best_tri = torch.full((n,), INT_MAX, dtype=torch.int32, device=device)
    for c, row in enumerate(tables.tile_aabb.tolist()):
        member, s_tlo, s_thi = _member_slab(row, rf.os, rf.inv, tlim)
        i = torch.nonzero(member & act).flatten()
        tmin, gid = _eval_tile(tables, c, rf.feat, i, s_tlo, s_thi, baby_eps)
        upd = tmin < best_t[i]  # strict: the lower tile keeps a tie
        best_t[i] = torch.where(upd, tmin, best_t[i])
        best_tri[i] = torch.where(upd, gid, best_tri[i])
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


def _check_tensor(what, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{what}: expected contiguous {dtype} {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )


def _require_cuda(what: str, device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(
            f"{what}: the kernel takes CUDA tensors (the wrapper runs its plain "
            f"version on CPU tensors), got {device}"
        )


def _check_tables(what, tables, ct, device):
    for name, tab, shape in (("coef", tables.coef, (ct * TRI_TILE, COEF_W)),
                             ("tile_aabb", tables.tile_aabb, (ct, 8)),
                             ("center", tables.center, (3,))):
        _check_tensor(f"{what} {name}", tab, torch.float32, shape, device)


def mono_intersect(tables: MXUMeshTables, num_tris: int, ro: Vec3, rd: Vec3,
                   active, t_limit, baby_eps: float):
    """Closest ``(t, tri)`` per ray over a mesh of at most ``MONO_MAX_TILES``
    tiles: one launch of ``ptt_mono_kernel`` on CUDA tensors, the plain
    version on CPU tensors.  Inactive and root-culled rays return
    ``(t_limit, -1)``."""
    device = ro.x.device
    if device.type == "cpu":
        return mono_intersect_plain(tables, num_tris, ro, rd, active, t_limit, baby_eps)
    _require_cuda("mono_intersect", device)
    n = ro.x.shape[0]
    ct = tables.tile_aabb.shape[0]
    if ct > MONO_MAX_TILES:
        raise ValueError(f"mono_intersect: {ct} tiles exceed the mono band of "
                         f"{MONO_MAX_TILES}")
    _check_rays("mono_intersect rays", [*ro, *rd, t_limit], n, device)
    _check_tensor("mono_intersect active", active, torch.bool, (n,), device)
    _check_tables("mono_intersect", tables, ct, device)
    lib = kernels.load("mesh_walk")
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
    a.eps_succ = _eps_succ(baby_eps)
    a.n, a.ct, a.num_tris = n, ct, num_tris
    code = lib.lib.ptt_launch_mono(ctypes.byref(a), kernels.stream_handle(device))
    lib.check(code, "mono_intersect")
    mono_intersect.launches += 1
    return out_t, out_tri


mono_intersect.launches = 0


# ---------------------------------------------------------------------------
# The tile plan  (the XLA prepass of run_chunk_planned / run_streamed:
# _build_tile_plan and _plan_with_prefix)
# ---------------------------------------------------------------------------

class TilePlan(NamedTuple):
    """Each 256-ray block's candidate tiles front to back: ``ids`` [NB*Ct]
    int32, ``tlo`` [NB*Ct] float32 block entry bounds, ascending (inf past
    the candidates), ``cnt`` [NB] int32 the number of candidates."""

    ids: torch.Tensor
    tlo: torch.Tensor
    cnt: torch.Tensor


def _pair_slabs(tile_aabb, os: Vec3, d: Vec3, live, tl):
    """The k=2 widened (ray, tile) slab test, 16 tiles at a time so the
    [n, 16] intermediates stay small: yields (hit [n, tc], tlo [n, tc])."""
    inv = _inv_dir(d)
    os2 = Vec3(os.x[:, None], os.y[:, None], os.z[:, None])
    inv2 = Vec3(inv.x[:, None], inv.y[:, None], inv.z[:, None])
    for c0 in range(0, tile_aabb.shape[0], 16):
        rows = tile_aabb[c0:c0 + 16]
        tlo, thi = _slab([rows[None, :, a] for a in range(3)],
                         [rows[None, :, 3 + a] for a in range(3)], os2, inv2)
        tlo, thi = _widen_slab(tlo, thi, k=2)
        yield (thi >= tlo) & (thi > 0.0) & (tlo < tl[:, None]) & live[:, None], tlo


def _block_slabs(tile_aabb, os: Vec3, d: Vec3, live, tl):
    """For every (256-ray block, tile) pair: whether any live ray of the
    block enters the tile's k=2 widened box before its t_limit (``h`` [NB,
    Ct] bool), and the block's least entry distance clamped at 0 (``lb``
    [NB, Ct] float32, inf without such a ray)."""
    nb = os.x.shape[0] // RAY_TILE
    hs, ls = [], []
    zero = torch.zeros((), dtype=torch.float32, device=tl.device)
    for h, tlo in _pair_slabs(tile_aabb, os, d, live, tl):
        tc = h.shape[1]
        hs.append(h.reshape(nb, RAY_TILE, tc).any(dim=1))
        per_ray = torch.where(h, torch.maximum(tlo, zero), float("inf"))
        ls.append(per_ray.reshape(nb, RAY_TILE, tc).amin(dim=1))
    return torch.cat(hs, dim=1), torch.cat(ls, dim=1)


def _plan_from_slabs(hit, lb) -> TilePlan:
    """Each block's tiles sorted by entry distance (stable), misses last."""
    key = torch.where(hit, lb, float("inf"))
    order = torch.argsort(key, dim=1, stable=True)
    tlo_sorted = torch.gather(key, 1, order)
    cnt = hit.sum(dim=1).to(torch.int32)
    return TilePlan(order.to(torch.int32).reshape(-1), tlo_sorted.reshape(-1), cnt)


def build_tile_plan(tile_aabb, os: Vec3, d: Vec3, live, tl) -> TilePlan:
    """The JAX package's ``_build_tile_plan``: for every (256-ray block,
    tile) pair, whether any live ray of the block enters the tile's k=2
    widened box before its t_limit, and the block's least entry distance
    (clamped at 0); tiles sorted by it (stable).  Rays padded to whole
    blocks: ``os`` recentred origins, ``d`` directions, ``live``, ``tl``."""
    return _plan_from_slabs(*_block_slabs(tile_aabb, os, d, live, tl))


# The plan prepass  (replaces ops/intersect_mxu.py::_plan_prepass_kernel)

def plan_prepass_plain(tile_aabb, os: Vec3, d: Vec3, live, tl):
    """The plain PyTorch version of the plan prepass kernel -> (h [NB, Ct]
    bool, lb [NB, Ct] float32): the slab stage of ``build_tile_plan``."""
    return _block_slabs(tile_aabb, os, d, live, tl)


def plan_prepass(tile_aabb, os: Vec3, d: Vec3, live, tl):
    """The per-(ray block, tile) slab stage of the plan
    (``_plan_prepass_kernel``): ``ptt_plan_prepass_kernel`` on CUDA tensors,
    ``plan_prepass_plain`` on CPU tensors.  Rays padded to whole blocks
    (``plan_rays``); returns (h [NB, Ct] bool, lb [NB, Ct] float32), bit-equal
    to the plain version: min and any do not depend on the order of the rays.
    The kernel tests only the live rays of a block, and a CTA takes 64
    tiles of its block's row (``PTT_PREPASS_SPLIT``), so that the few live
    blocks of a sorted bounce spread over more SMs."""
    device = tl.device
    if device.type == "cpu":
        return plan_prepass_plain(tile_aabb, os, d, live, tl)
    _require_cuda("plan_prepass", device)
    n_pad = tl.shape[0]
    if n_pad % RAY_TILE:
        raise ValueError(f"plan_prepass: {n_pad} rays are not whole blocks of {RAY_TILE}")
    nb, ct = n_pad // RAY_TILE, tile_aabb.shape[0]
    os, d = Vec3(*(x.contiguous() for x in os)), Vec3(*(x.contiguous() for x in d))
    live, tl = live.contiguous(), tl.contiguous()
    _check_rays("plan_prepass rays", [*os, *d, tl], n_pad, device)
    _check_tensor("plan_prepass live", live, torch.bool, (n_pad,), device)
    _check_tensor("plan_prepass tile_aabb", tile_aabb, torch.float32, (ct, 8), device)
    lib = kernels.load("mesh_walk")
    h = torch.empty((nb, ct), dtype=torch.bool, device=device)
    lb = torch.empty((nb, ct), dtype=torch.float32, device=device)
    a = kernels.PttPlanArgs()
    a.ray[:] = [x.data_ptr() for x in (*os, *d)]
    a.live, a.tlim = live.data_ptr(), tl.data_ptr()
    a.tile_aabb = tile_aabb.data_ptr()
    a.out_h, a.out_lb = h.data_ptr(), lb.data_ptr()
    a.nb, a.ct = nb, ct
    code = lib.lib.ptt_launch_plan_prepass(ctypes.byref(a), kernels.stream_handle(device))
    lib.check(code, "plan_prepass")
    plan_prepass.launches += 1
    return h, lb


plan_prepass.launches = 0


def build_tile_plan_prepass(tile_aabb, os: Vec3, d: Vec3, live, tl, plain=False) -> TilePlan:
    """``build_tile_plan`` with its slab stage as the prepass kernel (the JAX
    package's ``_build_tile_plan_pallas``): the same plan, bit for bit."""
    fn = plan_prepass_plain if plain else plan_prepass
    return _plan_from_slabs(*fn(tile_aabb, os, d, live, tl))


class PlanRays(NamedTuple):
    """The rays as the plan and the bins read them, padded to whole 256-ray
    blocks with dead rays: recentred origins, directions, live mask and
    t_limits (3.4e38 in the padding, as the JAX package pads)."""

    os: Vec3
    d: Vec3
    live: torch.Tensor
    tl: torch.Tensor


def plan_rays(tables: MXUMeshTables, ro: Vec3, rd: Vec3, live, tlim) -> PlanRays:
    n = ro.x.shape[0]
    n_pad = (n + RAY_TILE - 1) // RAY_TILE * RAY_TILE
    pad = lambda x, fill: torch.cat([x, x.new_full((n_pad - n,), fill)])
    c = tables.center
    return PlanRays(Vec3(*(pad(o - c[a], 0.0) for a, o in enumerate(ro))),
                    Vec3(*(pad(x, 0.0) for x in rd)), pad(live, False),
                    pad(tlim, f32(3.4e38)))


def live_position(live) -> int:
    """The index of the last live ray, -1 for none (one host read)."""
    idx = torch.arange(live.shape[0], dtype=torch.int32, device=live.device)
    return int(torch.max(torch.where(live, idx, -1)))


def plan_with_prefix(tile_aabb, os: Vec3, d: Vec3, live, tl, live_pos=None, impl="xla",
                     plain=False) -> TilePlan:
    """The JAX package's ``_plan_with_prefix``: with at least 8 blocks, the
    plan is built over the 1/16 or the 1/4 prefix of the rays when the last
    live ray (``live_pos``) lies inside it, and the blocks past it get empty
    plans (exact: their rays are dead).  ``impl`` "pallas" (the JAX
    package's name for it) builds the slab stage with the prepass kernel
    (its plain version with ``plain``), any other value in torch."""
    n_pad = os.x.shape[0]
    nb = n_pad // RAY_TILE
    if impl == "pallas":
        build = lambda *rays: build_tile_plan_prepass(tile_aabb, *rays, plain=plain)
    else:
        build = lambda *rays: build_tile_plan(tile_aabb, *rays)
    if nb < 8:
        return build(os, d, live, tl)
    if live_pos is None:
        live_pos = live_position(live)
    p4, p16 = (nb // 4) * RAY_TILE, (nb // 16) * RAY_TILE
    npre = n_pad
    if 0 < p16 < p4 and live_pos < p16:
        npre = p16
    elif 0 < p4 < n_pad and live_pos < p4:
        npre = p4
    if npre == n_pad:
        return build(os, d, live, tl)
    cut = lambda v: Vec3(*(x[:npre] for x in v))
    p = build(cut(os), cut(d), live[:npre], tl[:npre])
    ct, rest = tile_aabb.shape[0], nb - npre // RAY_TILE
    return TilePlan(
        torch.cat([p.ids, p.ids.new_zeros(rest * ct)]),
        torch.cat([p.tlo, p.tlo.new_full((rest * ct,), float("inf"))]),
        torch.cat([p.cnt, p.cnt.new_zeros(rest)]),
    )


# ---------------------------------------------------------------------------
# The planned and streamed walks  (replace ops/intersect_mxu.py::
# _planned_kernel_lanebest, _planned_kernel, _streamed_kernel and
# _streamed_super_kernel)
# ---------------------------------------------------------------------------

def _plan_visits(plan: TilePlan, ct: int):
    """[NB, ct] bool: the tiles each block's plan row lists."""
    nb = plan.cnt.shape[0]
    device = plan.cnt.device
    ids = plan.ids.reshape(nb, ct).long()
    slots = torch.arange(ct, device=device)[None, :] < plan.cnt[:, None]
    return torch.zeros((nb, ct), dtype=torch.bool, device=device).scatter_(1, ids, slots)


def _visit_plain(tables: MXUMeshTables, ro: Vec3, rd: Vec3, live, tlim, visits,
                 baby_eps: float, strict: bool = False):
    """Every live ray against the tiles its block visits (``visits`` [NB,
    Ct]) that it is a member of, tile by tile, each pair once, folded in
    with the contract's rule (a smaller t wins, an equal t goes to the lower
    id) -> (t, tri), ``(tlim, -1)`` where nothing closer is hit.  ``strict``
    folds with "<" alone, which in this ascending tile order is the same
    rule (a later tile holds only higher ids)."""
    n = ro.x.shape[0]
    device = ro.x.device
    block = torch.arange(n, device=device) // RAY_TILE
    rf = _features(tables, ro, rd)
    best_t, best_tri = tlim.clone(), torch.full((n,), -1, dtype=torch.int32, device=device)
    for c, row in enumerate(tables.tile_aabb.tolist()):
        member, s_tlo, s_thi = _member_slab(row, rf.os, rf.inv, tlim)
        i = torch.nonzero(member & live & visits[block, c]).flatten()
        tmin, gid = _eval_tile(tables, c, rf.feat, i, s_tlo, s_thi, baby_eps)
        bt, btri = best_t[i], best_tri[i]
        upd = tmin < bt
        if not strict:
            upd = upd | ((tmin == bt) & (tmin < float("inf")) & (gid < btri))
        best_t[i] = torch.where(upd, tmin, bt)
        best_tri[i] = torch.where(upd, gid, btri)
    return best_t, best_tri


def walk_plain(tables: MXUMeshTables, ro: Vec3, rd: Vec3, live, tlim, plan: TilePlan,
               baby_eps: float):
    """The plain PyTorch version of the three walk kernels -> (t, tri),
    ``(tlim, -1)`` where nothing closer is hit.

    The kernels walk each block's plan row in order, the JAX package's
    running best per ray with the contract's rule (a smaller t wins, an
    equal t goes to the lower id), and #6/#7 stop early where nothing can
    change.  This version visits the same (ray, tile) pairs tile by tile,
    each once, and folds them in with the same rule, which makes the order
    of visits irrelevant; the early exits skip only pairs that change
    nothing, so the result is the same function."""
    visits = _plan_visits(plan, tables.tile_aabb.shape[0])
    return _visit_plain(tables, ro, rd, live, tlim, visits, baby_eps)


def _launch_walk(kind: str, tables, ro, rd, live, tlim, plan, baby_eps, saabb=None):
    """One launch of a walk kernel.  ``plan``: over the tiles, or over the
    super-tiles ``saabb`` [Cs, 8] for "streamed_super"; None for "sweep"."""
    device = ro.x.device
    _require_cuda(f"{kind}_intersect", device)
    n = ro.x.shape[0]
    nb = (n + RAY_TILE - 1) // RAY_TILE
    ct = tables.tile_aabb.shape[0]
    cap = STREAMED_MAX_TILES if kind.startswith("streamed") else PLANNED_MAX_TILES
    cs = 0 if saabb is None else saabb.shape[0]
    if (cs or ct) > cap:
        raise ValueError(f"{kind}_intersect: {cs or ct} plan columns exceed the kernel's {cap}")
    what = f"{kind}_intersect"
    _check_rays(f"{what} rays", [*ro, *rd, tlim], n, device)
    _check_tensor(f"{what} live", live, torch.bool, (n,), device)
    _check_tables(what, tables, ct, device)
    if saabb is not None:
        if cs != (ct + SUPER_TILES - 1) // SUPER_TILES:
            raise ValueError(f"{what}: {cs} super-tiles for {ct} tiles")
        _check_tensor(f"{what} saabb", saabb, torch.float32, (cs, 8), device)
    if plan is None:
        plan = TilePlan(*(torch.empty((0,), dtype=dt, device=device)
                          for dt in (torch.int32, torch.float32, torch.int32)))
    else:
        cols = cs or ct
        _check_tensor(f"{what} plan ids", plan.ids, torch.int32, (nb * cols,), device)
        _check_tensor(f"{what} plan tlo", plan.tlo, torch.float32, (nb * cols,), device)
        _check_tensor(f"{what} plan cnt", plan.cnt, torch.int32, (nb,), device)
    lib = kernels.load("mesh_walk")
    out_t = torch.empty((n,), dtype=torch.float32, device=device)
    out_tri = torch.empty((n,), dtype=torch.int32, device=device)
    a = kernels.PttWalkArgs()
    a.ray[:] = [p.data_ptr() for p in (*ro, *rd)]
    a.live, a.tlim = live.data_ptr(), tlim.data_ptr()
    a.coef = tables.coef.data_ptr()
    a.tile_aabb = tables.tile_aabb.data_ptr()
    a.center = tables.center.data_ptr()
    a.ids, a.tlo, a.cnt = plan.ids.data_ptr(), plan.tlo.data_ptr(), plan.cnt.data_ptr()
    a.saabb = saabb.data_ptr() if saabb is not None else None
    a.out_t, a.out_tri = out_t.data_ptr(), out_tri.data_ptr()
    a.baby_eps, a.eps_succ = f32(baby_eps), _eps_succ(baby_eps)
    a.n, a.ct, a.cs = n, ct, cs
    code = lib.lib.ptt_launch_walk(ctypes.byref(a), kernels.WALK_KINDS.index(kind),
                                   kernels.stream_handle(device))
    lib.check(code, what)
    return out_t, out_tri


def planned_lanebest_intersect(tables, ro, rd, live, tlim, plan, baby_eps):
    """The planned walk without early exit (``_planned_kernel_lanebest``, up
    to ``LANEBEST_MAX_TILES`` tiles): ``ptt_planned_lanebest_kernel`` on
    CUDA tensors, ``walk_plain`` on CPU tensors.  Rays unpadded [n], the
    plan over ceil(n / 256) blocks; returns (t, tri)."""
    if ro.x.device.type == "cpu":
        return walk_plain(tables, ro, rd, live, tlim, plan, baby_eps)
    out = _launch_walk("planned_lanebest", tables, ro, rd, live, tlim, plan, baby_eps)
    planned_lanebest_intersect.launches += 1
    return out


def planned_intersect(tables, ro, rd, live, tlim, plan, baby_eps):
    """The planned walk with the early exit (``_planned_kernel``, up to
    ``PLANNED_MAX_TILES`` tiles): ``ptt_planned_kernel`` on CUDA tensors,
    ``walk_plain`` on CPU tensors."""
    if ro.x.device.type == "cpu":
        return walk_plain(tables, ro, rd, live, tlim, plan, baby_eps)
    out = _launch_walk("planned", tables, ro, rd, live, tlim, plan, baby_eps)
    planned_intersect.launches += 1
    return out


def streamed_intersect(tables, ro, rd, live, tlim, plan, baby_eps):
    """The walk of a global plan over up to ``STREAMED_MAX_TILES`` tiles
    (``_streamed_kernel``): ``ptt_streamed_kernel`` on CUDA tensors,
    ``walk_plain`` on CPU tensors."""
    if ro.x.device.type == "cpu":
        return walk_plain(tables, ro, rd, live, tlim, plan, baby_eps)
    out = _launch_walk("streamed", tables, ro, rd, live, tlim, plan, baby_eps)
    streamed_intersect.launches += 1
    return out


def super_aabb(tile_aabb):
    """The super-tiles' boxes [ceil(Ct / 8), 8]: min and max over each run
    of ``SUPER_TILES`` tile boxes, a last short run filled up with never-hit
    boxes (which change no min or max), as the JAX package's
    ``run_streamed_super`` builds them."""
    ct = tile_aabb.shape[0]
    cs = (ct + SUPER_TILES - 1) // SUPER_TILES
    never = tile_aabb.new_tensor([1e30] * 3 + [-1e30] * 5).expand(cs * SUPER_TILES - ct, 8)
    grp = torch.cat([tile_aabb, never]).reshape(cs, SUPER_TILES, 8)
    return torch.cat([grp[:, :, 0:3].amin(dim=1), grp[:, :, 3:6].amax(dim=1),
                      grp.new_zeros((cs, 2))], dim=1).contiguous()


def streamed_super_plain(tables: MXUMeshTables, ro: Vec3, rd: Vec3, live, tlim,
                         splan: TilePlan, baby_eps: float):
    """The plain PyTorch version of the super-tile streamed walk -> (t,
    tri): every super-tile a block's plan lists stands for its (up to 8)
    member tiles, each visited with the ray's own member window, as
    ``walk_plain`` visits a plan's tiles.  The kernel's exit (strict, on the
    super box's entry bound, which is below every member tile's) and its
    gates skip only pairs that change nothing."""
    ct = tables.tile_aabb.shape[0]
    cs = (ct + SUPER_TILES - 1) // SUPER_TILES
    visits = _plan_visits(splan, cs).repeat_interleave(SUPER_TILES, dim=1)[:, :ct]
    return _visit_plain(tables, ro, rd, live, tlim, visits, baby_eps)


def streamed_super_intersect(tables, ro, rd, live, tlim, splan, baby_eps, saabb=None):
    """The streamed walk over super-tiles of ``SUPER_TILES`` tiles
    (``_streamed_super_kernel``): ``ptt_streamed_super_kernel`` on CUDA
    tensors, ``streamed_super_plain`` on CPU tensors.  ``splan``: the plan
    over ``super_aabb(tables.tile_aabb)`` (``saabb``, computed when None).
    A tile count that is no multiple of 8 needs no padded copy of the
    tables: the kernel never takes a tile past the last as a member."""
    if ro.x.device.type == "cpu":
        return streamed_super_plain(tables, ro, rd, live, tlim, splan, baby_eps)
    if saabb is None:
        saabb = super_aabb(tables.tile_aabb)
    out = _launch_walk("streamed_super", tables, ro, rd, live, tlim, splan, baby_eps, saabb)
    streamed_super_intersect.launches += 1
    return out


planned_lanebest_intersect.launches = 0
planned_intersect.launches = 0
streamed_intersect.launches = 0
streamed_super_intersect.launches = 0


# ---------------------------------------------------------------------------
# The sweep  (replaces ops/intersect_mxu.py::_intersect_kernel)
# ---------------------------------------------------------------------------

def sweep_intersect_plain(tables: MXUMeshTables, ro: Vec3, rd: Vec3, live, tlim,
                          baby_eps: float):
    """The plain PyTorch version of the sweep kernel -> (t, tri), ``(tlim,
    -1)`` where nothing closer is hit.  Every tile of the table in ascending
    id; a live ray takes a tile it is a member of (``_member_slab``) unless
    the tile's entry lies beyond its running best (``<=``: an entry equal to
    the best may still tie); a strictly smaller t wins, so an exact tie
    stays with the earlier tile, which holds the lower ids."""
    n = ro.x.shape[0]
    rf = _features(tables, ro, rd)
    best_t = tlim.clone()
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=tlim.device)
    for c, row in enumerate(tables.tile_aabb.tolist()):
        member, s_tlo, s_thi = _member_slab(row, rf.os, rf.inv, tlim)
        i = torch.nonzero(member & live & (s_tlo <= best_t)).flatten()
        tmin, gid = _eval_tile(tables, c, rf.feat, i, s_tlo, s_thi, baby_eps)
        upd = tmin < best_t[i]
        best_t[i] = torch.where(upd, tmin, best_t[i])
        best_tri[i] = torch.where(upd, gid, best_tri[i])
    return best_t, best_tri


def sweep_intersect(tables, ro, rd, live, tlim, baby_eps):
    """The plan-free sweep over a table of at most ``PLANNED_MAX_TILES``
    tiles (``_intersect_kernel``): ``ptt_sweep_kernel`` on CUDA tensors,
    ``sweep_intersect_plain`` on CPU tensors.  Rays unpadded [n]; returns
    (t, tri), tri an id of ``tables`` (a chunk's caller offsets it)."""
    if ro.x.device.type == "cpu":
        return sweep_intersect_plain(tables, ro, rd, live, tlim, baby_eps)
    out = _launch_walk("sweep", tables, ro, rd, live, tlim, None, baby_eps)
    sweep_intersect.launches += 1
    return out


sweep_intersect.launches = 0


# ---------------------------------------------------------------------------
# The epilogue variants  (replace scripts/profile_epilogue.py::lb_asc_kernel
# and ::mono_kernel of the JAX package)
# ---------------------------------------------------------------------------

EPILOGUE_MONO_FLAVORS = ("full", "gate", "mm")


def ascending_plan(plan: TilePlan, ct: int) -> TilePlan:
    """A front-to-back plan re-ordered by tile id (the script's ``ids_asc``):
    each block's candidate tiles first, in ascending id, then the others
    (a stable sort of the candidate mask); ``cnt`` is shared, ``tlo`` the
    block entry bounds in the new order."""
    nb = plan.cnt.shape[0]
    device = plan.cnt.device
    cand = _plan_visits(plan, ct)
    ar = torch.arange(ct, dtype=torch.int32, device=device)[None, :]
    ids = torch.argsort(torch.where(cand, ar, ct + ar), dim=1, stable=True)
    by_tile = torch.full((nb, ct), float("inf"), dtype=torch.float32, device=device)
    by_tile.scatter_(1, plan.ids.reshape(nb, ct).long(), plan.tlo.reshape(nb, ct))
    return TilePlan(ids.to(torch.int32).reshape(-1),
                    torch.gather(by_tile, 1, ids).reshape(-1), plan.cnt)


def _mm_plain(tables: MXUMeshTables, ro: Vec3, rd: Vec3, live, tlim, visits):
    """The "mm" flavors' definition (a timing floor, not an intersection),
    the JAX script's ``lb_mm`` / ``mono_call("mm")``: every ray of a block,
    live or not (a ray that is not live with all-zero features), against
    every tile the block visits; per pair the ``det`` numerator (the other
    three are computed, as the script's matmul computes all four columns,
    and dropped), folded into the ray's minimum with ties to the lower lane
    (the triangle's index inside its tile: the script's ``tri_lane`` wraps in
    int32 to the lane) -> (minimum, lane) where the minimum is below
    ``tlim``, else ``(tlim, -1)``."""
    n = ro.x.shape[0]
    device = ro.x.device
    block = torch.arange(n, device=device) // RAY_TILE
    feat = [torch.where(live, f, 0.0) for f in _features(tables, ro, rd).feat]
    best = torch.full((n,), float("inf"), dtype=torch.float32, device=device)
    lane_at = torch.full((n,), INT_MAX, dtype=torch.int32, device=device)
    lane = torch.arange(TRI_TILE, dtype=torch.int32, device=device)[None, :]
    step = _chunk(device)
    for c in range(tables.tile_aabb.shape[0]):
        coef = tables.coef[c * TRI_TILE:(c + 1) * TRI_TILE]
        rows = torch.nonzero(visits[block, c]).flatten()
        for s in range(0, rows.shape[0], step):
            k = rows[s:s + step]
            det = _numerators([f[k][:, None] for f in feat], coef)[0]
            qmin = torch.min(det, dim=1, keepdim=True).values
            jmin = torch.min(torch.where(det <= qmin, lane, INT_MAX), dim=1).values
            qmin = qmin[:, 0]
            upd = (qmin < best[k]) | ((qmin == best[k]) & (jmin < lane_at[k]))
            best[k] = torch.where(upd, qmin, best[k])
            lane_at[k] = torch.where(upd, jmin, lane_at[k])
    hit = best < tlim
    return torch.where(hit, best, tlim), torch.where(hit, lane_at, -1)


def lb_asc_plain(tables: MXUMeshTables, ro: Vec3, rd: Vec3, live, tlim, plan: TilePlan,
                 baby_eps: float, mm_only: bool = False):
    """The plain PyTorch version of ``ptt_lb_asc_kernel`` -> (t, tri):
    ``plan`` an ``ascending_plan``; each block's candidate tiles in
    ascending id, a ray against the tiles it is a member of, a strictly
    smaller t wins.  ``mm_only``: the floor flavor (``_mm_plain``)."""
    visits = _plan_visits(plan, tables.tile_aabb.shape[0])
    if mm_only:
        return _mm_plain(tables, ro, rd, live, tlim, visits)
    return _visit_plain(tables, ro, rd, live, tlim, visits, baby_eps, strict=True)


def lb_asc_intersect(tables, ro, rd, live, tlim, plan, baby_eps, mm_only=False):
    """The lane-best walk over an ascending-tile-id plan (the script's
    ``lb_asc``, up to ``PLANNED_MAX_TILES`` tiles): ``ptt_lb_asc_kernel`` on
    CUDA tensors, ``lb_asc_plain`` on CPU tensors.  The same function as
    ``planned_lanebest_intersect`` on the front-to-back plan; ``mm_only``
    (the script's ``lb_mm``) is a timing floor with wrong results."""
    if ro.x.device.type == "cpu":
        return lb_asc_plain(tables, ro, rd, live, tlim, plan, baby_eps, mm_only)
    out = _launch_walk("lb_mm" if mm_only else "lb_asc", tables, ro, rd, live, tlim, plan,
                       baby_eps)
    lb_asc_intersect.launches += 1
    return out


lb_asc_intersect.launches = 0


def _mono_visits(tables, ro, rd, live, tlim, gate: bool):
    """[NB, Ct] bool: the tiles a block of the epilogue mono walk takes:
    all of them for a block with a live ray and, with ``gate``, only those
    some live ray of the block is a member of."""
    n = ro.x.shape[0]
    nb = (n + RAY_TILE - 1) // RAY_TILE
    ct = tables.tile_aabb.shape[0]
    block = torch.arange(n, device=live.device) // RAY_TILE
    zeros = torch.zeros((nb,), dtype=torch.int32, device=live.device)
    any_of = lambda m: zeros.index_add(0, block, m.to(torch.int32)) > 0
    if not gate:
        return any_of(live)[:, None].expand(nb, ct)
    rf = _features(tables, ro, rd)
    return torch.stack([any_of(_member_slab(row, rf.os, rf.inv, tlim)[0] & live)
                        for row in tables.tile_aabb.tolist()], dim=1)


def epilogue_mono_plain(tables: MXUMeshTables, ro: Vec3, rd: Vec3, live, tlim,
                        baby_eps: float, flavor: str = "full"):
    """The plain PyTorch version of ``ptt_epilogue_mono_kernel`` -> (t,
    tri): every tile in ascending id for a block with a live ray ("gate":
    only the tiles some live ray of the block is a member of), a ray against
    the tiles it is a member of, a strictly smaller t wins; ``(tlim, -1)``
    where nothing closer is hit.  "mm": the floor flavor (``_mm_plain``)
    over every tile of a live block."""
    if flavor not in EPILOGUE_MONO_FLAVORS:
        raise ValueError(f"flavor={flavor!r}: use one of {EPILOGUE_MONO_FLAVORS}")
    visits = _mono_visits(tables, ro, rd, live, tlim, gate=flavor == "gate")
    if flavor == "mm":
        return _mm_plain(tables, ro, rd, live, tlim, visits)
    return _visit_plain(tables, ro, rd, live, tlim, visits, baby_eps, strict=True)


def epilogue_mono_intersect(tables, ro, rd, live, tlim, baby_eps, flavor="full"):
    """The plan-less walk of every tile in ascending id (the script's
    ``mono`` "full", ``mono_gate`` "gate" and the floor ``mono_mm`` "mm", up
    to ``PLANNED_MAX_TILES`` tiles): ``ptt_epilogue_mono_kernel`` on CUDA
    tensors, ``epilogue_mono_plain`` on CPU tensors.  ``live``: active and
    inside the root box, as the walks take it.  "full" and "gate" compute
    the function of ``mono_intersect``; they differ from it in the work
    they skip."""
    if flavor not in EPILOGUE_MONO_FLAVORS:
        raise ValueError(f"flavor={flavor!r}: use one of {EPILOGUE_MONO_FLAVORS}")
    if ro.x.device.type == "cpu":
        return epilogue_mono_plain(tables, ro, rd, live, tlim, baby_eps, flavor)
    out = _launch_walk(f"epilogue_mono_{flavor}", tables, ro, rd, live, tlim, None, baby_eps)
    epilogue_mono_intersect.launches += 1
    return out


epilogue_mono_intersect.launches = 0


# ---------------------------------------------------------------------------
# The packet-binned traversal  (_packet_bins, _run_binned; the visits
# replace ops/intersect_mxu.py::_binned_kernel)
# ---------------------------------------------------------------------------

class PacketBins(NamedTuple):
    """``src`` [pair_budget] int32: the packet in each slot (n_g = empty);
    ``vt`` [NV] int32: the tile of each 32-slot visit (-1 = empty); ``dst``
    [n_g, K] int32: each packet's slots, ascending (INT_MAX = unused; None
    with ``topk`` 0); ``overflow``: a bool tensor, the bins do not hold
    every candidate."""

    src: torch.Tensor
    vt: torch.Tensor
    dst: "torch.Tensor | None"
    overflow: torch.Tensor


def pair_budget(budget_rays: int, ct: int) -> int:
    gp = RAY_TILE // BINNED_G
    b = (budget_rays // BINNED_G) * min(BINNED_PAIR_MEAN, ct) + gp * ct
    return ((b + gp - 1) // gp) * gp


def packet_bins(tile_aabb, os: Vec3, d: Vec3, live, tl, budget: int, topk: int) -> PacketBins:
    """The JAX package's ``_packet_bins`` over a prefix of whole blocks:
    the packets (8 rays) of each tile's k=2 candidates laid out tile-major
    in 32-slot runs."""
    n_g = os.x.shape[0] // BINNED_G
    gp = RAY_TILE // BINNED_G
    ct = tile_aabb.shape[0]
    device = tl.device
    hg = torch.cat([h.reshape(n_g, BINNED_G, h.shape[1]).any(dim=1)
                    for h, _ in _pair_slabs(tile_aabb, os, d, live, tl)], dim=1)
    hi = hg.to(torch.int32)
    rank = torch.cumsum(hi, dim=0, dtype=torch.int32) - hi  # packets above, per tile
    n_c = hi.sum(dim=0, dtype=torch.int32)
    pad_cnt = ((n_c + gp - 1) // gp) * gp
    cum_end = torch.cumsum(pad_cnt, dim=0, dtype=torch.int32)
    off = cum_end - pad_cnt
    total = cum_end[-1]
    overflow = total > budget
    pid = torch.arange(n_g, dtype=torch.int32, device=device)[:, None]
    if topk > 0:
        k = min(topk, ct)
        slotmat = torch.where(hg, off[None, :] + rank, INT_MAX)
        if k < ct:
            overflow = overflow | torch.any(hi.sum(dim=1) > k)
            dst = torch.topk(slotmat, k, dim=1, largest=False, sorted=True).values
        else:
            dst = slotmat
    else:
        dst = torch.where(hg, off[None, :] + rank, budget)
    # The JAX scatter drops slots out of range (unused top-K entries, or
    # past an overflowing budget); here they land in one extra slot that is
    # cut off, so no host read of how many there are is needed.
    src = torch.full((budget + 1,), n_g, dtype=torch.int32, device=device)
    src.scatter_(0, torch.clamp(dst, max=budget).long().reshape(-1),
                 pid.expand(dst.shape).reshape(-1))
    src = src[:budget]
    nv = budget // gp
    slots = torch.arange(nv, dtype=torch.int32, device=device) * gp
    vt = torch.searchsorted(cum_end, slots, right=True).to(torch.int32)
    vt = torch.where(slots < total, torch.clamp(vt, max=ct - 1), -1)
    return PacketBins(src, vt, dst if topk > 0 else None, overflow)


def _pair_rays(vt, src, n_g: int, n: int):
    """Per pair row of the visits: (tile, ray index, valid)."""
    gp = RAY_TILE // BINNED_G
    r = torch.arange(vt.shape[0] * RAY_TILE, device=vt.device)
    v = r // RAY_TILE
    p = src[v * gp + (r % RAY_TILE) // BINNED_G].long()
    ray = p * BINNED_G + r % BINNED_G
    return vt[v], ray, (vt[v] >= 0) & (p < n_g) & (ray < n)


def binned_intersect_plain(tables, ro, rd, live, tlim, vt, src, n_g: int, baby_eps):
    """The plain PyTorch version of the binned kernel -> per pair row
    (t, tri) [NV * 256]: the row's ray against its visit's tile, (row
    minimum, lowest id at it) when closer than the ray's t_limit, else
    (inf, -1)."""
    n = ro.x.shape[0]
    tile, ray, ok = _pair_rays(vt, src, n_g, n)
    ray = torch.clamp(ray, max=n - 1)
    ok = ok & live[ray]
    rf = _features(tables, ro, rd)
    rows = tile.shape[0]
    pt = torch.full((rows,), float("inf"), dtype=torch.float32, device=tlim.device)
    ptri = torch.full((rows,), -1, dtype=torch.int32, device=tlim.device)
    aabb = tables.tile_aabb.tolist()
    for c in torch.unique(tile[ok]).tolist():
        sel = torch.nonzero(ok & (tile == c)).flatten()
        rr = ray[sel]
        member, s_tlo, s_thi = _member_slab(aabb[c], Vec3(*(x[rr] for x in rf.os)),
                                            Vec3(*(x[rr] for x in rf.inv)), tlim[rr])
        i = torch.nonzero(member).flatten()
        tmin, gid = _eval_tile(tables, c, [f[rr] for f in rf.feat], i, s_tlo, s_thi, baby_eps)
        acc = tmin < tlim[rr[i]]
        pt[sel[i]] = torch.where(acc, tmin, float("inf"))
        ptri[sel[i]] = torch.where(acc, gid, -1)
    return pt, ptri


def binned_intersect(tables, ro, rd, live, tlim, vt, src, n_g: int, baby_eps):
    """The binned visits (``_binned_kernel``): ``ptt_binned_kernel`` on CUDA
    tensors, ``binned_intersect_plain`` on CPU tensors.  Rays unpadded [n];
    ``n_g`` packets of 8 rays are binned (rays past ``n`` are dead)."""
    device = ro.x.device
    if device.type == "cpu":
        return binned_intersect_plain(tables, ro, rd, live, tlim, vt, src, n_g, baby_eps)
    _require_cuda("binned_intersect", device)
    n = ro.x.shape[0]
    nv = vt.shape[0]
    ct = tables.tile_aabb.shape[0]
    if ct > STREAMED_MAX_TILES:
        raise ValueError(f"binned_intersect: {ct} tiles exceed {STREAMED_MAX_TILES}")
    _check_rays("binned_intersect rays", [*ro, *rd, tlim], n, device)
    _check_tensor("binned_intersect live", live, torch.bool, (n,), device)
    _check_tables("binned_intersect", tables, ct, device)
    _check_tensor("binned_intersect vt", vt, torch.int32, (nv,), device)
    _check_tensor("binned_intersect src", src, torch.int32,
                  (nv * (RAY_TILE // BINNED_G),), device)
    lib = kernels.load("mesh_walk")
    out_t = torch.empty((nv * RAY_TILE,), dtype=torch.float32, device=device)
    out_tri = torch.empty((nv * RAY_TILE,), dtype=torch.int32, device=device)
    a = kernels.PttBinnedArgs()
    a.ray[:] = [p.data_ptr() for p in (*ro, *rd)]
    a.live, a.tlim = live.data_ptr(), tlim.data_ptr()
    a.coef = tables.coef.data_ptr()
    a.tile_aabb = tables.tile_aabb.data_ptr()
    a.center = tables.center.data_ptr()
    a.vt, a.src = vt.data_ptr(), src.data_ptr()
    a.out_t, a.out_tri = out_t.data_ptr(), out_tri.data_ptr()
    a.baby_eps, a.eps_succ = f32(baby_eps), _eps_succ(baby_eps)
    a.n, a.n_g, a.nv, a.ct = n, n_g, nv, ct
    code = lib.lib.ptt_launch_binned(ctypes.byref(a), kernels.stream_handle(device))
    lib.check(code, "binned_intersect")
    binned_intersect.launches += 1
    return out_t, out_tri


binned_intersect.launches = 0


def binned_reduce(pt, ptri, bins: PacketBins, tl, n_g: int):
    """Per ray across its packet's visits: the least t, then the lowest tri
    among exact ties (the contract's rule); ``(tl, -1)`` without a hit.
    ``tl``: the prefix's t_limits [n_g * 8]."""
    g = BINNED_G
    budget = bins.src.shape[0]
    pt, ptri = pt.reshape(budget, g), ptri.reshape(budget, g)
    inf = float("inf")
    if bins.dst is not None:  # gather each packet's own visit rows
        dsts = torch.clamp(bins.dst, max=budget).long()
        rows_t = torch.cat([pt, pt.new_full((1, g), inf)])[dsts]  # [n_g, K, g]
        rows_tri = torch.cat([ptri, ptri.new_full((1, g), INT_MAX)])[dsts]
        tmin = rows_t.amin(dim=1)
        trimin = torch.where(rows_t == tmin[:, None, :], rows_tri, INT_MAX).amin(dim=1)
    else:  # scatter-min by packet
        idx = bins.src.long()[:, None].expand(budget, g)
        tmin = pt.new_full((n_g + 1, g), inf).scatter_reduce(0, idx, pt, "amin")
        cand = torch.where(pt == tmin[bins.src.long()], ptri, INT_MAX)
        trimin = ptri.new_full((n_g + 1, g), INT_MAX).scatter_reduce(0, idx, cand, "amin")
        tmin, trimin = tmin[:n_g], trimin[:n_g]
    hit = tmin < inf
    out_t = torch.where(hit, tmin, tl.reshape(n_g, g))
    out_tri = torch.where(hit, trimin, -1)
    return out_t.reshape(-1), out_tri.reshape(-1)


def binned_prefixes(n_pad: int, tiers) -> list:
    """The binned tiers' prefix sizes (whole blocks), ascending."""
    npres = []
    for div in sorted(set(tiers), reverse=True):
        npre = min(n_pad, ((n_pad // div + RAY_TILE - 1) // RAY_TILE) * RAY_TILE)
        if 0 < npre and npre not in npres:
            npres.append(npre)
    return npres


# ---------------------------------------------------------------------------
# Traversal selection and the intersector entry point  (_run)
# ---------------------------------------------------------------------------

def resolve_traversal_mode(mode: str, padded_tris: int) -> str:
    """"auto" -> mono up to ``MONO_MAX_TILES`` tiles, planned up to
    ``CHUNK_TRIS``, binned in its band, else streamed (the JAX package's
    policy)."""
    if mode != "auto":
        return mode
    if padded_tris <= MONO_MAX_TILES * TRI_TILE:
        return "mono"
    if padded_tris <= CHUNK_TRIS:
        return "planned"
    if BINNED_AUTO_MIN < padded_tris <= BINNED_AUTO_MAX:
        return "binned"
    return "streamed"


def traversal_flags(mode: str, padded_tris: int, binned_tiers: tuple = None,
                    binned_budget_rays: int = None) -> dict:
    """``RenderConfig.mxu_traversal`` -> the intersector's flags, the JAX
    package's exactly."""
    mode = resolve_traversal_mode(mode, padded_tris)
    if mode == "sweep":
        return dict(planned=False, streamed=False)
    if mode == "mono":
        return dict(planned=True, streamed=False, mono=True)
    if mode == "planned":
        return dict(planned=True, streamed=False)
    if mode == "streamed":
        return dict(planned=True, streamed=True)
    if mode == "binned":
        flags = dict(planned=True, streamed=True, binned=True)
        if binned_tiers is not None:
            flags["binned_tiers"] = tuple(binned_tiers)
        if binned_budget_rays is not None:
            flags["binned_budget_rays"] = int(binned_budget_rays)
        return flags
    raise ValueError(f"unknown mxu_traversal mode: {mode!r}")


WALKS = {
    "planned_lanebest": planned_lanebest_intersect,
    "planned": planned_intersect,
    "streamed": streamed_intersect,
}


def _chunk_tables(tables: MXUMeshTables, g0: int, g1: int) -> MXUMeshTables:
    """Tiles ``g0..g1-1`` as a table of their own (views, no copy): what a
    call of the chunked chain walks.  Its triangle ids start at 0."""
    rows = slice(g0 * TRI_TILE, g1 * TRI_TILE)
    return tables._replace(
        features=tables.features[:, 4 * rows.start:4 * rows.stop],
        tile_aabb=tables.tile_aabb[g0:g1], attrs=tables.attrs[rows],
        attrs_shade=tables.attrs_shade[rows], coef=tables.coef[rows])


def _chain(tables, padded_tris, chunk_tris, ro, rd, live, tlim, baby_eps, planned, plan_for,
           lanebest, plain):
    """The JAX package's chunked multi-call chain: chunks of ``chunk_tris``
    triangles in tile order, each call's t_limit the running closest hit, so
    a call reports only hits strictly closer than everything before it (an
    exact tie stays with the earlier chunk, which holds the lower ids).
    ``planned``: each chunk's plan is built against the running best and
    walked by a planned kernel; else the rays that miss the chunk's
    envelope (k=2 widening, against the running best) are masked and the
    chunk is swept.  ``ro``/``rd``/``live``/``tlim`` are in the order the
    caller traverses in (sorted or not), and the envelope is taken from
    those same tensors."""
    per = max(1, chunk_tris // GROUP_TRIS)
    groups = padded_tris // GROUP_TRIS
    c = tables.center
    os, inv = Vec3(ro.x - c[0], ro.y - c[1], ro.z - c[2]), _inv_dir(rd)
    best_t, best_tri = tlim, None
    for g0 in range(0, groups, per):
        g1 = min(groups, g0 + per)
        sub = _chunk_tables(tables, g0, g1)
        if planned:
            kind = "planned_lanebest" if lanebest and g1 - g0 <= LANEBEST_MAX_TILES \
                else "planned"
            fn = walk_plain if plain else WALKS[kind]
            t_c, tri_c = fn(sub, ro, rd, live, best_t, plan_for(sub.tile_aabb, best_t), baby_eps)
        else:
            lo = torch.min(sub.tile_aabb[:, 0:3], dim=0).values
            hi = torch.max(sub.tile_aabb[:, 3:6], dim=0).values
            ctlo, cthi = _widen_slab(*_slab(lo, hi, os, inv), k=2)
            ok = (cthi >= ctlo) & (cthi > 0.0) & (ctlo < best_t)
            fn = sweep_intersect_plain if plain else sweep_intersect
            t_c, tri_c = fn(sub, ro, rd, live & ok, best_t, baby_eps)
        better = tri_c >= 0  # a call reports only hits closer than its t_limit
        tri_glob = torch.where(better, tri_c + g0 * GROUP_TRIS, -1)
        if best_tri is None:
            best_t, best_tri = t_c, tri_glob
        else:
            best_t = torch.where(better, t_c, best_t)
            best_tri = torch.where(better, tri_glob, best_tri)
    return best_t, best_tri


def _binning(tile_aabb, os: Vec3, d: Vec3, livep, tlp, live_pos: int, binned_tiers,
             binned_topk, binned_budget_rays):
    """The binned walk's ``(npre, bins)`` over the padded plan rays: the
    smallest tier of whole blocks holding the last live ray and its packet
    bins; None, for the streamed walk in its place, where the live rays
    exceed every tier or the bins cannot hold every candidate (one host
    read)."""
    n_pad = os.x.shape[0]
    tiers = binned_tiers if binned_tiers is not None else BINNED_PREFIX_TIERS
    topk = binned_topk if binned_topk is not None else BINNED_TOPK
    npre = next((p for p in binned_prefixes(n_pad, tiers) if live_pos < p), None)
    if npre is None:
        return None
    budget = pair_budget(max(npre, (binned_budget_rays or n_pad) // 4), tile_aabb.shape[0])
    cut = lambda v: Vec3(*(x[:npre] for x in v))
    bins = packet_bins(tile_aabb, cut(os), cut(d), livep[:npre], tlp[:npre], budget, topk)
    with host_read("overflow"):
        overflow = bool(bins.overflow)
    return None if overflow else (npre, bins)


def _traverse(tables, num_tris, padded_tris, ro, rd, active, tlim, baby_eps, planned,
              streamed, binned, mono, binned_tiers, binned_topk, binned_budget_rays,
              planned_epilogue, plan_impl, chunk_tris, plain):
    """The JAX package's ``_run`` after its sort, decision for decision: the
    capacity fallbacks (beyond the streamed plan's tiles "streamed" becomes
    the planned chain and "binned" is dropped), mono's gate, the plan-size
    guard (which turns "planned" into the sweep), then the dispatch, with
    the host reads its ``lax.cond``s take."""
    tiles = padded_tris // TRI_TILE
    if streamed and tiles > STREAMED_MAX_TILES:
        streamed, planned = False, True
    if binned and tiles > STREAMED_MAX_TILES:
        binned = False
    use_mono = mono and tiles <= MONO_MAX_TILES and padded_tris <= chunk_tris
    n = ro.x.shape[0]
    nb = (n + RAY_TILE - 1) // RAY_TILE
    if planned and not streamed and nb * max(1, min(padded_tris, chunk_tris) // TRI_TILE) \
            * 8 > PLAN_BUDGET:
        planned = False
    if not binned and use_mono:
        traverse = mono_intersect_plain if plain else mono_intersect
        with span("mesh.walk"):
            return traverse(tables, num_tris, ro, rd, active, tlim, baby_eps)

    ct = tables.tile_aabb.shape[0]
    n_pad = nb * RAY_TILE
    with span("mesh.plan"):
        live = active & root_hit_mask(tables.tile_aabb, tables.center, *ro, *rd, tlim)
        os, dp, livep, tlp = plan_rays(tables, ro, rd, live, tlim)
        plans = binned or streamed or planned  # the sweep builds no plan, reads nothing
        live_pos = -1
        if binned or (plans and nb >= 8):
            with host_read("live_pos"):
                live_pos = live_position(livep)
        binning = _binning(tables.tile_aabb, os, dp, livep, tlp, live_pos, binned_tiers,
                           binned_topk, binned_budget_rays) if binned else None

    def plan_for(aabb, tl=None):
        tl_p = tlp if tl is None else torch.cat([tl, tlp[n:]])
        return plan_with_prefix(aabb, os, dp, livep, tl_p, live_pos, impl=plan_impl,
                                plain=plain)

    def walk(kind):
        with span("mesh.plan"):
            plan = plan_for(tables.tile_aabb)
        with span("mesh.walk"):
            return (walk_plain if plain else WALKS[kind])(tables, ro, rd, live, tlim, plan,
                                                          baby_eps)

    lanebest = planned_epilogue in ("lanebest", "lanebest_force")
    if binning is not None:
        npre, bins = binning
        with span("mesh.walk"):
            fn = binned_intersect_plain if plain else binned_intersect
            pt, ptri = fn(tables, ro, rd, live, tlim, bins.vt, bins.src, npre // BINNED_G,
                          baby_eps)
            t_p, tri_p = binned_reduce(pt, ptri, bins, tlp[:npre], npre // BINNED_G)
            t = torch.cat([t_p, tlp[npre:]])[:n]
            tri = torch.cat([tri_p, tri_p.new_full((n_pad - npre,), -1)])[:n]
    elif binned:  # no tier holds the live rays, or the bins overflow
        t, tri = walk("streamed")
    elif streamed and stream_super_enabled(padded_tris):
        saabb = super_aabb(tables.tile_aabb)
        fn = streamed_super_plain if plain else streamed_super_intersect
        t, tri = fn(tables, ro, rd, live, tlim, plan_for(saabb), baby_eps)
    elif streamed:
        t, tri = walk("streamed")
    elif padded_tris <= chunk_tris:
        if planned:
            t, tri = walk("planned_lanebest" if lanebest and ct <= LANEBEST_MAX_TILES
                          else "planned")
        else:
            fn = sweep_intersect_plain if plain else sweep_intersect
            t, tri = fn(tables, ro, rd, live, tlim, baby_eps)
    else:
        t, tri = _chain(tables, padded_tris, chunk_tris, ro, rd, live, tlim, baby_eps,
                        planned, plan_for, lanebest, plain)
    return t, torch.where(tri >= num_tris, -1, tri)


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
    planned: bool = False,
    sort_mode: str = "morton",
    streamed: bool = False,
    binned: bool = False,
    binned_tiers: tuple = None,
    binned_topk: int = None,
    binned_budget_rays: int = None,
    planned_epilogue: str = None,
    mono: bool = False,
    plan_impl: str = None,
    chunk_tris: int = CHUNK_TRIS,
    plain: bool = False,
) -> MeshHit:
    """Closest hit over the mesh, with the JAX package's traversal flags
    (``traversal_flags``; the default, all off, is the sweep).  With
    ``sort_rays`` the rays go through the traversal in coherence order and
    the results are scattered back (a pure permutation: identical
    results).  (u, v) are recomputed from the winner's geometry when
    ``compute_uv``.  ``plain`` runs the traversal's plain versions on any
    device.  ``planned_epilogue`` None reads ``PTT_PLANNED_EPILOGUE``
    (default "lanebest"), as the JAX package does: "lanebest" takes the
    lane-best walk up to ``LANEBEST_MAX_TILES`` tiles, any other value the
    walk with the early exit.  ``plan_impl`` None reads ``PTT_PLAN_IMPL``
    (default "xla", the plan in torch; "pallas", the JAX package's name,
    takes the plan prepass kernel).  ``chunk_tris``: the most triangles one
    call of a planned walk or the sweep takes; a larger mesh runs as the
    chunked chain (at most ``CHUNK_TRIS``: the kernels' table)."""
    if planned_epilogue is None:
        planned_epilogue = environ.get("PTT_PLANNED_EPILOGUE", "lanebest")
    if plan_impl is None:
        plan_impl = environ.get("PTT_PLAN_IMPL", "xla")
    active = active.contiguous()
    t_limit = t_limit.to(torch.float32).contiguous()
    flags = dict(planned=planned, streamed=streamed, binned=binned, mono=mono,
                 binned_tiers=binned_tiers, binned_topk=binned_topk,
                 binned_budget_rays=binned_budget_rays,
                 planned_epilogue=planned_epilogue, plan_impl=plan_impl,
                 chunk_tris=chunk_tris, plain=plain)
    if sort_rays:
        key = sort_key(tables, ro, rd, active, t_limit, sort_bits, sort_dir_bits, sort_mode,
                       mesh_bounds)
        perm = torch.argsort(key, stable=True)
        sro, srd = Vec3(*(p[perm] for p in ro)), Vec3(*(p[perm] for p in rd))
        t_s, tri_s = _traverse(tables, num_tris, padded_tris, sro, srd, active[perm],
                               t_limit[perm], baby_eps, **flags)
        t, tri = torch.empty_like(t_s), torch.empty_like(tri_s)
        t[perm], tri[perm] = t_s, tri_s
    else:
        ro = Vec3(*(p.contiguous() for p in ro))
        rd = Vec3(*(p.contiguous() for p in rd))
        t, tri = _traverse(tables, num_tris, padded_tris, ro, rd, active, t_limit,
                           baby_eps, **flags)
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
