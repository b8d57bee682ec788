// Per-ray bodies of the mesh kernels in fused_mesh.cu and mesh_walk.cu.
//
// Each function is the per-ray form of a torch function of the port (and so
// of the JAX package), written operation for operation in the same order.
// The kernels of #4-#10 and #13 run the block schedule (walk_take,
// spread_load, spread_key below; #13's full-width flavors wide_key,
// wide_sink, wide_mm_key); the per-ray walks (walk_visit, tile_fold,
// sweep_ray, super_visit, binned_pair, mono_ray, asc_visit, mm_fold) are the
// schedule they had before it, kept as the references
// tests/mesh_path_host.cpp holds the block schedule to:
//   walk_visit      = one (ray, tile) pair of ops/intersect_mxu.py::_tile_min
//                     (the member slab, _mt_hit) folded in with the
//                     contract's tie rule, as walk_plain folds it;
//   asc_visit       = the same pair folded with a strict "<" only, for the
//                     walks that take tiles in ascending id
//                     (ops/intersect_mxu.py::lb_asc_plain, epilogue_mono_plain);
//   mm_fold         = one (ray, tile) pair of the timing-floor flavors
//                     (ops/intersect_mxu.py::_mm_plain): the numerators and
//                     a minimum of det, no acceptance;
//   binned_pair     = one pair row of ops/intersect_mxu.py::binned_intersect_plain;
//   sweep_ray       = one ray of ops/intersect_mxu.py::sweep_intersect_plain;
//   super_take,     = one ray's gate on, and visit of, a super-tile plan
//   super_visit       entry (ops/intersect_mxu.py::streamed_super_plain);
//   plan_pair       = one (ray, tile) pair of ops/intersect_mxu.py::_pair_slabs,
//                     the slab stage of the tile plan (plan_prepass_plain)
//                     and of the packet bins;
//   bins_nibble,    = the packet bins' steps (packet_bins_plain): a warp's
//   bins_pad,         packets that enter a tile, a tile's padded run, a
//   bins_visit_tile,  visit's tile, a packet's slot, and which of its
//   bins_slot,        slots are listed;
//   bins_listed
//   mono_ray        = ops/intersect_mxu.py::mono_intersect_plain (the root
//                     cull, then walk_visit over the tiles in order);
//   coherence_key   = ops/intersect_mxu.py::signature_key;
//   prim_t_min_win  = ops/intersect.py::prim_t_min with its winner;
//   prim_hit_of     = the prim half of ops/intersect.py::intersect_scene
//                     given that winner (ops/intersect.py::intersect_winner);
//   mesh_surface    = ops/fused.py::resolve_mesh_surface (the winner's row,
//                     (u, v), interpolated normal and material of mode
//                     "plain");
//   mesh_shade_ray  = ops/fused.py::fused_mesh_shade_plain in its three modes
//                     (prim intersect or the carried winner, merge with the
//                     mesh hit or the resolved surface, scatter, inline
//                     uniforms).
// The prim intersection, scatter and Threefry come from prim_path.cuh.
// Build with --fmad=false and without fast math, as prim_path.cuh says; the
// only fused multiply-adds are the explicit fmaf chains of the numerators,
// which the plain version reproduces with ops/intersect_mxu.py::fma32.

#pragma once

#include "prim_path.cuh"

#define PTT_TRI_TILE 1024
#define PTT_COEF_W 20       // coefficients per triangle row (19 used)
#define PTT_MONO_MAX_TILES 8
#define PTT_PLANNED_MAX_CT 32    // ops/intersect_mxu.py::CHUNK_TRIS / TRI_TILE
#define PTT_STREAMED_MAX_CT 1024  // the streamed plan's capacity
#define PTT_RAY_TILE 256          // rays per plan block (ops/intersect_mxu.py::RAY_TILE)
#define PTT_BINNED_G 8            // rays per packet (ops/intersect_mxu.py::BINNED_G)
#define PTT_SUPER_TILES 8         // tiles per super-tile (ops/intersect_mxu.py::SUPER_TILES)
#define PTT_INT_MAX 0x7FFFFFFF

// float32 values of the JAX package's Python constants, written exactly.
#define PTT_INV_ZERO 0x1.79ca1p-67f   // float32(1e-20): stands in for d == 0
#define PTT_SLAB_REL1 0x1.0c6f7ap-18f  // float32(4e-6): SLAB_EPS_REL, k = 1
#define PTT_SLAB_ABS1 0x1.a36e2ep-14f  // float32(1e-4): SLAB_EPS_ABS, k = 1
#define PTT_SLAB_REL2 0x1.0c6f7ap-17f  // float32(8e-6): k = 2
#define PTT_SLAB_ABS2 0x1.a36e2ep-13f  // float32(2e-4): k = 2

PTT_HD float ptt_as_float(int32_t i) {
#if defined(__CUDA_ARCH__)
  return __int_as_float(i);
#else
  float f;
  memcpy(&f, &i, sizeof(f));
  return f;
#endif
}

PTT_HD int32_t ptt_as_int(float f) {
#if defined(__CUDA_ARCH__)
  return __float_as_int(f);
#else
  int32_t i;
  memcpy(&i, &f, sizeof(i));
  return i;
#endif
}

PTT_HD float ptt_inf() { return ptt_as_float(0x7F800000); }

// ---------------------------------------------------------------------------
// Slab tests (ops/intersect_mxu.py::_slab, _widen_slab)
// ---------------------------------------------------------------------------

struct Slab {
  float lo, hi;
};

PTT_HD V3 inv_dir(V3 d) {
  return v3(1.0f / (d.x == 0.0f ? PTT_INV_ZERO : d.x), 1.0f / (d.y == 0.0f ? PTT_INV_ZERO : d.y),
            1.0f / (d.z == 0.0f ? PTT_INV_ZERO : d.z));
}

// Entry/exit of a ray (recentred origin os, reciprocal direction inv)
// against the box [lo, hi].
PTT_HD Slab slab(const float* lo, const float* hi, V3 os, V3 inv) {
  const float t1x = (lo[0] - os.x) * inv.x, t2x = (hi[0] - os.x) * inv.x;
  const float t1y = (lo[1] - os.y) * inv.y, t2y = (hi[1] - os.y) * inv.y;
  const float t1z = (lo[2] - os.z) * inv.z, t2z = (hi[2] - os.z) * inv.z;
  Slab s;
  s.lo = ptt_max(ptt_max(ptt_min(t1x, t2x), ptt_min(t1y, t2y)), ptt_min(t1z, t2z));
  s.hi = ptt_min(ptt_min(ptt_max(t1x, t2x), ptt_max(t1y, t2y)), ptt_max(t1z, t2z));
  return s;
}

PTT_HD Slab widen(Slab s, float rel, float abs_margin) {
  s.lo = s.lo - rel * fabsf(s.lo) - abs_margin;
  s.hi = s.hi + rel * fabsf(s.hi) + abs_margin;
  return s;
}

PTT_HD bool slab_enters(Slab s, float tlim) {
  return (s.hi >= s.lo) && (s.hi > 0.0f) && (s.lo < tlim);
}

// root_hit_mask: box is the tables' root_box (the envelope of the tile
// boxes, in a tile row's layout), k = 2 widening.
PTT_HD bool root_hit(const float* box, V3 os, V3 inv, float tlim) {
  return slab_enters(widen(slab(box, box + 3, os, inv), PTT_SLAB_REL2, PTT_SLAB_ABS2), tlim);
}

// ---------------------------------------------------------------------------
// One candidate (ray, tile) pair: the per-ray pieces every traversal shares
// ---------------------------------------------------------------------------

// One triangle's coefficient row (ops/intersect_mxu.py::MONO_COEF): det
// 0-2, u 3-8, v 9-14, t 15-18.  Rows are 80 bytes, so 16-byte aligned.
PTT_HD void load_coef(const float* row, float c[PTT_COEF_W]) {
#if defined(__CUDA_ARCH__)
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int k = 0; k < PTT_COEF_W / 4; ++k) {
    const float4 q = __ldg(r4 + k);
    c[4 * k] = q.x;
    c[4 * k + 1] = q.y;
    c[4 * k + 2] = q.z;
    c[4 * k + 3] = q.w;
  }
#else
  for (int k = 0; k < PTT_COEF_W; ++k) c[k] = row[k];
#endif
}

// A ray as the traversals see it: the recentred origin, the reciprocal
// direction, the ten features in _run's order (d, o x d, o, 1), its t_limit,
// whether it is live (active and inside the root box), and its running
// closest hit.
struct WalkRay {
  V3 os, inv;
  float f[10];
  float tlim;
  bool live;
  float best;
  int32_t best_tri;
};

PTT_HD WalkRay walk_ray(V3 center, V3 o, V3 d, bool live, float tlim) {
  WalkRay r;
  r.os = v3(o.x - center.x, o.y - center.y, o.z - center.z);
  r.inv = inv_dir(d);
  r.f[0] = d.x;
  r.f[1] = d.y;
  r.f[2] = d.z;
  r.f[3] = r.os.y * d.z - r.os.z * d.y;
  r.f[4] = r.os.z * d.x - r.os.x * d.z;
  r.f[5] = r.os.x * d.y - r.os.y * d.x;
  r.f[6] = r.os.x;
  r.f[7] = r.os.y;
  r.f[8] = r.os.z;
  r.f[9] = 1.0f;
  r.tlim = tlim;
  r.live = live;
  r.best = tlim;
  r.best_tri = -1;
  return r;
}

// The four Moller-Trumbore numerators of one coefficient row, each a chain
// of fused multiply-adds in ascending feature order.
struct Numerators {
  float det, un, vn, tn;
};

PTT_HD Numerators numerators_k(const float f[10], const float k[PTT_COEF_W]) {
  Numerators m = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int q = 0; q < 3; ++q) m.det = fmaf(f[q], k[q], m.det);
#pragma unroll
  for (int q = 0; q < 6; ++q) m.un = fmaf(f[q], k[3 + q], m.un);
#pragma unroll
  for (int q = 0; q < 6; ++q) m.vn = fmaf(f[q], k[9 + q], m.vn);
#pragma unroll
  for (int q = 0; q < 4; ++q) m.tn = fmaf(f[6 + q], k[15 + q], m.tn);
  return m;
}

PTT_HD Numerators numerators(const float f[10], const float* row) {
  float k[PTT_COEF_W];
  load_coef(row, k);
  return numerators_k(f, k);
}

// Keeps the four numerators live on the card, where a caller that reads
// none of them must still pay for them (the timing floors, the full-width
// flavors' non-member pairs): an empty asm volatile takes them as operands.
// The host build needs no sink.
PTT_HD void numerators_sink(const Numerators& m) {
#if defined(__CUDA_ARCH__)
  asm volatile("" ::"f"(m.det), "f"(m.un), "f"(m.vn), "f"(m.tn));
#else
  (void)m;
#endif
}

// _mt_hit on one coefficient row k: the numerators, the sign of det XORed
// into u and v, |det| for their sum, and the hit confined to [t_lo, t_hi].
PTT_HD bool mt_accept_k(const float f[10], const float k[PTT_COEF_W], float baby_eps, float t_lo,
                        float t_hi, float* tt) {
  const Numerators m = numerators_k(f, k);
  const float det = m.det, un = m.un, vn = m.vn, tn = m.tn;
  const float abs_det = fabsf(det);
  const bool det_ok = abs_det >= baby_eps;
  const float inv_det = 1.0f / (det_ok ? det : 1.0f);
  *tt = tn * inv_det;
  const int32_t sign = ptt_as_int(det) & INT32_MIN;
  const float us = ptt_as_float(ptt_as_int(un) ^ sign);
  const float vs = ptt_as_float(ptt_as_int(vn) ^ sign);
  return det_ok && (ptt_min(us, vs) >= 0.0f) && (us + vs <= abs_det) && (*tt >= t_lo) &&
         (*tt <= t_hi);
}

PTT_HD bool mt_accept(const float f[10], const float* row, float baby_eps, float t_lo,
                      float t_hi, float* tt) {
  float k[PTT_COEF_W];
  load_coef(row, k);
  return mt_accept_k(f, k, baby_eps, t_lo, t_hi, tt);
}

// The ray's 1,024 triangles of one tile, folded into its running closest
// hit under the candidate contract's rule: a smaller t wins, an equal t
// goes to the lower global triangle id.  The rule makes the result
// independent of the order in which tiles are visited.  s: the ray's
// widened (k = 1) slab against the tile, which confines the hits.
PTT_HD void tile_fold(WalkRay& r, const float* coef, int tile, Slab s, float baby_eps,
                      float eps_succ) {
  const float t_lo = ptt_max(s.lo, eps_succ);
  const float t_hi = s.hi;
  const float* cf = coef + (size_t)tile * PTT_TRI_TILE * PTT_COEF_W;
  const int32_t base = tile * PTT_TRI_TILE;
  for (int j = 0; j < PTT_TRI_TILE; ++j, cf += PTT_COEF_W) {
    float tt;
    if (mt_accept(r.f, cf, baby_eps, t_lo, t_hi, &tt) &&
        (tt < r.best || (tt == r.best && base + j < r.best_tri))) {
      r.best = tt;
      r.best_tri = base + j;
    }
  }
}

// One visit of a tile by one ray (the per-ray walks: mono_ray, sweep_ray,
// super_visit, binned_pair, and the host twin of the planned walks, all
// references of the block schedule now): the
// member test against the tile's box (row: 8 floats) and, for a member,
// the fold.  With gate, a
// member whose slab entry lies beyond its running best skips the tile:
// every t the tile can give it is >= that entry, so nothing it holds can
// change (the improvability gate of the ordered walks, per ray).
PTT_HD void walk_visit(WalkRay& r, const float* coef, const float* row, int tile, bool gate,
                       float baby_eps, float eps_succ) {
  if (!r.live) return;
  const Slab s = widen(slab(row, row + 3, r.os, r.inv), PTT_SLAB_REL1, PTT_SLAB_ABS1);
  if (!slab_enters(s, r.tlim)) return;  // not a candidate tile for this ray
  if (gate && !(s.lo <= r.best)) return;
  tile_fold(r, coef, tile, s, baby_eps, eps_succ);
}

// The epilogue variants (scripts/profile_epilogue.py of the JAX package):
// walks that take tiles in ascending id.  A later tile holds only higher
// triangle ids, so the contract's tie rule needs no id comparison: a strict
// "<" keeps the first, lowest, id at the minimum.  One compare and two
// selects a pair, against tile_fold's three compares.
//
// One (ray, tile) pair of such a walk.  A ray that is not a member of the
// tile (or not live) is skipped with skip_nonmember; without, its 1,024
// pairs are evaluated all the same behind an interval nothing can enter
// (t_lo = +inf, t_hi = -inf), as the TPU kernel evaluates every lane of a
// tile it visits.  asc_member: the ray is live and a member of the tile
// (s: its k = 1 widened slab).
PTT_HD bool asc_member(const WalkRay& r, const float* row, Slab* s) {
  *s = widen(slab(row, row + 3, r.os, r.inv), PTT_SLAB_REL1, PTT_SLAB_ABS1);
  return r.live && slab_enters(*s, r.tlim);
}

PTT_HD void asc_fold(WalkRay& r, const float* coef, int tile, bool member, Slab s, float baby_eps,
                     float eps_succ) {
  const float t_lo = member ? ptt_max(s.lo, eps_succ) : ptt_inf();
  const float t_hi = member ? s.hi : -ptt_inf();
  const float* cf = coef + (size_t)tile * PTT_TRI_TILE * PTT_COEF_W;
  const int32_t base = tile * PTT_TRI_TILE;
  for (int j = 0; j < PTT_TRI_TILE; ++j, cf += PTT_COEF_W) {
    float tt;
    if (mt_accept(r.f, cf, baby_eps, t_lo, t_hi, &tt) && tt < r.best) {
      r.best = tt;
      r.best_tri = base + j;
    }
  }
}

PTT_HD void asc_visit(WalkRay& r, const float* coef, const float* row, int tile,
                      bool skip_nonmember, float baby_eps, float eps_succ) {
  Slab s;
  const bool member = asc_member(r, row, &s);
  if (skip_nonmember && !member) return;
  asc_fold(r, coef, tile, member, s, baby_eps, eps_succ);
}

// The timing-floor flavors ("mm": wrong results by design), the JAX
// script's lb_mm and mono_call("mm") (scripts/profile_epilogue.py, the
// mm_only branch of lb_asc_kernel and mono_kernel's "mm" tile_eval).  There
// each visited tile's matmul gives all four numerator columns and only
// det's is kept: lane_t = min(lane_t, det) per lane, lane_tile left at
// 1 << 30.  Its resolve then takes the row minimum, and the lowest lane at
// it as tri_lane = lane_tile * 1,024 + lane, which wraps in int32 to the
// lane itself; so per ray: the least det over the visited tiles' pairs,
// ties to the lower lane (the triangle's index inside its tile) whatever
// tile it came from.  A ray that is not live runs with all-zero features,
// as the script's zeroed feature rows do.  The other three numerator chains
// are computed and kept live (numerators_sink), so the floor still pays for
// the four chains the matmul computes.  mm_ray
// prepares the ray, mm_fold takes one tile, mm_resolve gives (min, lane)
// below the ray's t_limit, else (t_limit, -1).
PTT_HD void mm_ray(WalkRay& r) {
  if (!r.live) {
    for (int q = 0; q < 10; ++q) r.f[q] = 0.0f;
  }
  r.best = ptt_inf();
  r.best_tri = PTT_INT_MAX;
}

PTT_HD void mm_fold(WalkRay& r, const float* coef, int tile) {
  const float* cf = coef + (size_t)tile * PTT_TRI_TILE * PTT_COEF_W;
  for (int j = 0; j < PTT_TRI_TILE; ++j, cf += PTT_COEF_W) {
    const Numerators m = numerators(r.f, cf);
    numerators_sink(m);
    if (m.det < r.best || (m.det == r.best && j < r.best_tri)) {
      r.best = m.det;
      r.best_tri = j;
    }
  }
}

PTT_HD void mm_resolve(WalkRay& r) {
  if (!(r.best < r.tlim)) {
    r.best = r.tlim;
    r.best_tri = -1;
  }
}

// The early exit of the ordered walks: a block stops before a plan entry
// whose entry bound exceeds every live ray's running best.  This is the
// ray's share of that vote (dead rays count as 0, as in the JAX package).
PTT_HD bool walk_goes_on(const WalkRay& r, float tile_tlo) {
  return tile_tlo <= (r.live ? r.best : 0.0f);
}

// The block schedule of the mono, planned, streamed, super-tile and sweep
// walks and the binned visits (ptt_mono_kernel, ptt_planned_lanebest_kernel,
// ptt_planned_kernel, ptt_streamed_kernel, ptt_streamed_super_kernel,
// ptt_sweep_kernel, ptt_binned_kernel; their shared per-entry body is
// spread_entry in mesh_walk.cu): a tile's (ray,
// triangle) pairs are spread over the block's threads instead of one thread
// walking its ray's 1,024 triangles.  Per tile:
//   walk_take    each ray's share of the member test and the improvability
//                gate of walk_visit, and its pair window [t_lo, t_hi] of
//                tile_fold; the rays that take the tile are listed;
//   spread_load  thread tid loads the rows of its triangles tid + T i,
//                i < 1,024 / T, into registers (T: PTT_SPREAD_THREADS);
//   spread_key   and evaluates them against each listed ray: the least key
//                of its accepted pairs;
// and each ray's running best is the minimum of the keys it is given.  A
// key orders (t, tri) as tile_fold's rule does: a smaller t, then a lower
// id.  Its high word is t's bits mapped so that unsigned order is float
// order (negative values included), its low word tri + 1: the initial
// (t_limit, -1) becomes (t_limit, 0), below every (t_limit, tri >= 0), so a
// hit at exactly t_limit never replaces it (tile_fold's "tri < -1" is never
// true).  The minimum of keys is the lexicographic minimum tile_fold folds
// to in any order, so the schedule gives the per-ray walk's (t, tri) bit
// for bit.
#ifndef PTT_SPREAD_THREADS
#define PTT_SPREAD_THREADS 512  // threads a block spreads an entry's pairs over
#endif
#define PTT_SPREAD (PTT_TRI_TILE / PTT_SPREAD_THREADS)  // triangles a thread takes per entry
#define PTT_NO_KEY 0xFFFFFFFFFFFFFFFFull

PTT_HD uint64_t walk_key(float t, int32_t tri) {
  const uint32_t b = (uint32_t)ptt_as_int(t);
  const uint32_t u = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((uint64_t)u << 32) | (uint32_t)(tri + 1);
}

PTT_HD void walk_unkey(uint64_t key, float* t, int32_t* tri) {
  const uint32_t u = (uint32_t)(key >> 32);
  *t = ptt_as_float((int32_t)((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u));
  *tri = (int32_t)(uint32_t)key - 1;
}

PTT_HD bool walk_take(const WalkRay& r, const float* row, float eps_succ, float* t_lo,
                      float* t_hi) {
  if (!r.live) return false;
  const Slab s = widen(slab(row, row + 3, r.os, r.inv), PTT_SLAB_REL1, PTT_SLAB_ABS1);
  if (!slab_enters(s, r.tlim) || !(s.lo <= r.best)) return false;
  *t_lo = ptt_max(s.lo, eps_succ);
  *t_hi = s.hi;
  return true;
}

PTT_HD void spread_load(const float* coef, int tile, int tid, float k[PTT_SPREAD][PTT_COEF_W]) {
  const float* cf = coef + ((size_t)tile * PTT_TRI_TILE + tid) * PTT_COEF_W;
#pragma unroll
  for (int i = 0; i < PTT_SPREAD; ++i) {
    load_coef(cf + (size_t)i * PTT_SPREAD_THREADS * PTT_COEF_W, k[i]);
  }
}

// tri0: the global id of the thread's first triangle, tile * 1,024 + tid.
// wide_key below is this function with the u/v tests before the division;
// the two are to become one body in that order.
PTT_HD uint64_t spread_key(const float f[10], float t_lo, float t_hi,
                           const float k[PTT_SPREAD][PTT_COEF_W], int32_t tri0, float baby_eps) {
  uint64_t best = PTT_NO_KEY;
#pragma unroll
  for (int i = 0; i < PTT_SPREAD; ++i) {
    float tt;
    if (mt_accept_k(f, k[i], baby_eps, t_lo, t_hi, &tt)) {
      const uint64_t key = walk_key(tt, tri0 + i * PTT_SPREAD_THREADS);
      best = key < best ? key : best;
    }
  }
  return best;
}

// The full-width schedule of the epilogue variants' "full" and "gate"
// flavors and of the timing floors (ptt_epilogue_mono_kernel, the floor of
// ptt_lb_asc_kernel; wide_spread in mesh_walk.cu): every ray of a visiting
// block against every triangle of the tile, the pairs dealt over the
// block's threads as spread_load deals them.  The flavors are defined to
// evaluate the pairs of rays that are not members of the tile too, so each
// such pair costs its four numerators (wide_sink); only a member pair runs
// the epilogue (wide_key), and the floors fold det alone (wide_mm_key).
PTT_HD void wide_sink(const float f[10], const float k[PTT_SPREAD][PTT_COEF_W]) {
#pragma unroll
  for (int i = 0; i < PTT_SPREAD; ++i) numerators_sink(numerators_k(f, k[i]));
}

// spread_key's function with the acceptance reordered: det_ok and the u/v
// conditions before the division, which then runs only for a pair inside
// its triangle.  tt is computed as mt_accept_k computes it (tn times the
// correctly rounded 1 / det), and the conditions are the same conjunction,
// so the keys are spread_key's bit for bit.  Dividing on every member pair
// first, as spread_key does, took 31-48% longer on the H100 (PERF.md).
PTT_HD uint64_t wide_key(const float f[10], float t_lo, float t_hi,
                         const float k[PTT_SPREAD][PTT_COEF_W], int32_t tri0, float baby_eps) {
  uint64_t best = PTT_NO_KEY;
#pragma unroll
  for (int i = 0; i < PTT_SPREAD; ++i) {
    const Numerators m = numerators_k(f, k[i]);
    const float abs_det = fabsf(m.det);
    const int32_t sign = ptt_as_int(m.det) & INT32_MIN;
    const float us = ptt_as_float(ptt_as_int(m.un) ^ sign);
    const float vs = ptt_as_float(ptt_as_int(m.vn) ^ sign);
    if (abs_det >= baby_eps && ptt_min(us, vs) >= 0.0f && us + vs <= abs_det) {
      const float tt = m.tn * (1.0f / m.det);
      if (tt >= t_lo && tt <= t_hi) {
        const uint64_t key = walk_key(tt, tri0 + i * PTT_SPREAD_THREADS);
        best = key < best ? key : best;
      }
    }
  }
  return best;
}

// A floor pair's key: det's ordered bits (walk_key's high word), then the
// lane (the triangle's index inside its tile) as the low word, so the key
// minimum is mm_fold's (least det, ties to the lower lane).  -0 is keyed as
// +0: the fold's "==" takes them as equal and goes to the lower lane, where
// the ordered bits put -0 below +0.  mm_unkey is the key read back through
// mm_resolve: (det, lane) below t_limit, else (t_limit, -1).
PTT_HD uint64_t mm_key(float det, int32_t lane) {
  return walk_key(det == 0.0f ? 0.0f : det, lane - 1);
}

PTT_HD void mm_unkey(uint64_t key, float tlim, float* t, int32_t* lane) {
  WalkRay r;
  walk_unkey(key, &r.best, &r.best_tri);
  r.best_tri += 1;
  r.tlim = tlim;
  mm_resolve(r);
  *t = r.best;
  *lane = r.best_tri;
}

// A thread's floor pairs against one ray: the least key of its triangles
// (lanes lane0 + PTT_SPREAD_THREADS i), the other three numerators kept.
PTT_HD uint64_t wide_mm_key(const float f[10], const float k[PTT_SPREAD][PTT_COEF_W],
                            int32_t lane0) {
  uint64_t best = PTT_NO_KEY;
#pragma unroll
  for (int i = 0; i < PTT_SPREAD; ++i) {
    const Numerators m = numerators_k(f, k[i]);
    numerators_sink(m);
    const uint64_t key = mm_key(m.det, lane0 + i * PTT_SPREAD_THREADS);
    best = key < best ? key : best;
  }
  return best;
}

// The sweep for one ray (_intersect_kernel): every tile of the table in
// ascending id, each behind the member test and the improvability gate
// (entry <= running best: an entry equal to the best may still tie).  In
// ascending order tile_fold's tie rule is the TPU kernel's strict "<": a
// later tile holds only higher ids.  The TPU kernel's per-block any_hit is
// a visit cull; the per-ray gate skips the same pairs and more.
PTT_HD void sweep_ray(WalkRay& r, const float* coef, const float* aabb, int ct, float baby_eps,
                      float eps_succ) {
  for (int c = 0; c < ct; ++c) walk_visit(r, coef, aabb + 8 * c, c, true, baby_eps, eps_succ);
}

// The gate of a super-tile plan entry (_streamed_super_kernel) for one ray:
// live, a member of the super box (srow: the min/max over its member boxes;
// a member of any of its tiles is a member of it), and its entry there no
// farther than the running best (it is at or below every member tile's).
PTT_HD bool super_take(const WalkRay& r, const float* srow) {
  if (!r.live) return false;
  const Slab s = widen(slab(srow, srow + 3, r.os, r.inv), PTT_SLAB_REL1, PTT_SLAB_ABS1);
  return slab_enters(s, r.tlim) && s.lo <= r.best;
}

// A padding tile of tables padded to whole super-tiles
// (ops/intersect_mxu.py::build_mxu_tables): its box is inverted (lo 1e30 >
// hi -1e30) and its coefficient rows are zero.  The slab test is symmetric
// in lo and hi, so it passes for every ray; the zero rows never accept a
// pair (det = 0), so a walk may skip the tile.
PTT_HD bool padding_tile(const float* row) { return row[0] > row[3]; }

// One visit of a super-tile plan entry by one ray: the gate, then the
// member tiles sid * 8 .. sid * 8 + 7, each with the ray's own member
// window.  A tile past the last (ct) does not exist.  The per-tile gate of
// walk_visit is exact here as in the other ordered walks.
PTT_HD void super_visit(WalkRay& r, const float* coef, const float* aabb, const float* srow,
                        int sid, int ct, float baby_eps, float eps_succ) {
  if (!super_take(r, srow)) return;
  for (int k = 0; k < PTT_SUPER_TILES; ++k) {
    const int tile = sid * PTT_SUPER_TILES + k;
    if (tile >= ct) break;
    walk_visit(r, coef, aabb + 8 * tile, tile, true, baby_eps, eps_succ);
  }
}

// One (ray, tile) pair of the tile plan's slab stage (_plan_prepass_kernel,
// ops/intersect_mxu.py::_pair_slabs): does the live ray enter the tile's
// k = 2 widened box before its t_limit, and its entry clamped at 0.  os:
// recentred origin; inv: inv_dir of the direction.
PTT_HD bool plan_pair(const float* row, V3 os, V3 inv, bool live, float tl, float* key) {
  const Slab s = widen(slab(row, row + 3, os, inv), PTT_SLAB_REL2, PTT_SLAB_ABS2);
  *key = ptt_max(s.lo, 0.0f);
  return slab_enters(s, tl) && live;
}

// ---------------------------------------------------------------------------
// The packet bins (ops/intersect_mxu.py::packet_bins_plain): the per-warp,
// per-tile and per-packet steps of csrc/mesh_bins.cu
// ---------------------------------------------------------------------------

#define PTT_BINS_GP 32  // slots a visit: packets of one 256-ray pair row block

PTT_HD int32_t ptt_popc(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// One warp's ballot of plan_pair over its 32 rays -> which of its 4 packets
// (8 lanes each) enter the tile: bit q for packet q.
PTT_HD uint32_t bins_nibble(uint32_t ballot) {
  uint32_t m = 0;
  for (int q = 0; q < 4; ++q) m |= ((ballot >> (8 * q)) & 0xffu) ? (1u << q) : 0u;
  return m;
}

// A tile's run of slots: its n_c packets rounded up to whole visits (pad_cnt).
PTT_HD int32_t bins_pad(int32_t n_c) {
  return (n_c + PTT_BINS_GP - 1) / PTT_BINS_GP * PTT_BINS_GP;
}

// Visit v's tile: the first c with cum_end[c] > 32 v (searchsorted with
// right=True), -1 at or past the total cum_end[ct - 1].
PTT_HD int32_t bins_visit_tile(const int32_t* cum_end, int32_t ct, int32_t v) {
  const int32_t s = v * PTT_BINS_GP;
  if (s >= cum_end[ct - 1]) return -1;
  int32_t lo = 0, hi = ct - 1;  // cum_end[hi] > s
  while (lo < hi) {
    const int32_t mid = (lo + hi) / 2;
    if (cum_end[mid] > s) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// Packet j (0-31) of a group of 32 in one tile: its slot.  word: bit i set
// where packet i of the group enters the tile; base: the tile's first slot
// plus the packets of the groups before that enter it.
PTT_HD int32_t bins_slot(uint32_t word, int32_t base, int32_t j) {
  return base + ptt_popc(word & ((1u << j) - 1u));
}

// Whether a packet's hit number pos (0-based, in tile order) has its slot
// listed: topk 0 lists every hit (no dst), topk >= ct the dense [n_g, ct]
// dst, else the first topk.
PTT_HD bool bins_listed(int32_t pos, int32_t topk, int32_t ct) {
  return topk == 0 || topk >= ct || pos < topk;
}

// One pair row of a binned visit (_binned_kernel): the ray against one
// tile, (row min, lowest id at it) if that is closer than the ray's
// t_limit, else (inf, -1).
PTT_HD void binned_pair(const float* coef, const float* row, int tile, V3 center, V3 o, V3 d,
                        bool live, float tlim, float baby_eps, float eps_succ, float* t_out,
                        int32_t* tri_out) {
  WalkRay r = walk_ray(center, o, d, live, tlim);
  r.best = ptt_inf();
  walk_visit(r, coef, row, tile, false, baby_eps, eps_succ);
  const bool acc = r.best < tlim;
  *t_out = acc ? r.best : ptt_inf();
  *tri_out = acc ? r.best_tri : -1;
}

// ---------------------------------------------------------------------------
// The mono traversal for one ray (ops/intersect_mxu.py::_mono_kernel)
// ---------------------------------------------------------------------------

// Closest (t, tri) of one ray.  coef: [ct * 1024, 20]; aabb: [ct, 8]
// recentred tile boxes; box: their root_box; center: the recentring
// offset.  An inactive or root-culled ray, or one with no hit closer than
// tlim, gets (tlim, -1).
PTT_HD void mono_ray(const float* coef, const float* aabb, int ct, const float* box, V3 center,
                     V3 o, V3 d, bool active, float tlim, int32_t num_tris, float baby_eps,
                     float eps_succ, float* t_out, int32_t* tri_out) {
  *t_out = tlim;
  *tri_out = -1;
  if (!active) return;
  WalkRay r = walk_ray(center, o, d, true, tlim);
  if (!root_hit(box, r.os, r.inv, tlim)) return;
  r.best = ptt_inf();
  for (int c = 0; c < ct; ++c) walk_visit(r, coef, aabb + 8 * c, c, false, baby_eps, eps_succ);
  if (r.best < tlim) {
    *t_out = r.best;
    *tri_out = r.best_tri >= num_tris ? -1 : r.best_tri;
  }
}

// ---------------------------------------------------------------------------
// The next bounce's prune and sort key (ops/fused.py emit outputs)
// ---------------------------------------------------------------------------

// ops/intersect.py::prim_t_min: nearest analytic-prim t, FLT_MAX for none;
// *win: the prim that gives it by intersect_prims' rule (ascending index, a
// strict "<", so the lowest index wins a tie), -1 for none.  The next
// bounce's shade takes it back (prim_hit_of) instead of testing every prim
// again: the walk between the two leaves the ray's origin and direction as
// they are.
PTT_HD float prim_t_min_win(const PttScene& s, V3 ro, V3 rd, int32_t* win) {
  const PrimNearest p = prim_nearest(s, ro, rd);
  *win = p.win;
  return p.t;
}

// intersect_prims' Hit for a ray whose nearest prim is known to be win
// (prim_t_min_win of the same origin and direction; -1: none): the winner's
// test alone gives the same t and object-space vector bit for bit, since
// its inputs and arithmetic are the same.
PTT_HD Hit prim_hit_of(const PttScene& s, V3 ro, V3 rd, int32_t win) {
  PrimNearest p;
  p.win = win;
  p.t = -1.0f;
  if (win >= 0 && win < s.num_geoms) {
    const PttGeom& g = s.geoms[win];
    p.t = (g.type == 1) ? box_t(g, ro, rd, s.ray_eps, &p.local)
                        : sphere_t(g, ro, rd, s.ray_eps, &p.local);
  }
  return prim_hit(s, rd, p);
}

PTT_HD int32_t morton_spread3(int32_t v) {
  v = (v | (v << 16)) & 0x030000FF;
  v = (v | (v << 8)) & 0x0300F00F;
  v = (v | (v << 4)) & 0x030C30C3;
  v = (v | (v << 2)) & 0x09249249;
  return v;
}

PTT_HD int32_t quant_dir(float d, int32_t dscale) {
  return (int32_t)(ptt_clamp((d + 1.0f) * 0.5f, 0.0f, 1.0f) * (float)dscale);
}

PTT_HD int32_t bit_length(int32_t v) {
  int32_t b = 0;
  while (v > 0) {
    ++b;
    v >>= 1;
  }
  return b;
}

// signature_key for one ray: root mask (box: the tables' root_box), the
// ids of the nearest n_sig candidate tiles by sorted insertion, a direction
// morton, and the three-level layering (live & root < live & prim-only <
// dead).  Any number of tiles.  A ray that is not live (dead, or outside
// the root box) takes no tile: every one of its candidates would be
// INT_MAX, and its key is 1 << 30 or DEAD_KEY whatever they are, so
// skipping the loop gives the same key bit for bit.
PTT_HD int32_t coherence_key(const float* aabb, int ct, const float* box, V3 center, V3 o, V3 d,
                             bool alive, float tlim) {
  const int32_t bits_id = ct > 1 ? (bit_length(ct - 1) > 1 ? bit_length(ct - 1) : 1) : 1;
  const int32_t n_sig = (3 * bits_id <= 30) ? 3 : 2;
  const int32_t dir_total = (30 - n_sig * bits_id) < 6 ? (30 - n_sig * bits_id) : 6;
  const int32_t id_mask = (1 << bits_id) - 1;
  const V3 os = v3(o.x - center.x, o.y - center.y, o.z - center.z);
  const V3 inv = inv_dir(d);
  const bool livem = alive && root_hit(box, os, inv, tlim);
  if (!livem) return alive ? (1 << 30) : ((1 << 30) + 1);
  int32_t tops[3] = {PTT_INT_MAX, PTT_INT_MAX, PTT_INT_MAX};
  for (int c = 0; c < ct; ++c) {
    const float* row = aabb + 8 * c;
    const Slab s = slab(row, row + 3, os, inv);
    const int32_t b = ptt_as_int(ptt_max(s.lo, 0.0f));
    int32_t p = slab_enters(s, tlim) ? ((b & ~id_mask) | c) : PTT_INT_MAX;
    // Static indices (k < 3, guarded) keep tops in registers.
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (k < n_sig) {
        const int32_t lo_k = tops[k] < p ? tops[k] : p;
        p = tops[k] < p ? p : tops[k];
        tops[k] = lo_k;
      }
    }
  }
  int32_t sig = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (k < n_sig) {
      const int32_t idk = tops[k] == PTT_INT_MAX ? id_mask : (tops[k] & id_mask);
      sig = k == 0 ? idk : ((sig << bits_id) | idk);
    }
  }
  if (dir_total >= 3) {
    const int32_t db = dir_total / 3;
    const int32_t dscale = (1 << db) - 1;
    const int32_t dm = morton_spread3(quant_dir(d.x, dscale)) |
                       (morton_spread3(quant_dir(d.y, dscale)) << 1) |
                       (morton_spread3(quant_dir(d.z, dscale)) << 2);
    sig = (sig << (3 * db)) | dm;
  }
  return sig;
}

// ---------------------------------------------------------------------------
// The mesh shade for one ray (ops/fused.py::_mesh_bounce_kernel)
// ---------------------------------------------------------------------------

#define PTT_SHADE_PLAIN 0
#define PTT_SHADE_TEXTURED 1
#define PTT_SHADE_PRECOMPUTED 2

// The shade's prim winner input when none is carried: intersect every prim.
#define PTT_NO_WINNER (-2)

// Floats a row of the tables' attrs_shade: the vertex normals n0 n1 n2
// (0-8), the material (9), v0 e1 e2 (10-18), padding.
#define PTT_SHADE_ROW 24

// The mesh surface of mode PTT_SHADE_PLAIN for one ray (o, d) from its
// walk's winner tri: the row of attrs (rows of them; tri clamped into
// them), (u, v) by ops/intersect_mxu.py::winner_uv_from_geom's
// Moller-Trumbore, the vertex normal interpolated with w = 1 - u - v and
// normalized into *mn.  Returns the material; -1 for tri < 0 (no mesh hit:
// no row read, *mn untouched).  76 bytes of the row are read.
PTT_HD int32_t mesh_surface(const float* attrs, int32_t rows, int32_t tri, V3 o, V3 d,
                            float baby_eps, V3* mn) {
  if (tri < 0) return -1;
  const float* r = attrs + (size_t)(tri < rows ? tri : rows - 1) * PTT_SHADE_ROW;
  const V3 v0 = v3(r[10], r[11], r[12]);
  const V3 e1 = v3(r[13], r[14], r[15]);
  const V3 e2 = v3(r[16], r[17], r[18]);
  const V3 pvec = cross(d, e2);
  const float det = dot(e1, pvec);
  const float inv_det = 1.0f / (fabsf(det) >= baby_eps ? det : 1.0f);
  const V3 tvec = o - v0;
  const float u = dot(tvec, pvec) * inv_det;
  const V3 qvec = cross(tvec, e1);
  const float v = dot(d, qvec) * inv_det;
  const float w = 1.0f - u - v;
  *mn = normalize(v3(r[0], r[1], r[2]) * w + v3(r[3], r[4], r[5]) * u +
                  v3(r[6], r[7], r[8]) * v);
  return (int32_t)r[9];
}

// One ray of the shade kernel; dead rays are left untouched.  The uniforms
// of this pixel are drawn inline at counters j * rng_n + pixel.
// mode PTT_SHADE_PLAIN: prim intersect, merged with the mesh hit (mt, the
//   interpolated normal mn flipped toward the ray, material mmat, as
//   mesh_surface resolves them; mmat < 0 = no mesh hit), scatter with the
//   material's color.
// mode PTT_SHADE_TEXTURED: the same merge, but mn is the final shading
//   normal (not flipped) and a mesh lane scatters with the albedo malb.
// mode PTT_SHADE_PRECOMPUTED: no prim intersection; (mt, mn, mmat, malb) is
//   the lane's resolved surface (t = -1 for a miss).
// In the first two modes a mesh hit is closer than every prim (the walk ran
// below the prim t), so such a lane tests no prim; a lane without one takes
// its prim hit from the carried winner prim_win (prim_hit_of), or, given
// PTT_NO_WINNER, from every prim (intersect_prims).
PTT_HD void mesh_shade_ray(const PttScene& s, Ray& ray, float mt, V3 mn, int32_t mmat, int mode,
                           V3 malb, uint32_t k0, uint32_t k1, uint32_t rng_n, int32_t pixel,
                           int32_t prim_win) {
  if (ray.bounces <= 0) return;
  Hit h;
  bool given_albedo = mode == PTT_SHADE_PRECOMPUTED;
  if (mode == PTT_SHADE_PRECOMPUTED) {
    h.t = mt;
    h.normal = mn;
    h.material_id = mmat;
  } else if (mmat >= 0) {
    if (mode == PTT_SHADE_PLAIN && dot(ray.d, mn) > 0.0f) mn = -mn;
    h.t = mt;
    h.normal = mn;
    h.material_id = mmat;
    given_albedo = mode == PTT_SHADE_TEXTURED;
  } else {
    h = prim_win == PTT_NO_WINNER ? intersect_prims(s, ray.o, ray.d)
                                  : prim_hit_of(s, ray.o, ray.d, prim_win);
  }
  const uint32_t px = (uint32_t)pixel;
  const float u0 = uniform_at(k0, k1, px);
  const float u1 = uniform_at(k0, k1, rng_n + px);
  const float u2 = uniform_at(k0, k1, 2u * rng_n + px);
  scatter(s, ray, h, u0, u1, u2, given_albedo ? &malb : nullptr);
}
