// Per-ray bodies of the two mesh kernels in fused_mesh.cu.
//
// Each function is the per-ray form of a torch function of the port (and so
// of the JAX package), written operation for operation in the same order:
//   mono_ray        = ops/intersect_mxu.py::mono_intersect_plain (the root
//                     cull, the per-tile member slab, _mt_hit, the
//                     lowest-id tie rule);
//   coherence_key   = ops/intersect_mxu.py::coherence_key_planes;
//   prim_t_min      = ops/intersect.py::prim_t_min;
//   mesh_shade_ray  = ops/fused.py::fused_mesh_shade_plain (prim intersect,
//                     merge with the mesh hit, scatter, inline uniforms).
// The prim intersection, scatter and Threefry come from prim_path.cuh.
// Build with --fmad=false and without fast math, as prim_path.cuh says; the
// only fused multiply-adds are the explicit fmaf chains of the numerators,
// which the plain version reproduces with ops/intersect_mxu.py::fma32.

#pragma once

#include "prim_path.cuh"

#define PTT_TRI_TILE 1024
#define PTT_COEF_W 20       // coefficients per triangle row (19 used)
#define PTT_MONO_MAX_TILES 8
#define PTT_KEY_MAX_CT 24   // ops/intersect_mxu.py::KEY_INLINE_MAX_CT
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

// root_hit_mask: the envelope of the tile boxes, k = 2 widening.
PTT_HD bool root_hit(const float* aabb, int ct, V3 os, V3 inv, float tlim) {
  float lo[3], hi[3];
  for (int a = 0; a < 3; ++a) {
    lo[a] = aabb[a];
    hi[a] = aabb[3 + a];
  }
  for (int c = 1; c < ct; ++c) {
    for (int a = 0; a < 3; ++a) {
      lo[a] = ptt_min(lo[a], aabb[8 * c + a]);
      hi[a] = ptt_max(hi[a], aabb[8 * c + 3 + a]);
    }
  }
  return slab_enters(widen(slab(lo, hi, os, inv), PTT_SLAB_REL2, PTT_SLAB_ABS2), tlim);
}

// ---------------------------------------------------------------------------
// The mono traversal for one ray (ops/intersect_mxu.py::_mono_kernel)
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

// Closest (t, tri) of one ray.  coef: [ct * 1024, 20]; aabb: [ct, 8]
// recentred tile boxes; center: the recentring offset.  An inactive or
// root-culled ray, or one with no hit closer than tlim, gets (tlim, -1).
PTT_HD void mono_ray(const float* coef, const float* aabb, int ct, V3 center, V3 o, V3 d,
                     bool active, float tlim, int32_t num_tris, float baby_eps,
                     float eps_succ, float* t_out, int32_t* tri_out) {
  *t_out = tlim;
  *tri_out = -1;
  if (!active) return;
  const V3 os = v3(o.x - center.x, o.y - center.y, o.z - center.z);
  const V3 inv = inv_dir(d);
  if (!root_hit(aabb, ct, os, inv, tlim)) return;
  // The ray's features in _run's order: d, o x d, o, 1.
  const float f[10] = {
      d.x, d.y, d.z,
      os.y * d.z - os.z * d.y, os.z * d.x - os.x * d.z, os.x * d.y - os.y * d.x,
      os.x, os.y, os.z, 1.0f,
  };
  float best = ptt_inf();
  int32_t best_tri = 0;
  for (int c = 0; c < ct; ++c) {
    const float* row = aabb + 8 * c;
    const Slab s = widen(slab(row, row + 3, os, inv), PTT_SLAB_REL1, PTT_SLAB_ABS1);
    if (!slab_enters(s, tlim)) continue;  // not a candidate tile for this ray
    const float t_lo = ptt_max(s.lo, eps_succ);
    const float t_hi = s.hi;
    const float* cf = coef + (size_t)c * PTT_TRI_TILE * PTT_COEF_W;
    for (int j = 0; j < PTT_TRI_TILE; ++j, cf += PTT_COEF_W) {
      float k[PTT_COEF_W];
      load_coef(cf, k);
      // Numerators: fused multiply-add chains in ascending feature order.
      float det = 0.0f, un = 0.0f, vn = 0.0f, tn = 0.0f;
#pragma unroll
      for (int q = 0; q < 3; ++q) det = fmaf(f[q], k[q], det);
#pragma unroll
      for (int q = 0; q < 6; ++q) un = fmaf(f[q], k[3 + q], un);
#pragma unroll
      for (int q = 0; q < 6; ++q) vn = fmaf(f[q], k[9 + q], vn);
#pragma unroll
      for (int q = 0; q < 4; ++q) tn = fmaf(f[6 + q], k[15 + q], tn);
      // _mt_hit: the sign of det XORed into u and v, |det| for the sum.
      const float abs_det = fabsf(det);
      const bool det_ok = abs_det >= baby_eps;
      const float inv_det = 1.0f / (det_ok ? det : 1.0f);
      const float tt = tn * inv_det;
      const int32_t sign = ptt_as_int(det) & INT32_MIN;
      const float us = ptt_as_float(ptt_as_int(un) ^ sign);
      const float vs = ptt_as_float(ptt_as_int(vn) ^ sign);
      const bool hit = det_ok && (ptt_min(us, vs) >= 0.0f) && (us + vs <= abs_det) &&
                       (tt >= t_lo) && (tt <= t_hi);
      // Ascending ids and a strict < keep the lowest id on a tie.
      if (hit && tt < best) {
        best = tt;
        best_tri = c * PTT_TRI_TILE + j;
      }
    }
  }
  if (best < tlim) {
    *t_out = best;
    *tri_out = best_tri >= num_tris ? -1 : best_tri;
  }
}

// ---------------------------------------------------------------------------
// The next bounce's prune and sort key (ops/fused.py emit outputs)
// ---------------------------------------------------------------------------

// ops/intersect.py::prim_t_min: nearest analytic-prim t, FLT_MAX for none.
PTT_HD float prim_t_min(const PttScene& s, V3 ro, V3 rd) {
  float t_min = PTT_FLT_MAX;
  for (int i = 0; i < s.num_geoms; ++i) {
    const PttGeom& g = s.geoms[i];
    V3 local;
    const float t = (g.type == 1) ? box_t(g, ro, rd, s.ray_eps, &local)
                                  : sphere_t(g, ro, rd, s.ray_eps, &local);
    t_min = ptt_min(t_min, (t > 0.0f) ? t : PTT_FLT_MAX);
  }
  return t_min;
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

// coherence_key_planes for one ray: root mask, the ids of the nearest
// n_sig candidate tiles by sorted insertion, a direction morton, and the
// three-level layering (live & root < live & prim-only < dead).
PTT_HD int32_t coherence_key(const float* aabb, int ct, V3 center, V3 o, V3 d, bool alive,
                             float tlim) {
  const int32_t bits_id = ct > 1 ? (bit_length(ct - 1) > 1 ? bit_length(ct - 1) : 1) : 1;
  const int32_t n_sig = (3 * bits_id <= 30) ? 3 : 2;
  const int32_t dir_total = (30 - n_sig * bits_id) < 6 ? (30 - n_sig * bits_id) : 6;
  const int32_t id_mask = (1 << bits_id) - 1;
  const V3 os = v3(o.x - center.x, o.y - center.y, o.z - center.z);
  const V3 inv = inv_dir(d);
  const bool livem = alive && root_hit(aabb, ct, os, inv, tlim);
  int32_t tops[3] = {PTT_INT_MAX, PTT_INT_MAX, PTT_INT_MAX};
  for (int c = 0; c < ct; ++c) {
    const float* row = aabb + 8 * c;
    const Slab s = slab(row, row + 3, os, inv);
    const bool hit = slab_enters(s, tlim) && livem;
    const int32_t b = ptt_as_int(ptt_max(s.lo, 0.0f));
    int32_t p = hit ? ((b & ~id_mask) | c) : PTT_INT_MAX;
    for (int k = 0; k < n_sig; ++k) {
      const int32_t lo_k = tops[k] < p ? tops[k] : p;
      p = tops[k] < p ? p : tops[k];
      tops[k] = lo_k;
    }
  }
  int32_t sig = 0;
  for (int k = 0; k < n_sig; ++k) {
    const int32_t idk = tops[k] == PTT_INT_MAX ? id_mask : (tops[k] & id_mask);
    sig = k == 0 ? idk : ((sig << bits_id) | idk);
  }
  if (dir_total >= 3) {
    const int32_t db = dir_total / 3;
    const int32_t dscale = (1 << db) - 1;
    const int32_t dm = morton_spread3(quant_dir(d.x, dscale)) |
                       (morton_spread3(quant_dir(d.y, dscale)) << 1) |
                       (morton_spread3(quant_dir(d.z, dscale)) << 2);
    sig = (sig << (3 * db)) | dm;
  }
  const int32_t key = livem ? sig : (1 << 30);
  return alive ? key : ((1 << 30) + 1);
}

// ---------------------------------------------------------------------------
// The mesh shade for one ray (ops/fused.py::_mesh_bounce_kernel, "plain")
// ---------------------------------------------------------------------------

// Prim intersect, merge with the mesh hit (mt, interpolated normal mn,
// material mmat; mmat < 0 = no mesh hit), scatter with the uniforms of
// this pixel drawn inline at counters j * rng_n + pixel.  A dead ray is
// left untouched.
PTT_HD void mesh_shade_ray(const PttScene& s, Ray& ray, float mt, V3 mn, int32_t mmat,
                           uint32_t k0, uint32_t k1, uint32_t rng_n, int32_t pixel) {
  if (ray.bounces <= 0) return;
  Hit h = intersect_prims(s, ray.o, ray.d);
  if (mmat >= 0) {  // the traversal ran below the prim t: the mesh is closer
    if (dot(ray.d, mn) > 0.0f) mn = -mn;
    h.t = mt;
    h.normal = mn;
    h.material_id = mmat;
  }
  const uint32_t px = (uint32_t)pixel;
  const float u0 = uniform_at(k0, k1, px);
  const float u1 = uniform_at(k0, k1, rng_n + px);
  const float u2 = uniform_at(k0, k1, 2u * rng_n + px);
  scatter(s, ray, h, u0, u1, u2);
}
