// Per-ray path-tracing body shared by the two kernels in fused_prim.cu.
//
// Every function here is the per-ray form of a torch function of the port
// (and so of the JAX package), written operation for operation in the same
// order: raygen = ops/camera.py::generate_camera_rays, box/sphere
// intersection and the nearest-hit loop = ops/intersect.py, the lobes =
// ops/bsdf.py, scatter = ops/shade.py::scatter_compose, the RNG =
// utils/prng.py.  Build with --fmad=false and without fast math, so each
// multiply and add rounds on its own, as the unfused torch ops do; use
// cosf/sinf/sqrtf and a true division, never __cosf/__sinf/rsqrtf.
//
// Differences in form, not in value:
// * The torch path evaluates every lobe the scene uses for every lane and
//   selects by mask; here each ray branches to the lobe it selects.
// * A ray that is dead (bounces == 0) is left untouched at once; the torch
//   path computes its intersection and throws it away.
// * The torch path folds zero and unit transform coefficients at trace
//   time (utils/vec.py::_row_dot); here the same folding is a branch on the
//   coefficient, uniform across the warp.

#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

// The body compiles for the card (nvcc) and for the host (a C++ compiler),
// so the CPU tests can run it against the plain torch path.
#if defined(__CUDACC__)
#define PTT_HD __host__ __device__ __forceinline__
#else
#define PTT_HD inline
#endif

// float32 values of the JAX package's constants (utils/mathutil.py), written
// exactly.
#define PTT_PI 0x1.921fb6p+1f
#define PTT_TWO_PI 0x1.921fb6p+2f
#define PTT_PI_OVER_FOUR 0x1.921fb6p-1f
#define PTT_PI_OVER_TWO 0x1.921fb6p+0f
#define PTT_INV_PI 0x1.45f306p-2f
// float32(1) / float32(PI): ``x / PI`` is evaluated as ``x * PTT_RCP_PI``
// (ops/bsdf.py::RCP_PI).
#define PTT_RCP_PI 0x1.45f306p-2f
#define PTT_FLT_MAX 0x1.fffffep+127f
#define PTT_BIG 0x1.2ced32p+126f     // float32(1e38)
#define PTT_1EM12 0x1.197998p-40f    // float32(1e-12)
#define PTT_1EM6 0x1.0c6f7ap-20f     // float32(1e-6)
#define PTT_F0_DIELECTRIC 0x1.47ae14p-5f  // float32(0.04)

// ---------------------------------------------------------------------------
// Scene constants.  The Python side mirrors the layout with ctypes
// (ops/kernels.py) and checks it against ptt_abi().  The primitive and
// material tables have any length: the scene holds their counts and two
// pointers, into device memory for the kernels (ops/fused.py::_scene_buffer
// uploads header and tables as one buffer) and into host memory for the host
// build of the tests.
// ---------------------------------------------------------------------------

struct PttGeom {
  int32_t type;  // GeomType: 0 = sphere, 1 = cube
  int32_t material_id;
  float inverse[12];  // rows 0..2 of the 4x4: three coefficients, then bias
  float transform[12];
  float inv_transpose[12];
};

struct PttMaterial {
  float color[3];
  float emittance;
  float has_reflective;
  float has_refractive;
  float ior;
  float roughness;
  float metallic;
};

struct PttScene {
  int32_t num_geoms;
  int32_t num_materials;
  int32_t lobe_glass;
  int32_t lobe_mirror;
  int32_t lobe_trans;
  int32_t lobe_micro;
  float baby_eps;
  float larger_eps;
  float ray_eps;
  int32_t pad;
  const PttGeom* geoms;          // [num_geoms]
  const PttMaterial* materials;  // [num_materials]
};

struct PttCamera {
  float position[3];
  float view[3];
  float up[3];
  float right[3];
  float pixel_length[2];
  float aperture;
  float focal_dist;
};

// ---------------------------------------------------------------------------
// Scalar helpers
// ---------------------------------------------------------------------------

// torch.maximum / torch.minimum propagate NaN; fmaxf / fminf do not.
PTT_HD float ptt_max(float a, float b) {
  return (a != a || b != b) ? (a + b) : fmaxf(a, b);
}
PTT_HD float ptt_min(float a, float b) {
  return (a != a || b != b) ? (a + b) : fminf(a, b);
}
PTT_HD float ptt_clamp(float x, float lo, float hi) {
  return ptt_min(ptt_max(x, lo), hi);
}

struct V3 {
  float x, y, z;
};

PTT_HD V3 v3(float x, float y, float z) { return V3{x, y, z}; }
PTT_HD V3 operator+(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
PTT_HD V3 operator-(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
PTT_HD V3 operator*(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
PTT_HD V3 operator*(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
PTT_HD V3 operator-(V3 a) { return v3(-a.x, -a.y, -a.z); }
PTT_HD float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
PTT_HD V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
PTT_HD float length(V3 a) { return sqrtf(dot(a, a)); }
PTT_HD V3 normalize(V3 a) {
  float inv = 1.0f / sqrtf(dot(a, a));
  return v3(a.x * inv, a.y * inv, a.z * inv);
}
PTT_HD V3 reflect(V3 i, V3 n) {
  float d = dot(n, i);
  return i - n * (2.0f * d);
}
PTT_HD V3 sel(bool m, V3 a, V3 b) { return m ? a : b; }

// utils/vec.py::_row_dot: drop 0.0 coefficients, pass +-1.0 through, start
// from the first kept term, add left to right, drop a 0.0 bias.
PTT_HD float row_dot(const float* r, V3 p, bool with_bias) {
  const float t[3] = {p.x, p.y, p.z};
  float acc = 0.0f;
  bool has = false;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float c = r[k];
    if (c == 0.0f) continue;
    const float term = (c == 1.0f) ? t[k] : ((c == -1.0f) ? -t[k] : t[k] * c);
    acc = has ? acc + term : term;
    has = true;
  }
  if (with_bias && r[3] != 0.0f) {
    acc = has ? acc + r[3] : r[3];
    has = true;
  }
  return has ? acc : 0.0f;
}
PTT_HD V3 xform_point(const float* m, V3 p) {
  return v3(row_dot(m, p, true), row_dot(m + 4, p, true), row_dot(m + 8, p, true));
}
PTT_HD V3 xform_vector(const float* m, V3 p) {
  return v3(row_dot(m, p, false), row_dot(m + 4, p, false), row_dot(m + 8, p, false));
}

// ---------------------------------------------------------------------------
// RNG: Threefry-2x32 at counter (0, flat), bits b0 ^ b1 (utils/prng.py)
// ---------------------------------------------------------------------------

PTT_HD uint32_t ptt_rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

#define PTT_TF_ROUND(r) \
  x0 += x1;             \
  x1 = ptt_rotl(x1, r); \
  x1 ^= x0;

// Both output words at counter (0, flat).
PTT_HD void threefry2x32(uint32_t k0, uint32_t k1, uint32_t flat, uint32_t* y0, uint32_t* y1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = k0;  // counter hi word is 0
  uint32_t x1 = flat + k1;
  PTT_TF_ROUND(13) PTT_TF_ROUND(15) PTT_TF_ROUND(26) PTT_TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  PTT_TF_ROUND(17) PTT_TF_ROUND(29) PTT_TF_ROUND(16) PTT_TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  PTT_TF_ROUND(13) PTT_TF_ROUND(15) PTT_TF_ROUND(26) PTT_TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  PTT_TF_ROUND(17) PTT_TF_ROUND(29) PTT_TF_ROUND(16) PTT_TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  PTT_TF_ROUND(13) PTT_TF_ROUND(15) PTT_TF_ROUND(26) PTT_TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
  *y0 = x0;
  *y1 = x1;
}

PTT_HD uint32_t threefry_bits(uint32_t k0, uint32_t k1, uint32_t flat) {
  uint32_t y0, y1;
  threefry2x32(k0, k1, flat, &y0, &y1);
  return y0 ^ y1;
}

// prng.stage_key(iter_key, depth, 1): fold_in(fold_in(iter_key, depth), 1),
// a fold being the two words at counter (0, data) under the key.
PTT_HD void shade_stage_key(uint32_t ik0, uint32_t ik1, uint32_t depth, uint32_t* k0,
                            uint32_t* k1) {
  uint32_t d0, d1;
  threefry2x32(ik0, ik1, depth, &d0, &d1);
  threefry2x32(d0, d1, 1u, k0, k1);
}

// bits_to_uniform: mantissa of a float in [1, 2), minus 1, max(0, u).
PTT_HD float uniform_at(uint32_t k0, uint32_t k1, uint32_t flat) {
  const uint32_t bits = threefry_bits(k0, k1, flat);
  const uint32_t mant = (bits >> 9) | 0x3F800000u;
#if defined(__CUDA_ARCH__)
  const float one_two = __uint_as_float(mant);
#else
  float one_two;
  memcpy(&one_two, &mant, sizeof(one_two));
#endif
  const float u = one_two - 1.0f;
  return ptt_max(0.0f, u);
}

// Element flat of the [k, ln] block drawn at pixels [base, base + ln) of an
// rng_n-pixel stream: row j = flat / ln, pixel base + flat % ln, counter
// j * rng_n + base + i (prng.uniforms_at(key, base + arange(ln), k, rng_n)).
// base 0 and rng_n == ln give counter flat, the unsharded draw.
PTT_HD float uniform_block(uint32_t k0, uint32_t k1, uint32_t ln, uint32_t base,
                           uint32_t rng_n, uint32_t flat) {
  const uint32_t j = flat / ln;
  return uniform_at(k0, k1, j * rng_n + base + (flat - j * ln));
}

// ---------------------------------------------------------------------------
// Ray state
// ---------------------------------------------------------------------------

struct Ray {
  V3 o, d, c;  // origin, direction, throughput
  int32_t bounces;
};

// ops/camera.py::generate_camera_rays for one pixel; u = 4 uniforms.
PTT_HD Ray raygen(const PttCamera& cam, int width, int height,
                                      int depth, int idx, const float u[4]) {
  const float x = (float)(idx % width);
  const float y = (float)(idx / width);
  const float sx = cam.pixel_length[0] * (x + u[0] - (float)width * 0.5f);
  const float sy = cam.pixel_length[1] * (y + u[1] - (float)height * 0.5f);
  const V3 pp = v3(cam.view[0] - cam.right[0] * sx - cam.up[0] * sy,
                   cam.view[1] - cam.right[1] * sx - cam.up[1] * sy,
                   cam.view[2] - cam.right[2] * sx - cam.up[2] * sy);
  const V3 ray_dir = normalize(pp);
  const V3 pos = v3(cam.position[0], cam.position[1], cam.position[2]);
  const V3 focal = pos + ray_dir * cam.focal_dist;
  const float r = cam.aperture * sqrtf(u[2]);
  const float theta = PTT_TWO_PI * u[3];
  Ray ray;
  ray.o = v3(pos.x + r * cosf(theta), pos.y + r * sinf(theta), pos.z);
  ray.d = normalize(focal - ray.o);
  ray.c = v3(1.0f, 1.0f, 1.0f);
  ray.bounces = depth;
  return ray;
}

// ---------------------------------------------------------------------------
// Intersection (ops/intersect.py)
// ---------------------------------------------------------------------------

PTT_HD float comp(V3 v, int a) { return a == 0 ? v.x : (a == 1 ? v.y : v.z); }

// box_intersection: returns t_world (-1 = miss) and the object-space normal
// (the world normal is computed only for the nearest hit).
PTT_HD float box_t(const PttGeom& g, V3 ro, V3 rd, float ray_eps, V3* n_obj_out) {
  const V3 qo = xform_point(g.inverse, ro);
  const V3 qd = normalize(xform_vector(g.inverse, rd));
  float tmin = -PTT_BIG, tmax = PTT_BIG;
  V3 tmin_n = v3(0.0f, 0.0f, 0.0f), tmax_n = v3(0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
    const float o = comp(qo, axis), d = comp(qd, axis);
    const float inv = 1.0f / d;
    const float t1 = (-0.5f - o) * inv;
    const float t2 = (0.5f - o) * inv;
    const float ta = ptt_min(t1, t2);
    const float tb = ptt_max(t1, t2);
    const float sign = (t2 < t1) ? 1.0f : -1.0f;
    const V3 n = v3(axis == 0 ? sign : 0.0f, axis == 1 ? sign : 0.0f, axis == 2 ? sign : 0.0f);
    if ((ta > 0.0f) && (ta > tmin)) {
      tmin = ta;
      tmin_n = n;
    }
    if (tb < tmax) {
      tmax = tb;
      tmax_n = n;
    }
  }
  const bool hit = (tmax >= tmin) && (tmax > 0.0f);
  const bool inside = tmin <= 0.0f;
  const float t_obj = inside ? tmax : tmin;
  *n_obj_out = inside ? tmax_n : tmin_n;
  const V3 p_obj = qo + qd * (t_obj - ray_eps);
  const V3 p_world = xform_point(g.transform, p_obj);
  const float t_world = length(ro - p_world);
  return hit ? t_world : -1.0f;
}

// sphere_intersection: returns t_world (-1 = miss) and the object-space hit
// point, whose inverse-transpose image is the normal.
PTT_HD float sphere_t(const PttGeom& g, V3 ro, V3 rd, float ray_eps, V3* p_obj_out) {
  const V3 o = xform_point(g.inverse, ro);
  const V3 d = normalize(xform_vector(g.inverse, rd));
  const float v_dot_d = dot(o, d);
  const float radicand = v_dot_d * v_dot_d - (dot(o, o) - 0.25f);
  const bool has_root = radicand >= 0.0f;
  const float sq = sqrtf(ptt_max(radicand, 0.0f));
  const float t1 = -v_dot_d + sq;
  const float t2 = -v_dot_d - sq;
  const bool both_neg = (t1 < 0.0f) && (t2 < 0.0f);
  const bool both_pos = (t1 > 0.0f) && (t2 > 0.0f);
  const float t_obj = both_pos ? ptt_min(t1, t2) : ptt_max(t1, t2);
  const bool hit = has_root && !both_neg;
  const V3 p_obj = o + d * (t_obj - ray_eps);
  *p_obj_out = p_obj;
  const V3 p_world = xform_point(g.transform, p_obj);
  const float t_world = length(ro - p_world);
  return hit ? t_world : -1.0f;
}

struct Hit {
  float t;  // -1 = miss
  V3 normal;  // flipped toward the ray
  int32_t material_id;
};

// intersect_scene over the analytic prims.
PTT_HD Hit intersect_prims(const PttScene& s, V3 ro, V3 rd) {
  float t_min = PTT_FLT_MAX;
  bool hit_any = false;
  V3 normal = v3(0.0f, 0.0f, 0.0f);
  int32_t mat = -1;
  for (int i = 0; i < s.num_geoms; ++i) {
    const PttGeom& g = s.geoms[i];
    V3 local;
    const float t = (g.type == 1) ? box_t(g, ro, rd, s.ray_eps, &local)
                                  : sphere_t(g, ro, rd, s.ray_eps, &local);
    if ((t > 0.0f) && (t < t_min)) {
      t_min = t;
      hit_any = true;
      normal = normalize(xform_vector(g.inv_transpose, local));
      mat = g.material_id;
    }
  }
  if (dot(rd, normal) > 0.0f) normal = -normal;
  Hit h;
  h.t = hit_any ? t_min : -1.0f;
  h.normal = normal;
  h.material_id = hit_any ? mat : 0;
  return h;
}

// The same nearest hit in two steps, the winner's normal computed once after
// the loop instead of at each closer prim: lanes of one warp that find
// their closer prims at different indices (paths at different depths) do
// not take turns at the normalization.  prim_nearest is the loop; prim_hit
// turns its result into intersect_prims' Hit bit for bit (the winner's
// normal from the winner's own object-space vector, the flip, the material;
// win -1: t = -1, a zero normal, material 0).
struct PrimNearest {
  float t;      // FLT_MAX with no prim hit (ops/intersect.py::prim_t_min)
  int32_t win;  // the first prim at that t, -1 for none
  V3 local;     // its box_t / sphere_t object-space vector
};

PTT_HD PrimNearest prim_nearest(const PttScene& s, V3 ro, V3 rd) {
  PrimNearest p;
  p.t = PTT_FLT_MAX;
  p.win = -1;
  p.local = v3(0.0f, 0.0f, 0.0f);
  for (int i = 0; i < s.num_geoms; ++i) {
    const PttGeom& g = s.geoms[i];
    V3 local;
    const float t = (g.type == 1) ? box_t(g, ro, rd, s.ray_eps, &local)
                                  : sphere_t(g, ro, rd, s.ray_eps, &local);
    const bool closer = (t > 0.0f) && (t < p.t);
    p.t = closer ? t : p.t;
    p.win = closer ? i : p.win;
    p.local = closer ? local : p.local;
  }
  return p;
}

PTT_HD Hit prim_hit(const PttScene& s, V3 rd, const PrimNearest& p) {
  Hit h;
  h.t = -1.0f;
  h.normal = v3(0.0f, 0.0f, 0.0f);
  h.material_id = 0;
  if (p.win < 0 || p.win >= s.num_geoms) return h;
  const PttGeom& g = s.geoms[p.win];
  h.t = p.t;
  h.normal = normalize(xform_vector(g.inv_transpose, p.local));
  if (dot(rd, h.normal) > 0.0f) h.normal = -h.normal;
  h.material_id = g.material_id;
  return h;
}

// ---------------------------------------------------------------------------
// BSDF lobes (ops/bsdf.py)
// ---------------------------------------------------------------------------

PTT_HD void coordinate_system(V3 n, V3* tan, V3* bit) {
  const bool use_x = fabsf(n.x) > fabsf(n.y);
  const float inv_a = 1.0f / sqrtf(use_x ? n.x * n.x + n.z * n.z : n.y * n.y + n.z * n.z);
  *tan = use_x ? v3(-n.z * inv_a, 0.0f, n.x * inv_a) : v3(0.0f, n.z * inv_a, -n.y * inv_a);
  *bit = cross(n, *tan);
}

PTT_HD V3 local_to_world(V3 n, V3 w) {
  V3 tan, bit;
  coordinate_system(n, &tan, &bit);
  return tan * w.x + bit * w.y + n * w.z;
}

PTT_HD V3 world_to_local(V3 n, V3 w) {
  V3 tan, bit;
  coordinate_system(n, &tan, &bit);
  return v3(dot(tan, w), dot(bit, w), dot(n, w));
}

PTT_HD V3 square_to_hemisphere_cosine(float xi0, float xi1) {
  const float a = 2.0f * xi0 - 1.0f;
  const float b = 2.0f * xi1 - 1.0f;
  const bool a_wins = (a * a) > (b * b);
  const float safe_a = (a == 0.0f) ? 1.0f : a;
  const float safe_b = (b == 0.0f) ? 1.0f : b;
  const float radius = a_wins ? a : b;
  const float theta = a_wins ? PTT_PI_OVER_FOUR * (b / safe_a)
                             : PTT_PI_OVER_TWO - PTT_PI_OVER_FOUR * (a / safe_b);
  const bool center = (a == 0.0f) && (b == 0.0f);
  const float dx = center ? 0.0f : radius * cosf(theta);
  const float dy = center ? 0.0f : radius * sinf(theta);
  const float z = sqrtf(ptt_max(1.0f - dx * dx - dy * dy, 0.0f));
  return v3(dx, dy, z);
}

struct Lobe {
  V3 wi, f;
  float pdf;
};

PTT_HD Lobe sample_diffuse(V3 albedo, V3 n, float xi0, float xi1) {
  const V3 wl = square_to_hemisphere_cosine(xi0, xi1);
  Lobe s;
  s.wi = normalize(local_to_world(n, wl));
  s.pdf = wl.z * PTT_RCP_PI;
  s.f = albedo * PTT_INV_PI;
  return s;
}

PTT_HD V3 refract(V3 i, V3 n, float eta) {
  const float cosi = dot(n, i);
  const float k = 1.0f - eta * eta * (1.0f - cosi * cosi);
  const float kc = sqrtf(ptt_max(k, 0.0f));
  const V3 out = i * eta - n * (eta * cosi + kc);
  return (k < 0.0f) ? v3(0.0f, 0.0f, 0.0f) : out;
}

// sample_f_specular_transmission: wi and whether it was TIR (black bsdf).
PTT_HD V3 sample_transmission(V3 n, V3 wo, float ior, float baby_eps, bool* tir) {
  const bool entering = dot(wo, n) < 0.0f;
  const float eta = entering ? 1.0f / ior : ior;
  const V3 out_n = entering ? n : -n;
  const V3 wt = refract(normalize(wo), normalize(out_n), eta);
  *tir = length(wt) < baby_eps;
  return *tir ? reflect(wo, n) : wt;
}

PTT_HD float fresnel_dielectric(float cos_theta_i, float ior) {
  float cos_i = ptt_clamp(cos_theta_i, -1.0f, 1.0f);
  const bool swap = cos_i > 0.0f;
  const float eta_i = swap ? ior : 1.0f;
  const float eta_t = swap ? 1.0f : ior;
  cos_i = fabsf(cos_i);
  const float sin_i = sqrtf(ptt_max(1.0f - cos_i * cos_i, 0.0f));
  const float sin_t = eta_i / eta_t * sin_i;
  const float cos_t = sqrtf(ptt_max(1.0f - sin_t * sin_t, 0.0f));
  const float r_parl = (eta_t * cos_i - eta_i * cos_t) / (eta_t * cos_i + eta_i * cos_t);
  const float r_perp = (eta_i * cos_i - eta_t * cos_t) / (eta_i * cos_i + eta_t * cos_t);
  return (r_parl * r_parl + r_perp * r_perp) * 0.5f;
}

PTT_HD float pow5(float x) {
  const float x2 = x * x;
  return x * (x2 * x2);
}

PTT_HD V3 fresnel_schlick(float cos_theta, V3 f0) {
  const float p = pow5(1.0f - cos_theta);
  return v3(f0.x + (1.0f - f0.x) * p, f0.y + (1.0f - f0.y) * p, f0.z + (1.0f - f0.z) * p);
}

PTT_HD V3 f0_of(V3 albedo, float metallic) {
  const float c = PTT_F0_DIELECTRIC;
  return v3(c + (albedo.x - c) * metallic, c + (albedo.y - c) * metallic,
            c + (albedo.z - c) * metallic);
}

PTT_HD float trowbridge_reitz_d(V3 wh, float r) {
  const float cos2 = wh.z * wh.z;
  const float sin2 = ptt_max(1.0f - cos2, 0.0f);
  const float safe_cos2 = (cos2 == 0.0f) ? 1.0f : cos2;
  const float tan2 = sin2 / safe_cos2;
  const float cos4 = cos2 * cos2;
  const float r2 = r * r;
  const float e = tan2 / r2;
  const float d = 1.0f / (PTT_PI * r2 * cos4 * (1.0f + e) * (1.0f + e));
  return (cos2 == 0.0f) ? 0.0f : d;
}

PTT_HD float ggx_lambda(V3 w, float r) {
  const float cos2 = w.z * w.z;
  const float sin2 = ptt_max(1.0f - cos2, 0.0f);
  const float safe_cos = (cos2 == 0.0f) ? 1.0f : fabsf(w.z);
  const float abs_tan = sqrtf(sin2) / safe_cos;
  const float rt = r * abs_tan;
  const float lam = (-1.0f + sqrtf(1.0f + rt * rt)) * 0.5f;
  return (cos2 == 0.0f) ? 0.0f : lam;
}

PTT_HD V3 f_microfacet_refl(V3 albedo, V3 wo, V3 wi, float r, float metallic) {
  const float cos_o = fabsf(wo.z);
  const float cos_i = fabsf(wi.z);
  V3 wh = wi + wo;
  const float wh_len = length(wh);
  const bool degenerate = (cos_i == 0.0f) || (cos_o == 0.0f) || (wh_len == 0.0f);
  const float div = (wh_len == 0.0f) ? 1.0f : wh_len;
  wh = v3(wh.x / div, wh.y / div, wh.z / div);
  const V3 f = fresnel_schlick(dot(wi, wh), f0_of(albedo, metallic));
  const float d = trowbridge_reitz_d(wh, r);
  const float g = 1.0f / (1.0f + ggx_lambda(wo, r) + ggx_lambda(wi, r));
  const float denom = degenerate ? 1.0f : 4.0f * cos_i * cos_o;
  const float k = d * g / denom;
  return degenerate ? v3(0.0f, 0.0f, 0.0f) : f * k;
}

// sample_f_cook_torrance: the lobe chosen by u_choice, computed alone.
PTT_HD Lobe sample_cook_torrance(V3 albedo, V3 n, V3 wo_world, float r,
                                                     float metallic, float u_choice,
                                                     float xi0, float xi1) {
  const V3 f = fresnel_schlick(ptt_clamp(dot(n, wo_world), 0.0f, 1.0f), f0_of(albedo, metallic));
  const float f_prob = ptt_clamp(ptt_max(f.x, ptt_max(f.y, f.z)), 0.0f, 1.0f);
  Lobe s;
  if (u_choice < f_prob) {
    const V3 wo_local = world_to_local(n, wo_world);
    // _sample_wh
    const float phi = PTT_TWO_PI * xi1;
    const float denom = ptt_max(1.0f - xi0, PTT_1EM12);
    const float tan2 = r * r * xi0 / denom;
    const float cos_t = 1.0f / sqrtf(1.0f + tan2);
    const float sin_t = sqrtf(ptt_max(1.0f - cos_t * cos_t, 0.0f));
    V3 wh = v3(sin_t * cosf(phi), sin_t * sinf(phi), cos_t);
    if (!((wo_local.z * wh.z) > 0.0f)) wh = -wh;
    if (wh.z < 0.0f) wh = -wh;
    const V3 wi_local = reflect(-wo_local, wh);
    s.wi = normalize(local_to_world(n, wi_local));
    const float dot_wo_wh = ptt_max(dot(wo_local, wh), PTT_1EM6);
    const float pdf_spec = trowbridge_reitz_d(wh, r) * fabsf(wh.z) / (4.0f * dot_wo_wh);
    s.f = f_microfacet_refl(albedo, wo_local, wi_local, r, metallic) * f;
    s.pdf = f_prob * pdf_spec;
  } else {
    const Lobe diff = sample_diffuse(albedo, n, xi0, xi1);
    s.wi = diff.wi;
    s.f = diff.f * v3(1.0f - f.x, 1.0f - f.y, 1.0f - f.z);
    s.pdf = (1.0f - f_prob) * diff.pdf;
  }
  return s;
}

// ---------------------------------------------------------------------------
// scatter_compose for one ray (ops/shade.py), material already selected.
// albedo_in, when given, replaces the material's color (a texture's albedo,
// resolved before the kernel).
// ---------------------------------------------------------------------------

PTT_HD void scatter(const PttScene& s, Ray& ray, const Hit& h, float u_choice, float xi0,
                    float xi1, const V3* albedo_in = nullptr) {
  if (ray.bounces <= 0) return;  // terminated: keeps its final color
  if (!(h.t > 0.0f)) {           // miss
    ray.c = v3(0.0f, 0.0f, 0.0f);
    ray.bounces = 0;
    return;
  }
  int mid = h.material_id;
  mid = mid < 0 ? 0 : (mid > s.num_materials - 1 ? s.num_materials - 1 : mid);
  const PttMaterial& m = s.materials[mid];
  const V3 albedo = albedo_in ? *albedo_in : v3(m.color[0], m.color[1], m.color[2]);
  if (m.emittance > 0.0f) {  // emissive: deposit and terminate
    ray.c = ray.c * (albedo * m.emittance);
    ray.bounces = 0;
    return;
  }
  const V3 n = h.normal;
  const V3 wo = ray.d;
  const bool is_glass = s.lobe_glass && (m.has_refractive > 0.0f) && (m.has_reflective > 0.0f);
  const bool is_mirror = s.lobe_mirror && (m.has_reflective > 0.0f) && !is_glass;
  const bool is_trans = s.lobe_trans && (m.has_refractive > 0.0f) && !is_glass && !is_mirror;
  const bool is_micro = s.lobe_micro && (m.roughness >= 0.0f) && (m.metallic >= 0.0f) &&
                        !is_glass && !is_mirror && !is_trans;
  V3 wi, mult;
  float pdf = 0.0f;
  if (is_glass) {
    const float fresnel = fresnel_dielectric(dot(wo, n), m.ior);
    bool tir;
    const V3 wt = sample_transmission(n, wo, m.ior, s.baby_eps, &tir);
    wi = ((u_choice < fresnel) || tir) ? reflect(wo, n) : wt;
    mult = albedo;
  } else if (is_mirror) {
    wi = reflect(wo, n);
    mult = albedo;
  } else if (is_trans) {
    bool tir;
    wi = sample_transmission(n, wo, m.ior, s.baby_eps, &tir);
    mult = tir ? v3(0.0f, 0.0f, 0.0f) : albedo;
  } else if (is_micro) {
    const Lobe l = sample_cook_torrance(albedo, n, -normalize(wo), m.roughness, m.metallic,
                                        u_choice, xi0, xi1);
    wi = l.wi;
    mult = l.f;
    pdf = l.pdf;
  } else {
    const Lobe l = sample_diffuse(albedo, n, xi0, xi1);
    wi = l.wi;
    mult = l.f;
    pdf = l.pdf;
  }
  const V3 new_dir = normalize(wi);
  const float cos_theta = ptt_max(dot(n, new_dir), 0.0f);
  if (is_micro) {
    mult = (pdf > 0.0f) ? mult * (cos_theta / pdf) : v3(1.0f, 1.0f, 1.0f);
  } else if (!(is_glass || is_mirror || is_trans)) {
    mult = (pdf > 0.0f) ? mult * (cos_theta / pdf) : v3(0.0f, 0.0f, 0.0f);
  }
  const V3 ipt = ray.o + ray.d * h.t;
  ray.o = (is_glass || is_trans || is_micro) ? ipt + new_dir * s.larger_eps
                                             : ipt + n * s.baby_eps;
  ray.d = new_dir;
  ray.c = ray.c * mult;
  ray.bounces -= 1;
}

// ---------------------------------------------------------------------------
// The lobe that scatters a ray, for the counting variant of the iteration
// kernel (fused_prim.cu, COUNT_LOBES) and the host twin's tally.  scatter
// above selects by the same predicates, written out in place: a helper
// shared with it moved registers and spills in the bounce and mesh-shade
// kernels, which must compile as they did.  The tests hold the two to each
// other (the tally against ops/shade.py::lobe_tally and the reference's).
// ---------------------------------------------------------------------------

// The lobes of scatterRay in the order it tests them (ops/shade.py::LOBES):
// a material scatters by the first lobe it selects, else by the diffuse.
#define PTT_LOBE_GLASS 0
#define PTT_LOBE_MIRROR 1
#define PTT_LOBE_TRANS 2
#define PTT_LOBE_MICRO 3
#define PTT_LOBE_DIFFUSE 4
#define PTT_LOBES 5

// The lobe (PTT_LOBE_*) that scatters a live ray at hit h, or -1 where it
// scatters none (a miss or a light): scatter's choice, ops/shade.py's
// lobe_masks for one ray.
PTT_HD int scatter_lobe(const PttScene& s, const Hit& h) {
  if (!(h.t > 0.0f)) return -1;
  int mid = h.material_id;
  mid = mid < 0 ? 0 : (mid > s.num_materials - 1 ? s.num_materials - 1 : mid);
  const PttMaterial& m = s.materials[mid];
  if (m.emittance > 0.0f) return -1;
  if (s.lobe_glass && (m.has_refractive > 0.0f) && (m.has_reflective > 0.0f)) {
    return PTT_LOBE_GLASS;
  }
  if (s.lobe_mirror && (m.has_reflective > 0.0f)) return PTT_LOBE_MIRROR;
  if (s.lobe_trans && (m.has_refractive > 0.0f)) return PTT_LOBE_TRANS;
  if (s.lobe_micro && (m.roughness >= 0.0f) && (m.metallic >= 0.0f)) return PTT_LOBE_MICRO;
  return PTT_LOBE_DIFFUSE;
}

#if defined(__CUDACC__)
// Bytes of shared memory the scene's tables take when a block stages them.
__host__ __device__ inline size_t scene_table_bytes(int num_geoms, int num_materials) {
  return (size_t)num_geoms * sizeof(PttGeom) + (size_t)num_materials * sizeof(PttMaterial);
}

// The most dynamic shared memory a block of these kernels asks for (the
// H100's 227 KB); tables beyond it are read from device memory through L1.
#define PTT_SMEM_LIMIT 232448

// The block's view of the scene: the header by value and, with STAGE, the
// two tables copied into the shared memory at smem (scene_table_bytes of
// it) where every ray of the block reads them as broadcasts; without, the
// tables stay where they are in device memory.  STAGE is a template
// argument so that each instantiation's table pointers have one address
// space the compiler can see (shared loads, not generic ones).  The caller
// synchronises the block before the first read.
template <bool STAGE>
__device__ __forceinline__ PttScene load_scene(const PttScene* src, unsigned char* smem) {
  PttScene s = *src;
  if (!STAGE) return s;
  const int gw = s.num_geoms * (int)(sizeof(PttGeom) / 4);
  const int mw = s.num_materials * (int)(sizeof(PttMaterial) / 4);
  const uint32_t* g = reinterpret_cast<const uint32_t*>(s.geoms);
  const uint32_t* m = reinterpret_cast<const uint32_t*>(s.materials);
  uint32_t* d = reinterpret_cast<uint32_t*>(smem);
  for (int i = threadIdx.x; i < gw; i += blockDim.x) d[i] = g[i];
  for (int i = threadIdx.x; i < mw; i += blockDim.x) d[gw + i] = m[i];
  s.geoms = reinterpret_cast<const PttGeom*>(d);
  s.materials = reinterpret_cast<const PttMaterial*>(d + gw);
  return s;
}
#endif

// ---------------------------------------------------------------------------
// Per-ray steps of the two kernels (and of the host harness of the tests).
// ---------------------------------------------------------------------------

// Camera ray of pixel idx: draws its 4 uniforms at counters j*n + idx.
PTT_HD Ray camera_ray(const PttCamera& cam, int width, int height, int depth,
                      int idx, uint32_t n, uint32_t k0, uint32_t k1) {
  float u[4];
  for (int j = 0; j < 4; ++j) u[j] = uniform_at(k0, k1, (uint32_t)j * n + (uint32_t)idx);
  return raygen(cam, width, height, depth, idx, u);
}

// One bounce of a live ray with the given uniforms (the bounce kernel's
// per-ray schedule, which tests/prim_path_host.cpp keeps as the reference).
PTT_HD void bounce_ray(const PttScene& s, Ray& ray, float u0, float u1, float u2) {
  if (ray.bounces <= 0) return;
  const Hit h = intersect_prims(s, ray.o, ray.d);
  scatter(s, ray, h, u0, u1, u2);
}

// One bounce of a live ray as the bounce kernel runs it: the nearest hit
// from prim_nearest and prim_hit, intersect_prims' Hit bit for bit.
PTT_HD void bounce_live(const PttScene& s, Ray& ray, float u0, float u1, float u2) {
  scatter(s, ray, prim_hit(s, ray.d, prim_nearest(s, ray.o, ray.d)), u0, u1, u2);
}

// The bounce's three uniforms of the ray at `pixel`, drawn at counters
// j * rng_n + pixel under the bounce's shade key (prng.uniforms_at).
PTT_HD void draw3(uint32_t k0, uint32_t k1, uint32_t rng_n, uint32_t pixel, float u[3]) {
  for (uint32_t j = 0; j < 3; ++j) u[j] = uniform_at(k0, k1, j * rng_n + pixel);
}

// One bounce of pixel idx at depth d as the iteration kernel's per-pixel
// schedule ran it (tests/prim_path_host.cpp keeps that schedule as the
// reference of the regenerating one): the uniforms drawn inline (counters
// j*n + idx under the depth's shade key), and only for a live ray.
PTT_HD void bounce_ray_inline(const PttScene& s, Ray& ray, uint32_t k0, uint32_t k1,
                              uint32_t n, int idx) {
  if (ray.bounces <= 0) return;
  const float u0 = uniform_at(k0, k1, (uint32_t)idx);
  const float u1 = uniform_at(k0, k1, n + (uint32_t)idx);
  const float u2 = uniform_at(k0, k1, 2u * n + (uint32_t)idx);
  bounce_ray(s, ray, u0, u1, u2);
}

// ---------------------------------------------------------------------------
// The iteration kernel's regenerating schedule, one lane at a time (the
// kernel in fused_prim.cu runs it with warp votes; the host twin in
// tests/prim_path_host.cpp steps 32 lanes of a warp in lock step).  A lane
// holds one pixel's path at a time; a free lane takes the next pixel from a
// counter shared by the whole grid.  Each path is the one the per-pixel
// schedule (ptt_host_iteration) traces: its camera ray, then its bounces
// at its own depths with those depths' shade keys.
// ---------------------------------------------------------------------------

// A warp takes new pixels once at least this many of its 32 lanes are free
// (1: as soon as one is).
#ifndef PTT_REFILL_MIN
#define PTT_REFILL_MIN 1
#endif

struct IterLane {
  Ray ray;
  int32_t pixel;  // -1: the lane is free
};

// Start pixel p's path: its camera ray, bounces = depth.
PTT_HD void lane_start(IterLane& l, int32_t p, const PttCamera& cam, int width, int height,
                       int depth, uint32_t n, uint32_t k0, uint32_t k1) {
  l.pixel = p;
  l.ray = camera_ray(cam, width, height, depth, p, n, k0, k1);
}

// One bounce of a live path at its own depth d = depth - bounces (a path
// that is alive after b bounces has bounces = depth - b): bounce_ray_inline
// under that depth's shade key keys[2d], keys[2d + 1], with the nearest hit
// from prim_nearest and prim_hit.  Returns d if the path is still alive
// after it (it counts in alive[d]), else -1.
PTT_HD int lane_bounce(const PttScene& s, IterLane& l, const uint32_t* keys, int depth,
                       uint32_t n) {
  const int d = depth - l.ray.bounces;
  const uint32_t k0 = keys[2 * d], k1 = keys[2 * d + 1], px = (uint32_t)l.pixel;
  const float u0 = uniform_at(k0, k1, px);
  const float u1 = uniform_at(k0, k1, n + px);
  const float u2 = uniform_at(k0, k1, 2u * n + px);
  scatter(s, l.ray, prim_hit(s, l.ray.d, prim_nearest(s, l.ray.o, l.ray.d)), u0, u1, u2);
  return l.ray.bounces > 0 ? d : -1;
}

// lane_bounce, and in *lobe_slot d * PTT_LOBES + the lobe that scattered
// the path at its depth d (its cell of a [depth, PTT_LOBES] tally), or -1
// where none did (a miss or a light): the counting variant's bounce.
PTT_HD int lane_bounce_lobe(const PttScene& s, IterLane& l, const uint32_t* keys, int depth,
                            uint32_t n, int* lobe_slot) {
  const int d = depth - l.ray.bounces;
  const uint32_t k0 = keys[2 * d], k1 = keys[2 * d + 1], px = (uint32_t)l.pixel;
  const float u0 = uniform_at(k0, k1, px);
  const float u1 = uniform_at(k0, k1, n + px);
  const float u2 = uniform_at(k0, k1, 2u * n + px);
  const Hit h = prim_hit(s, l.ray.d, prim_nearest(s, l.ray.o, l.ray.d));
  const int lobe = scatter_lobe(s, h);
  *lobe_slot = lobe < 0 ? -1 : d * PTT_LOBES + lobe;
  scatter(s, l.ray, h, u0, u1, u2);
  return l.ray.bounces > 0 ? d : -1;
}

// A path that is done (dead, or depth bounces traced): film[pixel] +=
// color, the pixel's one write of the iteration, and the lane is free.
PTT_HD void lane_finish(IterLane& l, float* film_x, float* film_y, float* film_z) {
  film_x[l.pixel] = film_x[l.pixel] + l.ray.c.x;
  film_y[l.pixel] = film_y[l.pixel] + l.ray.c.y;
  film_z[l.pixel] = film_z[l.pixel] + l.ray.c.z;
  l.pixel = -1;
}
