// Host build of the mesh kernels' per-ray bodies (csrc/mesh_path.cuh), so
// the CPU tests can hold the arithmetic the kernels run against the port's
// plain torch versions.  Each function is the loop over rays that the
// matching kernel in csrc/fused_mesh.cu runs as one thread per ray.
//
// Built by tests/test_torch_kernel_body.py with
//   c++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC -I<csrc>

#include <stdint.h>

#include "mesh_path.cuh"

extern "C" {

int ptt_host_mesh_sizes(int32_t* out) {
  out[0] = (int32_t)sizeof(PttScene);
  out[1] = PTT_COEF_W;
  return 2;
}

// ptt_mono_kernel
void ptt_host_mono(const float* coef, const float* aabb, int32_t ct, const float* center,
                   const float* const* ray, const uint8_t* active, const float* tlim,
                   int32_t num_tris, float baby_eps, float eps_succ, int32_t n, float* out_t,
                   int32_t* out_tri) {
  const V3 c = v3(center[0], center[1], center[2]);
  for (int32_t i = 0; i < n; ++i) {
    mono_ray(coef, aabb, ct, c, v3(ray[0][i], ray[1][i], ray[2][i]),
             v3(ray[3][i], ray[4][i], ray[5][i]), active[i] != 0, tlim[i], num_tris, baby_eps,
             eps_succ, &out_t[i], &out_tri[i]);
  }
}

// ptt_mesh_shade_kernel; emit: 0 none, 1 t_lim, 2 t_lim + key.
void ptt_host_mesh_shade(const PttScene* s, const float* const* in_f, const int32_t* in_bounces,
                         const int32_t* pixel, const float* mesh_t, const float* const* mesh_n,
                         const int32_t* mesh_mat, const float* aabb, const float* center,
                         float* const* out_f, int32_t* out_bounces, float* out_tlim,
                         int32_t* out_key, uint32_t k0, uint32_t k1, uint32_t rng_n, int32_t n,
                         int32_t ct, int32_t emit) {
  for (int32_t i = 0; i < n; ++i) {
    Ray ray;
    ray.o = v3(in_f[0][i], in_f[1][i], in_f[2][i]);
    ray.d = v3(in_f[3][i], in_f[4][i], in_f[5][i]);
    ray.c = v3(in_f[6][i], in_f[7][i], in_f[8][i]);
    ray.bounces = in_bounces[i];
    mesh_shade_ray(*s, ray, mesh_t[i], v3(mesh_n[0][i], mesh_n[1][i], mesh_n[2][i]), mesh_mat[i],
                   k0, k1, rng_n, pixel[i]);
    out_f[0][i] = ray.o.x;
    out_f[1][i] = ray.o.y;
    out_f[2][i] = ray.o.z;
    out_f[3][i] = ray.d.x;
    out_f[4][i] = ray.d.y;
    out_f[5][i] = ray.d.z;
    out_f[6][i] = ray.c.x;
    out_f[7][i] = ray.c.y;
    out_f[8][i] = ray.c.z;
    out_bounces[i] = ray.bounces;
    if (emit >= 1) {
      out_tlim[i] = prim_t_min(*s, ray.o, ray.d);
      if (emit == 2) {
        out_key[i] = coherence_key(aabb, ct, v3(center[0], center[1], center[2]), ray.o, ray.d,
                                   ray.bounces > 0, out_tlim[i]);
      }
    }
  }
}

}  // extern "C"
