// Hand-written Hopper (sm_90a) kernels of a mesh scene's bounce.
//
// ptt_mono_kernel replaces the TPU kernel
//   project3_cuda_path_tracer_2025_tpu/ops/intersect_mxu.py::_mono_kernel
//   (launched by _run.run_mono): the closest (t, tri) of every ray over a
//   mesh of at most 8 tiles of 1,024 triangles, under the candidate
//   contract (per-ray member windows, ties to the lowest triangle id).
// ptt_mesh_shade_kernel replaces
//   project3_cuda_path_tracer_2025_tpu/ops/fused.py::_mesh_bounce_kernel
//   in mode "plain" (launched by _fused_mesh_shade): analytic-prim
//   intersect, merge with the mesh hit, BSDF scatter with inline Threefry,
//   and optionally the next bounce's prim t_limit and coherence sort key.
//
// What bounds them on the H100.  The traversal is bound by operations: per
// candidate (ray, triangle) pair it loads one 80-byte coefficient row
// (the same row for every ray of a warp, so one broadcast transaction from
// L1/L2; the 5k mesh's 410 KB of rows sits in the 50 MB L2) and does 19
// fused multiply-adds, a division and ~12 compares, against 44 bytes of
// ray state per ray.  The TPU kernel ran the numerators as a
// [256,16]x[16,4096] matmul on the matrix unit; here one thread owns one
// ray and walks the tiles it is a candidate for, skipping the others (the
// contract allows any visit set that covers the candidates).  Tensor cores
// would need the numerators in TF32 or a split-float scheme to stay exact;
// staging tiles in shared memory and warp-cooperative culling are for a
// later performance PR.  The shade kernel is bound by arithmetic, like the
// prim bounce kernel: ~76 B per ray in and out against a few thousand flops
// (prim intersect, BSDF, 3 x 20 Threefry rounds, prim t and the key).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// -shared -Xcompiler -fPIC (ops/kernels.py).  Plain C interface, loaded with
// ctypes; each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mesh_path.cuh"

#define PTT_THREADS 256

struct PttMonoArgs {
  const float* ray[6];       // origin xyz, direction xyz
  const uint8_t* active;     // bool
  const float* tlim;
  const float* coef;         // [ct * 1024, 20]
  const float* tile_aabb;    // [ct, 8]
  const float* center;       // [3]
  float* out_t;
  int32_t* out_tri;
  float baby_eps;
  float eps_succ;            // nextafter(baby_eps, +inf)
  int32_t n, ct, num_tris, pad;
};

struct PttMeshShadeArgs {
  const PttScene* scene;     // prims only
  const float* in_f[9];      // origin xyz, direction xyz, color rgb
  const int32_t* in_bounces;
  const int32_t* pixel;
  const float* mesh_t;
  const float* mesh_n[3];
  const int32_t* mesh_mat;   // -1 = no mesh hit
  const float* tile_aabb;    // [ct, 8] (emit == 2)
  const float* center;       // [3] (emit == 2)
  float* out_f[9];
  int32_t* out_bounces;
  float* out_tlim;           // emit >= 1
  int32_t* out_key;          // emit == 2
  uint32_t k0, k1, rng_n;
  int32_t n, ct, emit;       // emit: 0 none, 1 t_lim, 2 t_lim + key
};

__global__ void __launch_bounds__(PTT_THREADS) ptt_mono_kernel(const PttMonoArgs a) {
  __shared__ float sh_aabb[PTT_MONO_MAX_TILES * 8];
  __shared__ float sh_center[3];
  for (int i = threadIdx.x; i < a.ct * 8; i += blockDim.x) sh_aabb[i] = a.tile_aabb[i];
  if (threadIdx.x < 3) sh_center[threadIdx.x] = a.center[threadIdx.x];
  __syncthreads();
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= a.n) return;
  const V3 o = v3(a.ray[0][idx], a.ray[1][idx], a.ray[2][idx]);
  const V3 d = v3(a.ray[3][idx], a.ray[4][idx], a.ray[5][idx]);
  float t;
  int32_t tri;
  mono_ray(a.coef, sh_aabb, a.ct, v3(sh_center[0], sh_center[1], sh_center[2]), o, d,
           a.active[idx] != 0, a.tlim[idx], a.num_tris, a.baby_eps, a.eps_succ, &t, &tri);
  a.out_t[idx] = t;
  a.out_tri[idx] = tri;
}

__global__ void __launch_bounds__(PTT_THREADS) ptt_mesh_shade_kernel(const PttMeshShadeArgs a) {
  __shared__ PttScene sh_scene;
  __shared__ float sh_aabb[PTT_KEY_MAX_CT * 8];
  __shared__ float sh_center[3];
  load_scene(&sh_scene, a.scene);
  if (a.emit == 2) {
    for (int i = threadIdx.x; i < a.ct * 8; i += blockDim.x) sh_aabb[i] = a.tile_aabb[i];
    if (threadIdx.x < 3) sh_center[threadIdx.x] = a.center[threadIdx.x];
  }
  __syncthreads();
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= a.n) return;
  Ray ray;
  ray.o = v3(a.in_f[0][idx], a.in_f[1][idx], a.in_f[2][idx]);
  ray.d = v3(a.in_f[3][idx], a.in_f[4][idx], a.in_f[5][idx]);
  ray.c = v3(a.in_f[6][idx], a.in_f[7][idx], a.in_f[8][idx]);
  ray.bounces = a.in_bounces[idx];
  const V3 mn = v3(a.mesh_n[0][idx], a.mesh_n[1][idx], a.mesh_n[2][idx]);
  mesh_shade_ray(sh_scene, ray, a.mesh_t[idx], mn, a.mesh_mat[idx], a.k0, a.k1, a.rng_n,
                 a.pixel[idx]);
  a.out_f[0][idx] = ray.o.x;
  a.out_f[1][idx] = ray.o.y;
  a.out_f[2][idx] = ray.o.z;
  a.out_f[3][idx] = ray.d.x;
  a.out_f[4][idx] = ray.d.y;
  a.out_f[5][idx] = ray.d.z;
  a.out_f[6][idx] = ray.c.x;
  a.out_f[7][idx] = ray.c.y;
  a.out_f[8][idx] = ray.c.z;
  a.out_bounces[idx] = ray.bounces;
  if (a.emit >= 1) {
    const float tl = prim_t_min(sh_scene, ray.o, ray.d);
    a.out_tlim[idx] = tl;
    if (a.emit == 2) {
      a.out_key[idx] = coherence_key(sh_aabb, a.ct, v3(sh_center[0], sh_center[1], sh_center[2]),
                                     ray.o, ray.d, ray.bounces > 0, tl);
    }
  }
}

static unsigned blocks_for(long long n) {
  return (unsigned)((n + PTT_THREADS - 1) / PTT_THREADS);
}

extern "C" {

// Struct sizes and offsets, checked against the ctypes mirror at load time.
int ptt_mesh_abi(int32_t* out, int32_t len) {
  const int32_t v[] = {
      (int32_t)sizeof(PttScene),
      (int32_t)sizeof(PttMonoArgs),
      (int32_t)offsetof(PttMonoArgs, baby_eps),
      (int32_t)offsetof(PttMonoArgs, n),
      (int32_t)sizeof(PttMeshShadeArgs),
      (int32_t)offsetof(PttMeshShadeArgs, k0),
      (int32_t)offsetof(PttMeshShadeArgs, n),
      PTT_TRI_TILE,
      PTT_COEF_W,
      PTT_MONO_MAX_TILES,
      PTT_KEY_MAX_CT,
  };
  const int32_t count = (int32_t)(sizeof(v) / sizeof(v[0]));
  for (int32_t i = 0; i < count && i < len; ++i) out[i] = v[i];
  return count;
}

int ptt_launch_mono(const PttMonoArgs* a, void* stream) {
  if (a->ct < 1 || a->ct > PTT_MONO_MAX_TILES) return (int)cudaErrorInvalidValue;
  if (a->n > 0) {
    ptt_mono_kernel<<<blocks_for(a->n), PTT_THREADS, 0, (cudaStream_t)stream>>>(*a);
  }
  return (int)cudaGetLastError();
}

int ptt_launch_mesh_shade(const PttMeshShadeArgs* a, void* stream) {
  if (a->emit == 2 && (a->ct < 1 || a->ct > PTT_KEY_MAX_CT)) return (int)cudaErrorInvalidValue;
  if (a->n > 0) {
    ptt_mesh_shade_kernel<<<blocks_for(a->n), PTT_THREADS, 0, (cudaStream_t)stream>>>(*a);
  }
  return (int)cudaGetLastError();
}

const char* ptt_mesh_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
