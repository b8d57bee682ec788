// Hand-written Hopper (sm_90a) kernels for analytic-primitive scenes.
//
// ptt_iteration_kernel replaces the TPU kernel
//   project3_cuda_path_tracer_2025_tpu/ops/fused.py::_iteration_kernel
//   (launched by fused_prim_iteration): one whole spp iteration -- raygen
//   with jitter and thin lens, depth x (intersect + material select +
//   scatter), film += color, per-depth alive counts.
// ptt_bounce_kernel replaces
//   project3_cuda_path_tracer_2025_tpu/ops/fused.py::_bounce_kernel
//   (launched by fused_prim_bounce): one bounce, path-state planes in,
//   path-state planes out.
// ptt_uniforms_kernel draws jax.random.uniform's [k, n] rows with the same
// in-kernel Threefry the iteration kernel uses (utils/prng.py::uniforms on
// a CUDA device).
//
// What bounds them on the H100: arithmetic, not bytes.  The bounce kernel
// moves about 92 B per ray per bounce (9 floats + 1 int in and out, 3
// uniforms in) and the iteration kernel 24 B of film per pixel per
// iteration, against a few thousand flops per ray per bounce, dominated by
// the divisions, square roots and cos/sin of box/sphere intersection and
// the BSDFs, plus 20 Threefry rounds per uniform.  So the design keeps
// every intermediate in registers, keeps the scene constants in shared
// memory where every warp reads them as broadcasts, lets each ray branch to
// the one lobe it needs, and retires a dead ray at once.  wgmma and TMA do
// not apply: there is no matrix product and no tile to stage.
//
// The TPU kernels padded rays to 8192-ray blocks and baked the camera and
// scene into the program; here each thread is one ray, masked by idx < n,
// the scene is a struct uploaded once per scene, and the camera and RNG
// keys are plain arguments, so an orbit rebuilds nothing.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// -shared -Xcompiler -fPIC (ops/kernels.py).  Plain C interface, loaded with
// ctypes; each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "prim_path.cuh"

#define PTT_THREADS 256
#define PTT_NKEYS (2 * (PTT_MAX_DEPTH + 1))

struct PttIterArgs {
  const PttScene* scene;
  float* film_x;
  float* film_y;
  float* film_z;
  int32_t* alive;  // [depth], zeroed by the caller
  PttCamera cam;
  int32_t width, height, n, depth;
  // keys[0:2] = camera stage key; keys[2+2d : 4+2d] = shade key of depth d.
  uint32_t keys[PTT_NKEYS];
};

struct PttBounceArgs {
  const PttScene* scene;
  const float* in_f[9];  // origin xyz, direction xyz, color rgb
  const int32_t* in_bounces;
  const float* u;  // [3, n]
  float* out_f[9];
  int32_t* out_bounces;
  int32_t n;
  int32_t pad;
};

// Copy the scene struct into shared memory (every ray of the block reads it).
__device__ __forceinline__ void load_scene(PttScene* dst, const PttScene* src) {
  const int words = (int)(sizeof(PttScene) / 4);
  const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
  uint32_t* d = reinterpret_cast<uint32_t*>(dst);
  for (int i = threadIdx.x; i < words; i += blockDim.x) d[i] = s[i];
}

__global__ void __launch_bounds__(PTT_THREADS) ptt_iteration_kernel(const PttIterArgs a) {
  __shared__ PttScene sh_scene;
  __shared__ uint32_t sh_keys[PTT_NKEYS];
  __shared__ int32_t sh_alive[PTT_MAX_DEPTH];
  load_scene(&sh_scene, a.scene);
  for (int i = threadIdx.x; i < 2 * (a.depth + 1); i += blockDim.x) sh_keys[i] = a.keys[i];
  for (int i = threadIdx.x; i < a.depth; i += blockDim.x) sh_alive[i] = 0;
  __syncthreads();

  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = idx < a.n;
  const uint32_t n = (uint32_t)a.n;
  Ray ray;
  ray.bounces = 0;
  if (in_range) {
    ray = camera_ray(a.cam, a.width, a.height, a.depth, idx, n, sh_keys[0], sh_keys[1]);
  }
  for (int d = 0; d < a.depth; ++d) {
    bounce_ray_inline(sh_scene, ray, sh_keys[2 + 2 * d], sh_keys[3 + 2 * d], n, idx);
    const unsigned ballot = __ballot_sync(0xffffffffu, ray.bounces > 0);
    if ((threadIdx.x & 31) == 0 && ballot) atomicAdd(&sh_alive[d], __popc(ballot));
  }
  if (in_range) {
    // In place: the film is the caller's accumulator (the JAX package
    // donates it to the kernel for the same effect).
    a.film_x[idx] = a.film_x[idx] + ray.c.x;
    a.film_y[idx] = a.film_y[idx] + ray.c.y;
    a.film_z[idx] = a.film_z[idx] + ray.c.z;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < a.depth; d += blockDim.x) {
    if (sh_alive[d]) atomicAdd(&a.alive[d], sh_alive[d]);
  }
}

__global__ void __launch_bounds__(PTT_THREADS) ptt_bounce_kernel(const PttBounceArgs a) {
  __shared__ PttScene sh_scene;
  load_scene(&sh_scene, a.scene);
  __syncthreads();
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= a.n) return;
  Ray ray;
  ray.o = v3(a.in_f[0][idx], a.in_f[1][idx], a.in_f[2][idx]);
  ray.d = v3(a.in_f[3][idx], a.in_f[4][idx], a.in_f[5][idx]);
  ray.c = v3(a.in_f[6][idx], a.in_f[7][idx], a.in_f[8][idx]);
  ray.bounces = a.in_bounces[idx];
  const size_t n = (size_t)a.n;
  bounce_ray(sh_scene, ray, a.u[idx], a.u[n + idx], a.u[2 * n + idx]);
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
}

__global__ void __launch_bounds__(PTT_THREADS) ptt_uniforms_kernel(uint32_t k0, uint32_t k1,
                                                                   uint32_t total, float* out) {
  const uint32_t flat = blockIdx.x * blockDim.x + threadIdx.x;
  if (flat < total) out[flat] = uniform_at(k0, k1, flat);
}

static unsigned blocks_for(long long n) {
  return (unsigned)((n + PTT_THREADS - 1) / PTT_THREADS);
}

extern "C" {

// Struct sizes and offsets, checked against the ctypes mirror at load time.
int ptt_abi(int32_t* out, int32_t len) {
  const int32_t v[] = {
      (int32_t)sizeof(PttScene),
      (int32_t)sizeof(PttCamera),
      (int32_t)sizeof(PttIterArgs),
      (int32_t)offsetof(PttIterArgs, cam),
      (int32_t)offsetof(PttIterArgs, keys),
      (int32_t)sizeof(PttBounceArgs),
      (int32_t)offsetof(PttBounceArgs, n),
      PTT_MAX_GEOMS,
      PTT_MAX_MATERIALS,
      PTT_MAX_DEPTH,
  };
  const int32_t count = (int32_t)(sizeof(v) / sizeof(v[0]));
  for (int32_t i = 0; i < count && i < len; ++i) out[i] = v[i];
  return count;
}

int ptt_launch_iteration(const PttIterArgs* a, void* stream) {
  if (a->n > 0) {
    ptt_iteration_kernel<<<blocks_for(a->n), PTT_THREADS, 0, (cudaStream_t)stream>>>(*a);
  }
  return (int)cudaGetLastError();
}

int ptt_launch_bounce(const PttBounceArgs* a, void* stream) {
  if (a->n > 0) {
    ptt_bounce_kernel<<<blocks_for(a->n), PTT_THREADS, 0, (cudaStream_t)stream>>>(*a);
  }
  return (int)cudaGetLastError();
}

int ptt_launch_uniforms(uint32_t k0, uint32_t k1, uint32_t total, float* out, void* stream) {
  if (total > 0) {
    ptt_uniforms_kernel<<<blocks_for(total), PTT_THREADS, 0, (cudaStream_t)stream>>>(k0, k1, total, out);
  }
  return (int)cudaGetLastError();
}

const char* ptt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
