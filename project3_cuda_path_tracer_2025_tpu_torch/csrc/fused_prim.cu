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
// the scene is a header and two tables uploaded once per scene, the camera
// and the iteration's RNG key are plain arguments, so an orbit rebuilds
// nothing and a frame copies nothing to the card.  Nothing here bounds the
// scene or the depth: a block stages the tables in dynamic shared memory
// sized by the launcher from the scene (tables beyond the card's shared
// memory stay in device memory, read through L1), and walks the depths in
// windows of PTT_DEPTH_WINDOW, deriving each window's shade keys and
// keeping its alive counters in a fixed piece of shared memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// -shared -Xcompiler -fPIC (ops/kernels.py).  Plain C interface, loaded with
// ctypes; each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "prim_path.cuh"

#define PTT_THREADS 256
// Depths a block handles between two flushes of its alive counters.
#define PTT_DEPTH_WINDOW 64

struct PttIterArgs {
  const PttScene* scene;
  float* film_x;
  float* film_y;
  float* film_z;
  int32_t* alive;  // [depth], zeroed by the caller
  PttCamera cam;
  int32_t width, height, n, depth;
  int32_t num_geoms, num_materials;  // the scene's counts, for the launcher
  uint32_t cam_key[2];   // prng.stage_key(iter_key, 0, 0)
  uint32_t iter_key[2];  // prng.iteration_key(base_key, iteration); the shade
                         // key of depth d is shade_stage_key(iter_key, d)
};

struct PttBounceArgs {
  const PttScene* scene;
  const float* in_f[9];  // origin xyz, direction xyz, color rgb
  const int32_t* in_bounces;
  const float* u;  // [3, n]
  float* out_f[9];
  int32_t* out_bounces;
  int32_t n;
  int32_t num_geoms, num_materials;  // the scene's counts, for the launcher
  int32_t pad;
};

extern __shared__ __align__(16) unsigned char ptt_smem[];

// Dynamic shared memory: the scene's tables (STAGE_SCENE).
template <bool STAGE_SCENE>
__global__ void __launch_bounds__(PTT_THREADS) ptt_iteration_kernel(const PttIterArgs a) {
  __shared__ int32_t sh_alive[PTT_DEPTH_WINDOW];
  __shared__ uint32_t sh_key[PTT_DEPTH_WINDOW][2];
  const PttScene sh_scene = load_scene<STAGE_SCENE>(a.scene, ptt_smem);

  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = idx < a.n;
  const uint32_t n = (uint32_t)a.n;
  Ray ray;
  ray.bounces = 0;
  if (in_range) {
    ray = camera_ray(a.cam, a.width, a.height, a.depth, idx, n, a.cam_key[0], a.cam_key[1]);
  }
  // Every thread of the block walks every depth (a dead ray's bounce is a
  // return), so the window's barriers are uniform.
  for (int d0 = 0; d0 < a.depth; d0 += PTT_DEPTH_WINDOW) {
    const int span = min(PTT_DEPTH_WINDOW, a.depth - d0);
    if ((int)threadIdx.x < span) {
      sh_alive[threadIdx.x] = 0;
      shade_stage_key(a.iter_key[0], a.iter_key[1], (uint32_t)(d0 + (int)threadIdx.x),
                      &sh_key[threadIdx.x][0], &sh_key[threadIdx.x][1]);
    }
    __syncthreads();  // also orders load_scene's writes before the first read
    for (int i = 0; i < span; ++i) {
      bounce_ray_inline(sh_scene, ray, sh_key[i][0], sh_key[i][1], n, idx);
      const unsigned ballot = __ballot_sync(0xffffffffu, ray.bounces > 0);
      if ((threadIdx.x & 31) == 0 && ballot) atomicAdd(&sh_alive[i], __popc(ballot));
    }
    __syncthreads();
    // The thread that flushes a slot is the one that clears it next window.
    if ((int)threadIdx.x < span && sh_alive[threadIdx.x]) {
      atomicAdd(&a.alive[d0 + threadIdx.x], sh_alive[threadIdx.x]);
    }
  }
  if (in_range) {
    // In place: the film is the caller's accumulator (the JAX package
    // donates it to the kernel for the same effect).
    a.film_x[idx] = a.film_x[idx] + ray.c.x;
    a.film_y[idx] = a.film_y[idx] + ray.c.y;
    a.film_z[idx] = a.film_z[idx] + ray.c.z;
  }
}

template <bool STAGE_SCENE>
__global__ void __launch_bounds__(PTT_THREADS) ptt_bounce_kernel(const PttBounceArgs a) {
  const PttScene sh_scene = load_scene<STAGE_SCENE>(a.scene, ptt_smem);
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

// Raise a kernel's dynamic shared memory bound when a launch needs more than
// the default 48 KB.
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

extern "C" {

// Struct sizes and offsets, checked against the ctypes mirror at load time.
int ptt_abi(int32_t* out, int32_t len) {
  const int32_t v[] = {
      (int32_t)sizeof(PttScene),
      (int32_t)sizeof(PttCamera),
      (int32_t)sizeof(PttIterArgs),
      (int32_t)offsetof(PttIterArgs, cam),
      (int32_t)offsetof(PttIterArgs, cam_key),
      (int32_t)sizeof(PttBounceArgs),
      (int32_t)offsetof(PttBounceArgs, n),
      (int32_t)sizeof(PttGeom),
      (int32_t)sizeof(PttMaterial),
      (int32_t)offsetof(PttScene, geoms),
  };
  const int32_t count = (int32_t)(sizeof(v) / sizeof(v[0]));
  for (int32_t i = 0; i < count && i < len; ++i) out[i] = v[i];
  return count;
}

int ptt_launch_iteration(const PttIterArgs* a, void* stream) {
  if (a->depth < 0 || a->num_geoms < 0 || a->num_materials < 0) return (int)cudaErrorInvalidValue;
  if (a->n > 0) {
    // The kernel's fixed shared memory counts against the same 227 KB.
    const size_t fixed = PTT_DEPTH_WINDOW * (sizeof(int32_t) + 2 * sizeof(uint32_t));
    const size_t tables = scene_table_bytes(a->num_geoms, a->num_materials);
    const bool stage_scene = tables + fixed <= PTT_SMEM_LIMIT;
    const size_t smem = stage_scene ? tables : 0;
    const cudaError_t err = allow_smem(ptt_iteration_kernel<true>, smem);
    if (err != cudaSuccess) return (int)err;
    if (stage_scene) {
      ptt_iteration_kernel<true><<<blocks_for(a->n), PTT_THREADS, smem, (cudaStream_t)stream>>>(*a);
    } else {
      ptt_iteration_kernel<false><<<blocks_for(a->n), PTT_THREADS, 0, (cudaStream_t)stream>>>(*a);
    }
  }
  return (int)cudaGetLastError();
}

int ptt_launch_bounce(const PttBounceArgs* a, void* stream) {
  if (a->num_geoms < 0 || a->num_materials < 0) return (int)cudaErrorInvalidValue;
  if (a->n > 0) {
    const size_t tables = scene_table_bytes(a->num_geoms, a->num_materials);
    const bool stage_scene = tables <= PTT_SMEM_LIMIT;
    const size_t smem = stage_scene ? tables : 0;
    const cudaError_t err = allow_smem(ptt_bounce_kernel<true>, smem);
    if (err != cudaSuccess) return (int)err;
    if (stage_scene) {
      ptt_bounce_kernel<true><<<blocks_for(a->n), PTT_THREADS, smem, (cudaStream_t)stream>>>(*a);
    } else {
      ptt_bounce_kernel<false><<<blocks_for(a->n), PTT_THREADS, 0, (cudaStream_t)stream>>>(*a);
    }
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
