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
// the BSDFs, plus 20 Threefry rounds per uniform.  So both keep every
// intermediate in registers, keep the scene constants in shared memory
// where every warp reads them as broadcasts, and let each ray branch to the
// one lobe it needs.  wgmma and TMA do not apply: there is no matrix
// product and no tile to stage.  The scene is a header and two tables
// uploaded once per scene, the camera and the iteration's RNG key plain
// arguments, so an orbit rebuilds nothing and a frame copies nothing to
// the card.  Tables beyond the card's shared memory stay in device memory,
// read through L1.
//
// The iteration kernel's work is the paths' live bounces, and paths end at
// every depth (a miss, a light): on cornell_dof.json 46% of the
// lane-bounces a thread-per-pixel schedule issues are dead, since a warp
// issues until its longest path ends.  So its schedule regenerates: a
// persistent grid (the SMs times the blocks each holds), in which each warp
// loops while any lane holds a path, and a free lane takes the next pixel
// from a grid-wide counter (one atomicAdd a warp for all its free lanes,
// the pixels handed out consecutively, in lane order) and computes its
// camera ray.  Each lane carries its pixel and its path, bounces at its own
// depth with that depth's shade key, and writes film[pixel] += color once
// when the path is done: each pixel is written exactly once, a plain
// store.  Lanes at different depths diverge where coherent rays did not, so
// the bounce takes the nearest prim's normal once after the prim loop
// (prim_nearest, prim_hit) instead of at every closer prim.  The shade
// keys of every depth are derived once per block into shared memory beside
// the tables, with the per-depth alive counters (shared atomics, one per
// group of a warp's lanes at one depth, flushed at the block's end); a
// depth too long for shared memory keeps both in device memory.  Every
// path, and so the film and the counts, is the per-pixel schedule's bit for
// bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// -shared -Xcompiler -fPIC (ops/kernels.py).  Plain C interface, loaded with
// ctypes; each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "prim_path.cuh"

#define PTT_THREADS 256

struct PttIterArgs {
  const PttScene* scene;
  float* film_x;
  float* film_y;
  float* film_z;
  int32_t* alive;       // [depth], zeroed by the caller
  int32_t* next_pixel;  // [1], the pixel counter, zeroed by the caller
  uint32_t* keys;       // [2 * depth] scratch for the shade keys when they
                        // exceed shared memory
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

#ifdef PTT_COUNT_LANES
// Measuring builds only (scripts/torch_bench_kernels.py): lane-bounces
// issued (32 for each step in which a warp bounces) and live.
__device__ unsigned long long ptt_lane_counts[2];
#endif

// Bytes of the tables' part of the iteration kernel's dynamic shared memory
// (16-byte aligned), the shade keys and alive counters after it.
__host__ __device__ inline size_t iter_table_bytes(int num_geoms, int num_materials) {
  return (scene_table_bytes(num_geoms, num_materials) + 15) / 16 * 16;
}

// Dynamic shared memory: the scene's tables (STAGE_SCENE), then the shade
// keys [2 * depth] and alive counters [depth] (SHARED_KEYS; else the keys
// go to a.keys, each block writing the same words, and the counts straight
// to a.alive).
template <bool STAGE_SCENE, bool SHARED_KEYS>
__global__ void __launch_bounds__(PTT_THREADS) ptt_iteration_kernel(const PttIterArgs a) {
  const PttScene sh_scene = load_scene<STAGE_SCENE>(a.scene, ptt_smem);
  const int depth = a.depth;
  uint32_t* keys = a.keys;
  int32_t* cnt = a.alive;
  if (SHARED_KEYS) {
    keys = reinterpret_cast<uint32_t*>(
        ptt_smem + (STAGE_SCENE ? iter_table_bytes(a.num_geoms, a.num_materials) : 0));
    cnt = reinterpret_cast<int32_t*>(keys + 2 * depth);
  }
  for (int d = threadIdx.x; d < depth; d += blockDim.x) {
    shade_stage_key(a.iter_key[0], a.iter_key[1], (uint32_t)d, &keys[2 * d], &keys[2 * d + 1]);
    if (SHARED_KEYS) cnt[d] = 0;
  }
  __syncthreads();  // also orders load_scene's writes before the first read

  const uint32_t n = (uint32_t)a.n;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned below = (1u << lane) - 1u;
  IterLane l;
  l.pixel = -1;
  l.ray.bounces = 0;
  bool more = true;  // the counter has pixels left (warp-uniform)
  for (;;) {
    if (l.pixel >= 0 && l.ray.bounces <= 0) lane_finish(l, a.film_x, a.film_y, a.film_z);
    if (more) {
      const unsigned free_lanes = __ballot_sync(0xffffffffu, l.pixel < 0);
      const int k = __popc(free_lanes);
      if (k >= PTT_REFILL_MIN) {
        int base = 0;
        if (lane == 0) base = atomicAdd(a.next_pixel, k);
        base = __shfl_sync(0xffffffffu, base, 0);
        if (l.pixel < 0) {
          const int p = base + __popc(free_lanes & below);
          if (p < a.n) {
            lane_start(l, p, a.cam, a.width, a.height, depth, n, a.cam_key[0], a.cam_key[1]);
          }
        }
        more = base + k < a.n;
      }
    }
    const unsigned held = __ballot_sync(0xffffffffu, l.pixel >= 0);
    if (!held && !more) break;
    const bool live = l.pixel >= 0 && l.ray.bounces > 0;
#ifdef PTT_COUNT_LANES
    const unsigned live_lanes = __ballot_sync(0xffffffffu, live);
    if (lane == 0 && live_lanes) {
      atomicAdd(&ptt_lane_counts[0], 32ull);
      atomicAdd(&ptt_lane_counts[1], (unsigned long long)__popc(live_lanes));
    }
#endif
    const int d = live ? lane_bounce(sh_scene, l, keys, depth, n) : -1;
    const unsigned counted = __ballot_sync(0xffffffffu, d >= 0);
    if (d >= 0) {
      const unsigned peers = __match_any_sync(counted, d);
      if ((int)lane == __ffs(peers) - 1) atomicAdd(&cnt[d], __popc(peers));
    }
  }
  if (SHARED_KEYS) {
    __syncthreads();
    for (int d = threadIdx.x; d < depth; d += blockDim.x) {
      if (cnt[d]) atomicAdd(&a.alive[d], cnt[d]);
    }
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

// The persistent grid of the iteration kernel: as many blocks as the SMs
// hold at once at this shared memory, and no more than the pixels need.
template <bool STAGE_SCENE, bool SHARED_KEYS>
static cudaError_t launch_iteration(const PttIterArgs& a, size_t smem, cudaStream_t stream) {
  const auto kernel = ptt_iteration_kernel<STAGE_SCENE, SHARED_KEYS>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, device = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, PTT_THREADS, smem);
  if (err != cudaSuccess) return err;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const long long need = blocks_for(a.n);
  kernel<<<(unsigned)(resident < need ? resident : need), PTT_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

extern "C" {

// Struct sizes and offsets, checked against the ctypes mirror at load time.
int ptt_abi(int32_t* out, int32_t len) {
  const int32_t v[] = {
      (int32_t)sizeof(PttScene),
      (int32_t)sizeof(PttCamera),
      (int32_t)sizeof(PttIterArgs),
      (int32_t)offsetof(PttIterArgs, next_pixel),
      (int32_t)offsetof(PttIterArgs, keys),
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
  if (a->n <= 0) return (int)cudaGetLastError();
  // Shared memory: the keys and counters first (12 B a depth), then the
  // tables if they fit beside them.
  const size_t keys = (size_t)a->depth * (2 * sizeof(uint32_t) + sizeof(int32_t));
  const size_t tables = iter_table_bytes(a->num_geoms, a->num_materials);
  const bool shared_keys = keys <= PTT_SMEM_LIMIT;
  const bool stage_scene = tables + (shared_keys ? keys : 0) <= PTT_SMEM_LIMIT;
  if (!shared_keys && a->keys == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = (stage_scene ? tables : 0) + (shared_keys ? keys : 0);
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (stage_scene) {
    err = shared_keys ? launch_iteration<true, true>(*a, smem, st)
                      : launch_iteration<true, false>(*a, smem, st);
  } else {
    err = shared_keys ? launch_iteration<false, true>(*a, smem, st)
                      : launch_iteration<false, false>(*a, smem, st);
  }
  if (err != cudaSuccess) return (int)err;
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

#ifdef PTT_COUNT_LANES
// The measuring build's lane counts since the last reset: out[0] issued,
// out[1] live; reset: zero them after reading.  Synchronises the device.
int ptt_lane_counts_read(unsigned long long* out, int reset) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out, ptt_lane_counts, 2 * sizeof(*out));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[2] = {0ull, 0ull};
    err = cudaMemcpyToSymbol(ptt_lane_counts, zero, sizeof(zero));
  }
  return (int)err;
}
#endif

}  // extern "C"
