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
//   path-state planes out, its uniforms given as [3, n] or drawn inline.
// ptt_uniforms_kernel draws jax.random.uniform's [k, n] rows with the same
// in-kernel Threefry the iteration kernel uses (utils/prng.py::uniforms on
// a CUDA device; the camera's uniforms of megakernel_iteration), or the
// columns [base, base + ln) of the [k, rng_n] rows: a block of pixels of a
// sharded or chunked frame.
//
// What bounds them on the H100: arithmetic, not bytes.  The bounce kernel
// moves 84 B per ray per bounce with the uniforms drawn inline (9 floats +
// 1 int in and out, the pixel) and the iteration kernel 24 B of film per pixel per
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
// A counting variant of the iteration kernel (COUNT_LOBES, launched when
// PttIterArgs.lobes is set) also tallies each lobe's scatters at each depth
// into lobes[depth, PTT_LOBES], in shared memory beside the alive counters
// and grouped the same way (one shared atomic for each group of a warp's
// lanes that scattered by one lobe at one depth), flushed at the block's
// end.  The timed path never launches it: the other instantiations compile
// without a trace of it.
//
// The bounce kernel has no new pixels to take, but the live rays of a
// bounce are a fraction of its n (a half to a fifth after the first
// bounces of cornell_dof.json), spread over warps of 32 consecutive rays.
// So it packs them into full warps: a persistent grid in which each warp
// takes chunks of 32 consecutive rays from a grid-wide counter (one
// atomicAdd a chunk; the last warp to finish zeroes it for the next launch,
// so no launch resets it), reads their bounces coalesced, copies the dead
// rays' planes through, and appends the live rays' indices to its queue in
// shared memory (ballot and popc); whenever the queue holds 32 it bounces
// them as one full warp, each ray read and written at its own index.  A
// chunk that is live whole, with the queue empty, bounces in place (every
// ray of the first bounce).  Both go through one call site of the bounce,
// so the loop holds one copy of its body: with a copy for each, the
// mixed steps of the second bounce ran up to twice as long (PERF.md §6).  At the end the block's leftovers are dealt over its threads in
// order, so they fill whole warps too.  The uniforms are drawn inline,
// only for the live rays, at their pixels' counters (the mesh shade's and
// the JAX package's draw3 counters), which saves the [3, n] plane and its
// launch; the [3, n] form stays.  The bounce takes the nearest prim's
// normal once after the prim loop, as the iteration kernel does.  A ray's
// output depends only on its own planes and pixel, so any schedule gives
// the per-ray schedule's outputs bit for bit.  A counting build
// (-DPTT_COUNT_LANES) counts both kernels' lane-bounces.
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
  int32_t* lobes;        // [depth, PTT_LOBES] += each lobe's scatters at each
                         // depth (the counting variant), or null
};

struct PttBounceArgs {
  const PttScene* scene;
  const float* in_f[9];  // origin xyz, direction xyz, color rgb
  const int32_t* in_bounces;
  const float* u;        // [3, n], or null: each live ray draws its own
  const int32_t* pixel;  // [n] (u null): ray i draws at counters j * rng_n + pixel[i]
  int32_t* chunks;       // [2]: the chunk counter and the warps done, zero
                         // between launches (the last warp to finish resets
                         // both); one a stream, so launches never share it
  float* out_f[9];
  int32_t* out_bounces;
  uint32_t k0, k1;       // the bounce's shade key (u null)
  uint32_t rng_n;        // the RNG stream's length (u null)
  int32_t n;
  int32_t num_geoms, num_materials;  // the scene's counts, for the launcher
};

extern __shared__ __align__(16) unsigned char ptt_smem[];

#ifdef PTT_COUNT_LANES
// Measuring builds only (scripts/torch_bench_kernels.py): lane-bounces
// issued (32 for each step in which a warp bounces) and live.
__device__ unsigned long long ptt_lane_counts[2];
// One warp step in which the lanes live_lanes bounce (every lane evaluates
// the argument: it may be a vote).
#define PTT_COUNT_STEP(live_lanes)                                              \
  {                                                                             \
    const unsigned ptt_live = (live_lanes);                                     \
    if ((threadIdx.x & 31u) == 0 && ptt_live) {                                 \
      atomicAdd(&ptt_lane_counts[0], 32ull);                                    \
      atomicAdd(&ptt_lane_counts[1], (unsigned long long)__popc(ptt_live));     \
    }                                                                           \
  }
#else
#define PTT_COUNT_STEP(live_lanes)
#endif

// Bytes of the tables' part of the iteration kernel's dynamic shared memory
// (16-byte aligned), the shade keys and alive counters after it.
__host__ __device__ inline size_t iter_table_bytes(int num_geoms, int num_materials) {
  return (scene_table_bytes(num_geoms, num_materials) + 15) / 16 * 16;
}

// Dynamic shared memory: the scene's tables (STAGE_SCENE), then the shade
// keys [2 * depth], alive counters [depth] and, COUNT_LOBES, the lobe tally
// [depth * PTT_LOBES] (SHARED_KEYS; else the keys go to a.keys, each block
// writing the same words, and the counts straight to a.alive and a.lobes).
template <bool STAGE_SCENE, bool SHARED_KEYS, bool COUNT_LOBES>
__global__ void __launch_bounds__(PTT_THREADS) ptt_iteration_kernel(const PttIterArgs a) {
  const PttScene sh_scene = load_scene<STAGE_SCENE>(a.scene, ptt_smem);
  const int depth = a.depth;
  uint32_t* keys = a.keys;
  int32_t* cnt = a.alive;
  int32_t* lobes = a.lobes;
  if (SHARED_KEYS) {
    keys = reinterpret_cast<uint32_t*>(
        ptt_smem + (STAGE_SCENE ? iter_table_bytes(a.num_geoms, a.num_materials) : 0));
    cnt = reinterpret_cast<int32_t*>(keys + 2 * depth);
    if constexpr (COUNT_LOBES) {
      lobes = cnt + depth;
      for (int i = threadIdx.x; i < depth * PTT_LOBES; i += blockDim.x) lobes[i] = 0;
    }
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
    PTT_COUNT_STEP(__ballot_sync(0xffffffffu, live))
    int slot = -1;  // COUNT_LOBES: the lane's cell of the lobe tally, -1 for none
    int d;
    if constexpr (COUNT_LOBES) {
      d = live ? lane_bounce_lobe(sh_scene, l, keys, depth, n, &slot) : -1;
    } else {
      d = live ? lane_bounce(sh_scene, l, keys, depth, n) : -1;
    }
    const unsigned counted = __ballot_sync(0xffffffffu, d >= 0);
    if (d >= 0) {
      const unsigned peers = __match_any_sync(counted, d);
      if ((int)lane == __ffs(peers) - 1) atomicAdd(&cnt[d], __popc(peers));
    }
    if constexpr (COUNT_LOBES) {
      const unsigned scattered = __ballot_sync(0xffffffffu, slot >= 0);
      if (slot >= 0) {
        const unsigned peers = __match_any_sync(scattered, slot);
        if ((int)lane == __ffs(peers) - 1) atomicAdd(&lobes[slot], __popc(peers));
      }
    }
  }
  if (SHARED_KEYS) {
    __syncthreads();
    for (int d = threadIdx.x; d < depth; d += blockDim.x) {
      if (cnt[d]) atomicAdd(&a.alive[d], cnt[d]);
    }
    if constexpr (COUNT_LOBES) {
      for (int i = threadIdx.x; i < depth * PTT_LOBES; i += blockDim.x) {
        if (lobes[i]) atomicAdd(&a.lobes[i], lobes[i]);
      }
    }
  }
}

// The bounce kernel's warps and each warp's queue of live rays in shared
// memory: up to 31 held over from the chunks before and one chunk's 32.
#define PTT_WARPS (PTT_THREADS / 32)
#define PTT_QUEUE 64

// Live ray i: its planes in, one bounce, its planes out.
template <bool INLINE>
__device__ __forceinline__ void bounce_one(const PttBounceArgs& a, const PttScene& s, int i) {
  Ray ray;
  ray.o = v3(a.in_f[0][i], a.in_f[1][i], a.in_f[2][i]);
  ray.d = v3(a.in_f[3][i], a.in_f[4][i], a.in_f[5][i]);
  ray.c = v3(a.in_f[6][i], a.in_f[7][i], a.in_f[8][i]);
  ray.bounces = a.in_bounces[i];
  float u[3];
  if (INLINE) {
    draw3(a.k0, a.k1, a.rng_n, (uint32_t)a.pixel[i], u);
  } else {
    const size_t n = (size_t)a.n;
    u[0] = a.u[i];
    u[1] = a.u[n + i];
    u[2] = a.u[2 * n + i];
  }
  bounce_live(s, ray, u[0], u[1], u[2]);
  a.out_f[0][i] = ray.o.x;
  a.out_f[1][i] = ray.o.y;
  a.out_f[2][i] = ray.o.z;
  a.out_f[3][i] = ray.d.x;
  a.out_f[4][i] = ray.d.y;
  a.out_f[5][i] = ray.d.z;
  a.out_f[6][i] = ray.c.x;
  a.out_f[7][i] = ray.c.y;
  a.out_f[8][i] = ray.c.z;
  a.out_bounces[i] = ray.bounces;
}

// The warp's next chunk of 32 rays from the grid-wide counter.
__device__ __forceinline__ long long next_chunk(const PttBounceArgs& a) {
  int got = 0;
  if ((threadIdx.x & 31u) == 0) got = atomicAdd(&a.chunks[0], 1);
  return __shfl_sync(0xffffffffu, got, 0);
}

// Dynamic shared memory: the scene's tables (STAGE_SCENE), then the warps'
// queues.  INLINE: the uniforms drawn in the kernel (a.u null).
template <bool STAGE_SCENE, bool INLINE>
__global__ void __launch_bounds__(PTT_THREADS) ptt_bounce_kernel(const PttBounceArgs a) {
  __shared__ int32_t held_of[PTT_WARPS];
  const PttScene sh_scene = load_scene<STAGE_SCENE>(a.scene, ptt_smem);
  int32_t* queues = reinterpret_cast<int32_t*>(
      ptt_smem + (STAGE_SCENE ? iter_table_bytes(a.num_geoms, a.num_materials) : 0));
  const unsigned lane = threadIdx.x & 31u, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int32_t* q = queues + warp * PTT_QUEUE;
  __syncthreads();  // orders load_scene's writes before the first read

  const long long chunks = ((long long)a.n + 31) / 32;
  const long long warps = (long long)gridDim.x * PTT_WARPS;
  int held = 0;  // live rays in the warp's queue (warp-uniform)
  for (long long c = next_chunk(a); c < chunks; c = next_chunk(a)) {
    const long long i = c * 32 + lane;
    const bool in = i < a.n;
    const int32_t b = in ? a.in_bounces[i] : 0;
    const bool live = b > 0;
    const unsigned lv = __ballot_sync(0xffffffffu, live);
    int32_t r = -1;  // the ray this lane bounces at this step
    if (held == 0 && lv == 0xffffffffu) {  // a whole chunk live: bounce it in place
      r = (int32_t)i;
    } else {
      if (in && !live) {  // a dead ray keeps its planes
#pragma unroll
        for (int k = 0; k < 9; ++k) a.out_f[k][i] = a.in_f[k][i];
        a.out_bounces[i] = b;
      }
      if (live) q[held + __popc(lv & below)] = (int32_t)i;
      held += __popc(lv);
      __syncwarp();
      if (held >= 32) {  // one full warp of live rays
        r = q[lane];
        held -= 32;
        const int32_t kept = lane < (unsigned)held ? q[32 + lane] : 0;
        __syncwarp();
        if (lane < (unsigned)held) q[lane] = kept;
        __syncwarp();
      }
    }
    PTT_COUNT_STEP(__ballot_sync(0xffffffffu, r >= 0))
    if (r >= 0) bounce_one<INLINE>(a, sh_scene, r);  // one call site: one copy of the body
  }
  // The last warp to finish zeroes the counter for the next launch.
  if (lane == 0 && atomicAdd(&a.chunks[1], 1) == (int)warps - 1) {
    atomicExch(&a.chunks[0], 0);
    atomicExch(&a.chunks[1], 0);
  }
  // The block's leftovers (under 32 a warp), dealt over its threads in order:
  // thread j takes the block's j-th leftover ray, so they fill whole warps.
  if (lane == 0) held_of[warp] = held;
  __syncthreads();
  int start = 0, r = -1;
#pragma unroll
  for (int w = 0; w < PTT_WARPS; ++w) {
    const int h = held_of[w];
    const int j = (int)threadIdx.x - start;
    if (j >= 0 && j < h) r = queues[w * PTT_QUEUE + j];
    start += h;
  }
  PTT_COUNT_STEP(__ballot_sync(0xffffffffu, r >= 0))
  if (r >= 0) bounce_one<INLINE>(a, sh_scene, r);
}

__global__ void __launch_bounds__(PTT_THREADS) ptt_uniforms_kernel(uint32_t k0, uint32_t k1,
                                                                   uint32_t ln, uint32_t total,
                                                                   uint32_t base, uint32_t rng_n,
                                                                   float* out) {
  const uint32_t flat = blockIdx.x * blockDim.x + threadIdx.x;
  if (flat < total) out[flat] = uniform_block(k0, k1, ln, base, rng_n, flat);
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

// A persistent grid (the iteration and bounce kernels): as many blocks as
// the SMs hold at once at this shared memory, and no more than the n rays
// or pixels need at one a thread.
template <typename A>
static cudaError_t launch_persistent(void (*kernel)(const A), const A& a, size_t smem,
                                     cudaStream_t stream) {
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

// The iteration kernel of one table and key placement, counting the lobes
// where a.lobes is set.
template <bool STAGE_SCENE, bool SHARED_KEYS>
static cudaError_t launch_iteration(const PttIterArgs& a, size_t smem, cudaStream_t st) {
  return a.lobes
             ? launch_persistent(ptt_iteration_kernel<STAGE_SCENE, SHARED_KEYS, true>, a, smem, st)
             : launch_persistent(ptt_iteration_kernel<STAGE_SCENE, SHARED_KEYS, false>, a, smem,
                                 st);
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
      (int32_t)offsetof(PttBounceArgs, pixel),
      (int32_t)offsetof(PttBounceArgs, chunks),
      (int32_t)offsetof(PttBounceArgs, k0),
      (int32_t)offsetof(PttBounceArgs, n),
      (int32_t)sizeof(PttGeom),
      (int32_t)sizeof(PttMaterial),
      (int32_t)offsetof(PttScene, geoms),
      (int32_t)offsetof(PttIterArgs, lobes),
      PTT_LOBES,
  };
  const int32_t count = (int32_t)(sizeof(v) / sizeof(v[0]));
  for (int32_t i = 0; i < count && i < len; ++i) out[i] = v[i];
  return count;
}

int ptt_launch_iteration(const PttIterArgs* a, void* stream) {
  if (a->depth < 0 || a->num_geoms < 0 || a->num_materials < 0) return (int)cudaErrorInvalidValue;
  if (a->n <= 0) return (int)cudaGetLastError();
  // Shared memory: the keys and counters first (12 B a depth, and 20 B more
  // with the lobe tally), then the tables if they fit beside them.
  const size_t keys = (size_t)a->depth * (2 * sizeof(uint32_t) + sizeof(int32_t) +
                                          (a->lobes ? PTT_LOBES * sizeof(int32_t) : 0));
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
  if (a->u == nullptr && a->pixel == nullptr) return (int)cudaErrorInvalidValue;
  if (a->chunks == nullptr) return (int)cudaErrorInvalidValue;
  if (a->n <= 0) return (int)cudaGetLastError();
  // Shared memory: the tables if they fit, then the warps' queues.
  const size_t queues = (size_t)PTT_WARPS * PTT_QUEUE * sizeof(int32_t);
  const size_t tables = iter_table_bytes(a->num_geoms, a->num_materials);
  const bool stage_scene = tables + queues <= PTT_SMEM_LIMIT;
  const size_t smem = (stage_scene ? tables : 0) + queues;
  const bool inline_u = a->u == nullptr;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (stage_scene) {
    err = inline_u ? launch_persistent(ptt_bounce_kernel<true, true>, *a, smem, st)
                   : launch_persistent(ptt_bounce_kernel<true, false>, *a, smem, st);
  } else {
    err = inline_u ? launch_persistent(ptt_bounce_kernel<false, true>, *a, smem, st)
                   : launch_persistent(ptt_bounce_kernel<false, false>, *a, smem, st);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int ptt_launch_uniforms(uint32_t k0, uint32_t k1, uint32_t ln, uint32_t k, uint32_t base,
                        uint32_t rng_n, float* out, void* stream) {
  const uint32_t total = ln * k;
  if (total > 0) {
    ptt_uniforms_kernel<<<blocks_for(total), PTT_THREADS, 0, (cudaStream_t)stream>>>(
        k0, k1, ln, total, base, rng_n, out);
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
