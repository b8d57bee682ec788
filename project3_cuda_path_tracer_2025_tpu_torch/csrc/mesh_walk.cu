// Hand-written Hopper (sm_90a) kernels of the mesh traversals beyond the
// mono band: meshes of 9 to 1,024 tiles of 1,024 triangles.
//
// They replace the TPU kernels of project3_cuda_path_tracer_2025_tpu/ops/intersect_mxu.py
//   ptt_planned_lanebest_kernel  _planned_kernel_lanebest :1330 (run_chunk_planned,
//                                up to 24 tiles): walk every plan entry;
//   ptt_planned_kernel           _planned_kernel :1231 (run_chunk_planned, up to 32
//                                tiles): the same walk with the early exit;
//   ptt_streamed_kernel          _streamed_kernel :1499 (run_streamed, up to 1,024
//                                tiles): the walk of a global plan, tile boxes and
//                                plan rows read from device memory;
//   ptt_binned_kernel            _binned_kernel :1848 (_run_binned): one tile per
//                                visit against 256 pair rows of 8-ray packets.
// All four compute one function, fixed by the candidate contract
// (intersect_mxu.py:106-131): per ray, the minimum t over the triangles of
// the tiles whose widened slab the ray itself enters before its t_limit,
// exact ties to the lowest global triangle id.  They differ in schedule only.
//
// Design.  One CUDA block is one plan block of 256 rays, one thread one ray
// (RAY_TILE is the plan's block, so a block reads one plan row).  A block
// walks its plan row in order (ascending entry bound): every thread takes
// the same tile at the same step, so the 80-byte coefficient rows a warp
// reads are the same address and broadcast from L1/L2.  A thread evaluates
// a tile only when its ray is live and a member of it (csrc/mesh_path.cuh,
// walk_visit); the others of the warp wait.  The tie rule in tile_fold
// (t < best, or t == best and a lower id) makes the result independent of
// the visit order, which is ascending entry bound, not ascending id.
//   #5 walks all cnt entries of its plan row.
//   #6 and #7 add the JAX package's two exact cuts: before each entry the
//   block votes (__syncthreads_or) and stops when the entry's bound exceeds
//   every live ray's running best (strictly: equal bounds may still tie);
//   and a ray skips a tile whose slab entry lies beyond its own running
//   best (the improvability gate, taken per ray instead of per block).
//   #5 and #6 stage the (at most 32) tile boxes in shared memory; #7 reads
//   its boxes and plan rows through the read-only cache (up to 1,024 tiles:
//   32 KB of boxes, 8 KB of plan row per block).  The TPU kernel streams
//   feature tiles HBM->VMEM with DMA double buffering; here the L1/L2
//   caches serve the coefficient rows (cp.async/TMA staging is later work).
//   #10 is stateless: block v takes visit v's tile (vt[v], -1 = an empty
//   slot region, which writes (inf, -1)); thread r takes pair row r, the
//   ray (src[32 v + r / 8]) * 8 + r % 8 of the packet in that slot.  The
//   per-ray reduce over a packet's visits and the bin construction stay in
//   torch (ops/intersect_mxu.py).
//
// What bounds them on the H100: operations.  Per candidate (ray, tile) pair
// a thread does 1,024 x (19 fused multiply-adds, one division, ~12
// compares) against one 80-byte row per triangle shared by the warp; the
// rays' state (7 planes, 29 bytes a ray) and the plan are read once.
// Divergence is the cost beyond the bound: a warp runs a tile for as long
// as its slowest member, whatever number of its rays are members.  The
// coherence sort in front of the traversal is what keeps warps coherent.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// -shared -Xcompiler -fPIC (ops/kernels.py).  Plain C interface, loaded with
// ctypes; each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mesh_path.cuh"

struct PttWalkArgs {
  const float* ray[6];       // origin xyz, direction xyz [n]
  const uint8_t* live;       // bool [n]: active and inside the root box
  const float* tlim;         // [n]
  const float* coef;         // [ct * 1024, 20]
  const float* tile_aabb;    // [ct, 8]
  const float* center;       // [3]
  const int32_t* ids;        // [nb * ct] tile ids, front to back per block
  const float* tlo;          // [nb * ct] block entry bounds, ascending (inf = miss)
  const int32_t* cnt;        // [nb] candidate tiles per block
  float* out_t;              // [n]
  int32_t* out_tri;          // [n]
  float baby_eps;
  float eps_succ;            // nextafter(baby_eps, +inf)
  int32_t n, ct;
};

struct PttBinnedArgs {
  const float* ray[6];       // origin xyz, direction xyz [n]
  const uint8_t* live;       // bool [n]
  const float* tlim;         // [n]
  const float* coef;         // [ct * 1024, 20]
  const float* tile_aabb;    // [ct, 8]
  const float* center;       // [3]
  const int32_t* vt;         // [nv] tile per visit, -1 = empty
  const int32_t* src;        // [nv * 32] packet per slot, n_g = empty
  float* out_t;              // [nv * 256] per pair row
  int32_t* out_tri;          // [nv * 256]
  float baby_eps;
  float eps_succ;
  int32_t n, n_g, nv, ct;
};

// One block's walk of its plan row.  EXIT: the early exit and the per-ray
// improvability gate (#6, #7).  aabb: the tile boxes (shared or global).
template <bool EXIT>
__device__ __forceinline__ void walk_block(const PttWalkArgs& a, const float* aabb, V3 center) {
  const int b = blockIdx.x;
  const int idx = b * PTT_RAY_TILE + threadIdx.x;
  const bool in = idx < a.n;
  const V3 o = in ? v3(a.ray[0][idx], a.ray[1][idx], a.ray[2][idx]) : v3(0.0f, 0.0f, 0.0f);
  const V3 d = in ? v3(a.ray[3][idx], a.ray[4][idx], a.ray[5][idx]) : v3(0.0f, 0.0f, 0.0f);
  WalkRay r = walk_ray(center, o, d, in && a.live[idx] != 0, in ? a.tlim[idx] : 0.0f);
  const int cnt = __ldg(a.cnt + b);
  const int32_t* ids = a.ids + (size_t)b * a.ct;
  const float* tlo = a.tlo + (size_t)b * a.ct;
  for (int t = 0; t < cnt; ++t) {
    if (EXIT && !__syncthreads_or(walk_goes_on(r, __ldg(tlo + t)))) break;
    const int tile = __ldg(ids + t);
    walk_visit(r, a.coef, aabb + 8 * tile, tile, EXIT, a.baby_eps, a.eps_succ);
  }
  if (in) {
    a.out_t[idx] = r.best;
    a.out_tri[idx] = r.best_tri;
  }
}

template <bool EXIT>
__device__ __forceinline__ void walk_block_shared(const PttWalkArgs& a) {
  __shared__ float sh_aabb[PTT_PLANNED_MAX_CT * 8];
  for (int i = threadIdx.x; i < a.ct * 8; i += blockDim.x) sh_aabb[i] = a.tile_aabb[i];
  __syncthreads();
  walk_block<EXIT>(a, sh_aabb, v3(__ldg(a.center), __ldg(a.center + 1), __ldg(a.center + 2)));
}

__global__ void __launch_bounds__(PTT_RAY_TILE) ptt_planned_lanebest_kernel(const PttWalkArgs a) {
  walk_block_shared<false>(a);
}

__global__ void __launch_bounds__(PTT_RAY_TILE) ptt_planned_kernel(const PttWalkArgs a) {
  walk_block_shared<true>(a);
}

__global__ void __launch_bounds__(PTT_RAY_TILE) ptt_streamed_kernel(const PttWalkArgs a) {
  walk_block<true>(a, a.tile_aabb, v3(__ldg(a.center), __ldg(a.center + 1), __ldg(a.center + 2)));
}

__global__ void __launch_bounds__(PTT_RAY_TILE) ptt_binned_kernel(const PttBinnedArgs a) {
  const int v = blockIdx.x;
  const int row = threadIdx.x;
  const int tile = __ldg(a.vt + v);
  float t = ptt_inf();
  int32_t tri = -1;
  if (tile >= 0) {
    const int p = __ldg(a.src + (size_t)v * (PTT_RAY_TILE / PTT_BINNED_G) + row / PTT_BINNED_G);
    const long long ray = (long long)p * PTT_BINNED_G + row % PTT_BINNED_G;
    if (p < a.n_g && ray < a.n) {
      const V3 o = v3(a.ray[0][ray], a.ray[1][ray], a.ray[2][ray]);
      const V3 d = v3(a.ray[3][ray], a.ray[4][ray], a.ray[5][ray]);
      binned_pair(a.coef, a.tile_aabb + 8 * tile, tile,
                  v3(__ldg(a.center), __ldg(a.center + 1), __ldg(a.center + 2)), o, d,
                  a.live[ray] != 0, a.tlim[ray], a.baby_eps, a.eps_succ, &t, &tri);
    }
  }
  const size_t out = (size_t)v * PTT_RAY_TILE + row;
  a.out_t[out] = t;
  a.out_tri[out] = tri;
}

static unsigned blocks_for(long long n) {
  return (unsigned)((n + PTT_RAY_TILE - 1) / PTT_RAY_TILE);
}

extern "C" {

// Struct sizes and offsets, checked against the ctypes mirror at load time.
int ptt_walk_abi(int32_t* out, int32_t len) {
  const int32_t v[] = {
      (int32_t)sizeof(PttWalkArgs),
      (int32_t)offsetof(PttWalkArgs, baby_eps),
      (int32_t)offsetof(PttWalkArgs, n),
      (int32_t)sizeof(PttBinnedArgs),
      (int32_t)offsetof(PttBinnedArgs, baby_eps),
      (int32_t)offsetof(PttBinnedArgs, n),
      PTT_TRI_TILE,
      PTT_COEF_W,
      PTT_RAY_TILE,
      PTT_BINNED_G,
      PTT_PLANNED_MAX_CT,
      PTT_STREAMED_MAX_CT,
  };
  const int32_t count = (int32_t)(sizeof(v) / sizeof(v[0]));
  for (int32_t i = 0; i < count && i < len; ++i) out[i] = v[i];
  return count;
}

// kind: 0 planned lane-best (#5), 1 planned (#6), 2 streamed (#7).
int ptt_launch_walk(const PttWalkArgs* a, int32_t kind, void* stream) {
  const int max_ct = kind == 2 ? PTT_STREAMED_MAX_CT : PTT_PLANNED_MAX_CT;
  if (a->ct < 1 || a->ct > max_ct || kind < 0 || kind > 2) return (int)cudaErrorInvalidValue;
  if (a->n > 0) {
    const unsigned grid = blocks_for(a->n);
    cudaStream_t s = (cudaStream_t)stream;
    if (kind == 0) {
      ptt_planned_lanebest_kernel<<<grid, PTT_RAY_TILE, 0, s>>>(*a);
    } else if (kind == 1) {
      ptt_planned_kernel<<<grid, PTT_RAY_TILE, 0, s>>>(*a);
    } else {
      ptt_streamed_kernel<<<grid, PTT_RAY_TILE, 0, s>>>(*a);
    }
  }
  return (int)cudaGetLastError();
}

int ptt_launch_binned(const PttBinnedArgs* a, void* stream) {
  if (a->ct < 1 || a->ct > PTT_STREAMED_MAX_CT) return (int)cudaErrorInvalidValue;
  if (a->nv > 0) {
    ptt_binned_kernel<<<(unsigned)a->nv, PTT_RAY_TILE, 0, (cudaStream_t)stream>>>(*a);
  }
  return (int)cudaGetLastError();
}

const char* ptt_walk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
