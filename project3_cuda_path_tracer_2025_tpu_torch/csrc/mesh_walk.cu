// Hand-written Hopper (sm_90a) kernels of the mesh traversals, over tiles
// of 1,024 triangles: the mono walk (up to 8 tiles), the planned walks and
// the sweep (up to 32 tiles a call; a larger mesh is a chain of calls,
// ops/intersect_mxu.py::_chain), the streamed and super-tile walks and the
// binned visits (up to 1,024 tiles), and the tile plan's slab stage.
//
// They replace the TPU kernels of project3_cuda_path_tracer_2025_tpu/ops/intersect_mxu.py
//   ptt_mono_kernel              _mono_kernel :1423 (run_mono, up to 8 tiles):
//                                every tile in ascending id behind a root cull,
//                                ids of the table's padding rows written -1;
//   ptt_planned_lanebest_kernel  _planned_kernel_lanebest :1330 (run_chunk_planned,
//                                up to 24 tiles): walk every plan entry;
//   ptt_planned_kernel           _planned_kernel :1231 (run_chunk_planned, up to 32
//                                tiles): the same walk with the early exit;
//   ptt_streamed_kernel          _streamed_kernel :1499 (run_streamed, up to 1,024
//                                tiles): the walk of a global plan, tile boxes and
//                                plan rows read from device memory;
//   ptt_streamed_super_kernel    _streamed_super_kernel :1633 (run_streamed_super):
//                                the streamed walk over a plan of super-tiles
//                                of 8 tiles;
//   ptt_binned_kernel            _binned_kernel :1848 (_run_binned): one tile per
//                                visit against 256 pair rows of 8-ray packets;
//   ptt_sweep_kernel             _intersect_kernel :671 (run_chunk, up to 32 tiles):
//                                every tile in ascending id, no plan;
//   ptt_plan_prepass_kernel      _plan_prepass_kernel :946 (_build_tile_plan_pallas):
//                                per (ray block, tile), whether any ray enters
//                                and the least entry distance.
// and the two kernels of that package's scripts/profile_epilogue.py, variants
// of #5 and #4 that take tiles in ascending id (the TPU kernels fold with a
// strict "<"):
//   ptt_lb_asc_kernel            lb_asc_kernel :239 (flavors lb_asc, lb_mm): the
//                                lane-best walk over a plan row sorted by tile id;
//   ptt_epilogue_mono_kernel     mono_kernel :285 (flavors full, gate, mm): no
//                                plan, every tile in order, one skip of a block
//                                with no live ray.
// The traversals compute one function, fixed by the candidate contract
// (intersect_mxu.py:106-131): per ray, the minimum t over the triangles of
// the tiles whose widened slab the ray itself enters before its t_limit,
// exact ties to the lowest global triangle id.  They differ in schedule only.
//
// Design.  One CUDA block is one plan block of 256 rays (RAY_TILE is the
// plan's block, so a block reads one plan row).  A block walks its plan row
// in order (ascending entry bound): every thread takes the same tile at the
// same step, so the coefficient rows a warp reads are the same tile's and
// come from L1/L2.  The tie rule in tile_fold (t < best, or t == best and a
// lower id) makes the result independent of the visit order, which is
// ascending entry bound, not ascending id.
//   The walks #4-#10 share the block schedule and one per-tile body.
//   #5 walks all cnt entries of its plan row.  #6, #7 and #8 add the JAX
//   package's two exact cuts: before each entry the block votes and stops
//   when the entry's bound exceeds every live ray's running best
//   (strictly: equal bounds may still tie); and a ray skips a tile whose
//   slab entry lies beyond its own running best (the improvability gate,
//   taken per ray instead of per block; #5 and #9 take it too, exact in any
//   walk; #4 takes it too).  #4, #5, #6 and #9 stage the (at most 32) tile
//   boxes in shared memory.  #13a and #13b (below) run the block schedule
//   too: lb_asc through spread_entry, the full-width flavors through their
//   own per-tile steps.
//   The block schedule.  In the per-ray schedule that the walks had before
//   it a member ray walked its tile's 1,024 triangles alone while the rest
//   of its warp waited, a chain of ~1 us a block-visit at 0.5-1.6% of the
//   walks' operations bound.  The TPU kernels evaluate a 256-ray block
//   against a whole tile as one matmul, their feature tiles double-buffered
//   HBM->VMEM by DMA.  Here, per tile, the rays that take it (live, member,
//   past the gate) are listed in shared memory (warp ballots and a prefix
//   over the eight ray warps), and the list's (ray, triangle) pairs are
//   dealt over the block: PTT_SPREAD_THREADS = 512 threads, thread t holding
//   the rows of triangles t and t + 512 in registers and evaluating them
//   against every listed ray.  Each ray's running best is a 64-bit key in
//   shared memory that the threads lower with atomicMin (csrc/mesh_path.cuh,
//   walk_key: the ordered bits of t, then tri + 1), the lexicographic
//   minimum the per-ray fold computes in any order, so the results are bit
//   for bit the per-ray walk's.  One device function, spread_entry, is that
//   per-tile step for all seven kernels; they differ only in which tiles
//   they feed it and which votes and gates come with them.  Shared memory:
//   the 256 rays' features (10 KB), keys (2 KB), the list with its pair
//   windows (3 KB), 64 B of counts: 15,424 B (#4, #5, #6 and #9 add 1 KB of
//   boxes), so registers set the occupancy, one block of 16 warps an SM.
//   Measured on #7 (scripts/torch_ab_streamed_walk.py, PERF.md): 512
//   threads beat 256 (two blocks an SM, four triangles a thread) and 1,024
//   (one triangle a thread) summed over a frame's eight sorted bounces at
//   80k and 500k; staging the next entry's rows in shared memory by
//   cp.async (two 80 KB stages, one block an SM) lost to reading them from
//   L2 into registers on every bounce, and was left out.
//   #7 reads its boxes and plan rows through the read-only cache (up to
//   1,024 tiles: 32 KB of boxes, 8 KB of plan row per block) and feeds each
//   plan entry's tile to spread_entry behind the exit vote.  #6 is the same
//   loop over a plan of at most 32 tiles with the boxes in shared memory;
//   #5 is #6 with a vote that always goes on.  One template, plan_spread,
//   is the loop of all three.
//   #8 walks a plan whose entries are super-tiles (8 contiguous tiles, the
//   box their envelope).  Per entry: one exit vote (strict: the super box's
//   entry is at or below every member tile's, so nothing past it can
//   improve or tie), taken at the first member tile's barrier; one gate per
//   ray on the super box (super_take), against the best as it stood before
//   the entry; then each member tile sid * 8 + k < ct through spread_entry,
//   taken only by rays past the gate, each with its own window and
//   improvability gate.  The TPU kernel moves a super-tile's features in one
//   DMA and so wants tables padded to whole super-tiles;
//   ops/intersect_mxu.py::build_mxu_tables pads them so when the switch is
//   on, as the JAX package does.  A padding tile's box is inverted (lo
//   1e30, hi -1e30) and its rows are zero.  The slab test is symmetric in
//   lo and hi, so every ray would take it and evaluate 1,024 pairs that
//   never accept (det = 0): the kernel skips it (padding_tile), which
//   changes no result.  An unpadded table works too (no tile past ct).
//   #9 has no plan and no exit vote: tiles 0..ct-1 in ascending id, each
//   through spread_entry, the boxes in shared memory.  In ascending order
//   the key minimum is the TPU kernel's strict "<" (a later tile holds
//   only higher ids), and each ray's gate reads its best after the tile
//   before, as the per-ray sweep did.  A tile no ray takes costs one
//   barrier: the TPU kernel's per-block any_hit cull.  A block with no live
//   ray (a chain call masks the rays that miss its chunk) is skipped whole.
//   #4 is #9's loop (one template, sweep_spread) over at most 8 tiles with
//   the two steps the mono kernel adds: each ray's root cull (the k = 2
//   widened root_box, the envelope of the boxes) joins its live flag before
//   the block's vote, so
//   a block of culled rays is skipped whole, and a tri at or past num_tris
//   is written -1, after the minimum.
//   #10 is stateless: block v takes visit v's tile (vt[v], -1 = an empty
//   slot region, which writes (inf, -1)) through one spread_entry; owner
//   thread r takes pair row r, the ray (src[32 v + r / 8]) * 8 + r % 8 of
//   the packet in that slot.  Pair rows whose ray is not a member of the
//   tile, dead, or an empty slot's take nothing: the pairs of the rows that
//   are members are dealt over the block.  The per-ray reduce over a
//   packet's visits stays in torch (ops/intersect_mxu.py::binned_reduce);
//   the bins come from the four kernels of csrc/mesh_bins.cu.
//   #11 tests only the live rays of a ray block: its CTA stages them,
//   compacted (warp ballots and a prefix over the warps; recentred origin,
//   reciprocal direction and t_limit, two float4 a ray), in shared memory,
//   and deals the L x Ct pairs over every thread, whatever Ct: each warp
//   takes tiles, its lanes the live rays, and two warp votes give the
//   tile's h (any) and lb (the minimum of the keys' int bits: for the
//   non-negative keys their float order).  A sorted bounce's live rays fill
//   few blocks (80k, bounce 0: 32,787 of 640,000 rays), so a CTA takes a
//   slice of PTT_PREPASS_SPLIT tiles of its block's row (a 2-D grid), and those
//   blocks' pairs spread over more SMs; a block with no live ray writes
//   (0, inf) and stops.  min and any do not depend on order, so (h, lb) are
//   bit-equal to the torch plan's.  Traffic: every ray's live flag, the
//   live rays' state (once for each slice of their row), [nb, ct] out.
//   #13a's exact flavor lb_asc is #5's loop, plan_spread<false, true>, fed
//   the ascending plan row: the same improvability gate, the same key
//   minimum, so against #5 it varies the visit order alone.  The TPU
//   kernel's fold, a strict "<" with no id compare, has no counterpart on
//   this schedule: a tile's pairs are evaluated by 512 threads at once and
//   folded by atomics in no order, so an equal t from two triangles of one
//   tile is resolved by the id in the key whatever the visit order.
//   #13b's "full" and "gate" and both floors are defined at full width:
//   every ray of a visiting block against every triangle of the tile
//   ("full": every tile of a block with a live ray; "gate": only the tiles
//   the block votes some live ray is a member of; the floors: the four
//   numerators and a minimum of det).  wide_spread deals those pairs over
//   the block as spread_entry deals a list's: thread t holds the rows of
//   triangles t and t + 512, each ray's features and pair window come from
//   shared memory (three float4 broadcasts), and the branch on a ray's
//   window is the same for every thread at each step.  A pair of a ray
//   that is not a member (or not live) costs its four numerators, kept live
//   so the flavor still pays for them; a member pair tests det and the u/v
//   conditions before the division (wide_key), so the division runs only
//   in a warp where some pair lies inside its triangle.  The floors' keys
//   (det, lane) are reduced over the warp (__reduce_min_sync on the high
//   word, then on the low word) and each lane lowers one ray's key a 32
//   rays, so their atomics do not serialise.  #13b's kernel is built for
//   two blocks an SM (kWideMinBlocks).  The "mm" flavors are timing
//   floors (wrong results by design), reachable from the measuring script
//   only.
//
// What bounds them on the H100: operations.  Per candidate (ray, tile) pair
// a thread does 1,024 x (19 fused multiply-adds, one division, ~12
// compares) against one 80-byte row per triangle shared by the warp; the
// rays' state (7 planes, 29 bytes a ray) and the plan are read once.
// In the per-ray schedule the walks had before, divergence was the cost
// beyond the bound: a warp ran a tile for as long as its slowest member,
// whatever number of its rays were members.  The block schedule removes
// that cost (every thread evaluates pairs); what it leaves is a
// tile-visit's fixed part (three barriers, the list, 80 KB of rows from L2)
// and a few live blocks an SM on the early bounces.  #13b's full-width
// flavors evaluate the pairs the function does not need by definition: their
// bound is the function's, and the numerators of every pair of a visiting
// block stand between the two.
// #11 is bound by operations: a slab test of ~34 per live (ray, tile) pair,
// against 1 byte a dead ray (its live flag), 28 a live one and 5 an output
// (80k, bounce 0: 2.6 M pairs against 2.5 MB).
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
  const float* saabb;        // [cs, 8] super-tile boxes (#8 only; its plan is [nb * cs])
  float* out_t;              // [n]
  int32_t* out_tri;          // [n]
  float baby_eps;
  float eps_succ;            // nextafter(baby_eps, +inf)
  int32_t n, ct;
  int32_t cs;                // super-tiles, ceil(ct / 8) (#8 only)
};                           // the sweep (#9) reads no plan field

struct PttPlanArgs {
  const float* ray[6];       // recentred origin xyz, direction xyz [nb * 256]
  const uint8_t* live;       // bool [nb * 256]
  const float* tlim;         // [nb * 256]
  const float* tile_aabb;    // [ct, 8]
  uint8_t* out_h;            // bool [nb, ct]: any live ray of the block enters the tile
  float* out_lb;             // [nb, ct] least entry distance, clamped at 0 (inf: none)
  int32_t nb, ct;
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

struct PttMonoArgs {
  const float* ray[6];       // origin xyz, direction xyz [n]
  const uint8_t* active;     // bool [n] (the kernel takes the root cull itself)
  const float* tlim;         // [n]
  const float* coef;         // [ct * 1024, 20]
  const float* tile_aabb;    // [ct, 8], ct <= 8
  const float* center;       // [3]
  const float* root_box;     // [8] the envelope of tile_aabb
  float* out_t;              // [n]
  int32_t* out_tri;          // [n]
  float baby_eps;
  float eps_succ;
  int32_t n, ct, num_tris, pad;
};

// Ray idx of the planes ray (origin xyz, direction xyz) as a walk sees it;
// a thread that owns no ray (in false) gets one that is not live.
__device__ __forceinline__ WalkRay load_ray(const float* const* ray, const uint8_t* live,
                                            const float* tlim, long long idx, bool in, V3 center) {
  const V3 o = in ? v3(ray[0][idx], ray[1][idx], ray[2][idx]) : v3(0.0f, 0.0f, 0.0f);
  const V3 d = in ? v3(ray[3][idx], ray[4][idx], ray[5][idx]) : v3(0.0f, 0.0f, 0.0f);
  return walk_ray(center, o, d, in && live[idx] != 0, in ? tlim[idx] : 0.0f);
}

__device__ __forceinline__ V3 load_center(const float* center) {
  return v3(__ldg(center), __ldg(center + 1), __ldg(center + 2));
}

// The block schedule of #4-#10 (csrc/mesh_path.cuh: walk_take,
// spread_load, spread_key, walk_key, walk_unkey): PTT_SPREAD_THREADS threads
// a block of 256 rays.  Thread t < 256 owns ray t of the block (its state,
// its share of an exit vote, its member test); for each tile every thread t
// takes triangles t + PTT_SPREAD_THREADS i of it.  The block's shared state:
struct SpreadShared {
  float f[10][PTT_RAY_TILE];                 // the rays' features
  unsigned long long key[PTT_RAY_TILE];      // each ray's running best as a key
  int list[PTT_RAY_TILE];                    // the rays that take the tile
  float lo[PTT_RAY_TILE], hi[PTT_RAY_TILE];  // and their pair windows
  int count[2][PTT_RAY_TILE / 32];           // takers per ray warp, by tile parity
};

// Thread tid's ray, ray idx of the planes (load_ray; a thread that owns
// none, or whose ray is not in, gets a ray that is not live), its features
// and key written for the block.  The first spread_entry's first barrier
// comes before they are read.
__device__ __forceinline__ WalkRay spread_ray(SpreadShared& sh, bool owner, V3 center,
                                              const float* const* ray, const uint8_t* live,
                                              const float* tlim, long long idx, bool in) {
  const int tid = threadIdx.x;
  const WalkRay r = load_ray(ray, live, tlim, idx, owner && in, center);
  if (owner) {
#pragma unroll
    for (int q = 0; q < 10; ++q) sh.f[q][tid] = r.f[q];
    sh.key[tid] = walk_key(r.best, r.best_tri);
  }
  return r;
}

// The per-entry body of the seven walks: one tile (row: its box) against
// the block's rays.  Each ray may take it (may: the thread's own condition
// besides walk_take's, e.g. a super-tile gate); the takers are listed in
// shared memory (warp ballots and a prefix over the eight ray warps), each
// thread's rows are evaluated against every listed ray, and each ray's key
// is lowered with atomicMin, then read back into r.  vote: the thread's
// share of an exit vote, taken at the barrier after the counts; when no
// thread votes to go on the body returns false and evaluates nothing.  A
// tile no ray takes costs that one barrier (the TPU kernel's any_hit cull).
// parity alternates from one call to the next: the counts are
// double-buffered, since a tile with no taker has no closing barrier.
__device__ __forceinline__ bool spread_entry(SpreadShared& sh, WalkRay& r, bool owner, bool may,
                                             bool vote, const float* coef, const float* row,
                                             int tile, int parity, float baby_eps,
                                             float eps_succ) {
  constexpr int kRayWarps = PTT_RAY_TILE / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float lo = 0.0f, hi = 0.0f;
  const bool take = may && walk_take(r, row, eps_succ, &lo, &hi);
  const unsigned ballot = __ballot_sync(0xFFFFFFFFu, take);
  int* count = sh.count[parity];
  if (owner && lane == 0) count[warp] = __popc(ballot);
  // The exit vote; also the barrier after the counts (and, on the first
  // call, the features and keys) are written.
  if (!__syncthreads_or(vote)) return false;
  int below = 0, m = 0;
#pragma unroll
  for (int w = 0; w < kRayWarps; ++w) {
    below += w < warp ? count[w] : 0;
    m += count[w];
  }
  if (m == 0) return true;  // the same for every thread
  if (take) {
    const int p = below + __popc(ballot & ((1u << lane) - 1u));
    sh.list[p] = tid;
    sh.lo[p] = lo;
    sh.hi[p] = hi;
  }
  __syncthreads();
  float k[PTT_SPREAD][PTT_COEF_W];
  spread_load(coef, tile, tid, k);
  const int32_t tri0 = tile * PTT_TRI_TILE + tid;
  for (int j = 0; j < m; ++j) {
    const int ray = sh.list[j];
    float f[10];
#pragma unroll
    for (int q = 0; q < 10; ++q) f[q] = sh.f[q][ray];
    const uint64_t key = spread_key(f, sh.lo[j], sh.hi[j], k, tri0, baby_eps);
    if (key != PTT_NO_KEY) atomicMin(&sh.key[ray], (unsigned long long)key);
  }
  __syncthreads();
  if (owner) walk_unkey(sh.key[tid], &r.best, &r.best_tri);
  return true;
}

// The owner's (t, tri) written for ray blockIdx.x * 256 + tid.  A tri at or
// past num_tris (#4: a padding row of the mono tables) is written as -1,
// after the minimum, as mono_ray clamps it: a padding row can only win
// where it accepts.
template <typename Args>
__device__ __forceinline__ void spread_out(const Args& a, const WalkRay& r, bool owner,
                                           int32_t num_tris = PTT_INT_MAX) {
  const int idx = blockIdx.x * PTT_RAY_TILE + threadIdx.x;
  if (owner && idx < a.n) {
    a.out_t[idx] = r.best;
    a.out_tri[idx] = r.best_tri >= num_tris ? -1 : r.best_tri;
  }
}

#define PTT_SPREAD_BOUNDS \
  __launch_bounds__(PTT_SPREAD_THREADS, PTT_SPREAD_THREADS >= 512 ? 1 : 512 / PTT_SPREAD_THREADS)

// #5, #6 and #7: each plan entry's tile through spread_entry.  EXIT (#6,
// #7): the block's exit vote on the entry's bound, taken at spread_entry's
// first barrier.  #5 votes to go on at every entry and so walks all cnt of
// them, as _planned_kernel_lanebest does (it reads no tlo).  walk_take's
// improvability gate (s.lo <= best) stays in #5 too: a tile whose entry
// lies strictly beyond the ray's running best holds no t that can win or
// tie, so the results are bit-equal with the gate or without it (the TPU
// kernel takes none).  SHARED_BOXES (#5, #6: at most 32 tiles): the tile
// boxes staged in shared memory as the sweep stages them; #7 (up to 1,024
// tiles) reads them through the read-only cache.  A block whose plan row
// is empty (cnt = 0, as in a chain call where no ray of the block can
// improve) writes its rays' (t_limit, -1).
template <bool EXIT, bool SHARED_BOXES>
__device__ __forceinline__ void plan_spread(const PttWalkArgs& a) {
  __shared__ SpreadShared sh;
  const float* boxes = a.tile_aabb;
  if constexpr (SHARED_BOXES) {
    __shared__ float sh_aabb[PTT_PLANNED_MAX_CT * 8];
    for (int i = threadIdx.x; i < a.ct * 8; i += blockDim.x) sh_aabb[i] = a.tile_aabb[i];
    __syncthreads();  // the boxes are read by the first walk_take, before any barrier
    boxes = sh_aabb;
  }
  const bool owner = threadIdx.x < PTT_RAY_TILE;
  const int idx = blockIdx.x * PTT_RAY_TILE + threadIdx.x;
  WalkRay r = spread_ray(sh, owner, load_center(a.center), a.ray, a.live, a.tlim, idx, idx < a.n);
  const int b = blockIdx.x;
  const int cnt = __ldg(a.cnt + b);
  const int32_t* ids = a.ids + (size_t)b * a.ct;
  const float* tlo = a.tlo + (size_t)b * a.ct;
  for (int t = 0; t < cnt; ++t) {
    const int tile = __ldg(ids + t);
    const bool vote = !EXIT || (owner && walk_goes_on(r, __ldg(tlo + t)));
    if (!spread_entry(sh, r, owner, true, vote, a.coef, boxes + 8 * tile, tile, t & 1,
                      a.baby_eps, a.eps_succ)) {
      break;
    }
  }
  spread_out(a, r, owner);
}

__global__ void PTT_SPREAD_BOUNDS ptt_planned_lanebest_kernel(const PttWalkArgs a) {
  plan_spread<false, true>(a);
}

__global__ void PTT_SPREAD_BOUNDS ptt_planned_kernel(const PttWalkArgs a) {
  plan_spread<true, true>(a);
}

__global__ void PTT_SPREAD_BOUNDS ptt_streamed_kernel(const PttWalkArgs a) {
  plan_spread<true, false>(a);
}

// #8: per plan entry (a super-tile), the exit vote on its bound, taken at
// the first member tile's barrier, and each owner ray's gate on the super
// box against its best before the entry, as super_visit takes it; then the
// member tiles sid * 8 + k < ct that are no padding, each a spread_entry
// that a ray past the gate may take.
__global__ void PTT_SPREAD_BOUNDS ptt_streamed_super_kernel(const PttWalkArgs a) {
  __shared__ SpreadShared sh;
  const bool owner = threadIdx.x < PTT_RAY_TILE;
  const int idx = blockIdx.x * PTT_RAY_TILE + threadIdx.x;
  WalkRay r = spread_ray(sh, owner, load_center(a.center), a.ray, a.live, a.tlim, idx, idx < a.n);
  const int b = blockIdx.x;
  const int cnt = __ldg(a.cnt + b);
  const int32_t* ids = a.ids + (size_t)b * a.cs;
  const float* tlo = a.tlo + (size_t)b * a.cs;
  int parity = 0;
  for (int t = 0; t < cnt; ++t) {
    const int sid = __ldg(ids + t);
    const bool vote = owner && walk_goes_on(r, __ldg(tlo + t));
    const bool gate = super_take(r, a.saabb + 8 * sid);
    bool go = true, first = true;
    for (int k = 0; k < PTT_SUPER_TILES && go; ++k) {
      const int tile = sid * PTT_SUPER_TILES + k;
      if (tile >= a.ct) break;
      if (padding_tile(a.tile_aabb + 8 * tile)) continue;  // the same for every thread
      go = spread_entry(sh, r, owner, gate, !first || vote, a.coef, a.tile_aabb + 8 * tile,
                        tile, parity, a.baby_eps, a.eps_succ);
      first = false;
      parity ^= 1;
    }
    if (!go) break;
  }
  spread_out(a, r, owner);
}

// #4 and #9: every tile 0..ct-1 in ascending id through spread_entry, no
// plan and no exit vote (the tiles come in no order of distance); the boxes
// staged in shared memory.  A block with no live ray is skipped whole (the
// TPU kernels' block_live).  MONO (#4, at most 8 tiles): each owner ray's
// root cull (root_hit on the root_box, six floats, as mono_ray takes it)
// joins its live flag, and the num_tris clamp comes with the output.
// #4 takes walk_take's improvability gate too, as #5 does: exact in any
// walk, so the results are bit-equal with the gate or without it (the TPU
// kernel takes none).  Its rays start at (t_limit, -1), the sweep's start,
// where mono_ray starts at (inf, -1) and writes (t_limit, -1) unless the
// minimum lies below t_limit.  The two agree: a hit past t_limit, or at
// exactly t_limit (key low word tri + 1 >= 1 against the start's 0), never
// lowers the (t_limit, -1) key, so both end on the least hit below t_limit
// with its lowest id, or on (t_limit, -1).
template <bool MONO, typename Args>
__device__ __forceinline__ void sweep_spread(const Args& a, const uint8_t* live,
                                             int32_t num_tris) {
  __shared__ SpreadShared sh;
  __shared__ float sh_aabb[PTT_PLANNED_MAX_CT * 8];
  for (int i = threadIdx.x; i < a.ct * 8; i += blockDim.x) sh_aabb[i] = a.tile_aabb[i];
  const bool owner = threadIdx.x < PTT_RAY_TILE;
  const int idx = blockIdx.x * PTT_RAY_TILE + threadIdx.x;
  WalkRay r = spread_ray(sh, owner, load_center(a.center), a.ray, live, a.tlim, idx, idx < a.n);
  if constexpr (MONO) r.live = r.live && root_hit(a.root_box, r.os, r.inv, r.tlim);
  if (__syncthreads_or(r.live)) {  // also the barrier after the boxes are staged
    for (int c = 0; c < a.ct; ++c) {
      spread_entry(sh, r, owner, true, true, a.coef, sh_aabb + 8 * c, c, c & 1, a.baby_eps,
                   a.eps_succ);
    }
  }
  spread_out(a, r, owner, num_tris);
}

__global__ void PTT_SPREAD_BOUNDS ptt_sweep_kernel(const PttWalkArgs a) {
  sweep_spread<false>(a, a.live, PTT_INT_MAX);
}

__global__ void PTT_SPREAD_BOUNDS ptt_mono_kernel(const PttMonoArgs a) {
  sweep_spread<true>(a, a.active, a.num_tris);
}

#define PTT_EPI_FULL 0
#define PTT_EPI_GATE 1
#define PTT_EPI_MM 2

// The full-width schedule of #13b and of #13a's floor (csrc/mesh_path.cuh:
// wide_key, wide_sink, wide_mm_key): PTT_SPREAD_THREADS threads a block of
// 256 rays, thread t < 256 owning ray t, every thread holding the rows of
// triangles t + PTT_SPREAD_THREADS i of the tile and evaluating them against
// every ray of the block.  The block's shared state:
struct WideShared {
  float4 f[PTT_RAY_TILE][3];             // ray j: its features, then its pair window
  unsigned long long key[PTT_RAY_TILE];  // each ray's running best as a key
};

// Ray j's features and pair window [lo, hi] (lo > hi: no pair can enter).
__device__ __forceinline__ void wide_read(const WideShared& sh, int j, float f[10], float* lo,
                                          float* hi) {
  const float4 a = sh.f[j][0], b = sh.f[j][1], c = sh.f[j][2];
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
  f[8] = c.x, f[9] = c.y;
  *lo = c.z;
  *hi = c.w;
}

// One tile of "full" (every tile of a live block) or "gate" (GATE: the
// block votes, at the barrier after the windows, whether some live ray is
// a member; a tile without one is skipped).  Each owner writes its ray's
// window: asc_fold's [t_lo, t_hi], (inf, -inf) for a ray that is not a
// member or not live.  Then every pair of the tile: a ray whose window no t
// can enter (lo > hi; the same for every thread at step j, so the branch is
// uniform) costs the four numerators; a member's pairs take wide_key and
// lower the ray's key with atomicMin where one accepts.  The closing barrier
// keeps the next tile's windows from overwriting this tile's.
template <bool GATE>
__device__ __forceinline__ void wide_tile(WideShared& sh, const WalkRay& r, bool owner,
                                          const float* coef, const float* row, int tile,
                                          float baby_eps, float eps_succ) {
  const int tid = threadIdx.x;
  Slab s;
  const bool member = owner && asc_member(r, row, &s);
  if (owner) {
    sh.f[tid][2].z = member ? ptt_max(s.lo, eps_succ) : ptt_inf();
    sh.f[tid][2].w = member ? s.hi : -ptt_inf();
  }
  if (GATE) {
    if (!__syncthreads_or(member)) return;  // the same for every thread
  } else {
    __syncthreads();
  }
  float k[PTT_SPREAD][PTT_COEF_W];
  spread_load(coef, tile, tid, k);
  const int32_t tri0 = tile * PTT_TRI_TILE + tid;
  for (int j = 0; j < PTT_RAY_TILE; ++j) {
    float f[10], lo, hi;
    wide_read(sh, j, f, &lo, &hi);
    if (lo <= hi) {
      const uint64_t key = wide_key(f, lo, hi, k, tri0, baby_eps);
      if (key != PTT_NO_KEY) atomicMin(&sh.key[j], (unsigned long long)key);
    } else {
      wide_sink(f, k);
    }
  }
  __syncthreads();
}

// One tile of a floor: every ray of the block, live or not.  Each thread's
// least key of a ray (wide_mm_key) goes through two warp reductions (the
// high word, then the low word among the lanes at that high word), and lane
// jj keeps the warp's key of ray g + jj: after 32 rays each lane lowers one
// ray's shared key with one atomicMin, so a ray's key takes one atomic a
// warp and a tile instead of one a thread and a pair.
__device__ __forceinline__ void wide_mm_tile(WideShared& sh, const float* coef, int tile) {
  const int tid = threadIdx.x, lane = tid & 31;
  float k[PTT_SPREAD][PTT_COEF_W];
  spread_load(coef, tile, tid, k);
  for (int g = 0; g < PTT_RAY_TILE; g += 32) {
    unsigned long long mine = PTT_NO_KEY;
    for (int jj = 0; jj < 32; ++jj) {
      float f[10], lo, hi;
      wide_read(sh, g + jj, f, &lo, &hi);
      const uint64_t key = wide_mm_key(f, k, tid);
      const unsigned khi = __reduce_min_sync(0xFFFFFFFFu, (unsigned)(key >> 32));
      const unsigned klo = __reduce_min_sync(
          0xFFFFFFFFu, (unsigned)(key >> 32) == khi ? (unsigned)key : 0xFFFFFFFFu);
      if (lane == jj) mine = ((unsigned long long)khi << 32) | klo;
    }
    atomicMin(&sh.key[g + lane], mine);
  }
}

// #13b ("full", "gate", the floor "mm": every tile 0..ct-1 in order, a
// block with no live ray skipped whole) and #13a's floor (PLAN: the tiles
// of the block's ascending plan row, no skip).  The owners write their
// rays' features (a floor's dead rays with zero features, mm_ray) and
// first keys: (t_limit, -1), or the floor's (inf, lane INT_MAX); the exact
// flavors' tile boxes are staged in shared memory.  After the last tile,
// each owner reads its key back: the exact flavors' (t, tri) by
// walk_unkey, a floor's through mm_resolve.
template <int FLAVOR, bool PLAN>
__device__ __forceinline__ void wide_spread(const PttWalkArgs& a) {
  static_assert(!PLAN || FLAVOR == PTT_EPI_MM, "the plan row is the floor's only");
  constexpr bool MM = FLAVOR == PTT_EPI_MM;
  __shared__ WideShared sh;
  __shared__ float sh_aabb[MM ? 1 : PTT_PLANNED_MAX_CT * 8];
  if constexpr (!MM) {
    for (int i = threadIdx.x; i < a.ct * 8; i += blockDim.x) sh_aabb[i] = a.tile_aabb[i];
  }
  const int tid = threadIdx.x, b = blockIdx.x;
  const bool owner = tid < PTT_RAY_TILE;
  const int idx = b * PTT_RAY_TILE + tid;
  WalkRay r = load_ray(a.ray, a.live, a.tlim, idx, owner && idx < a.n, load_center(a.center));
  if (owner) {
    if (MM) mm_ray(r);
    sh.f[tid][0] = make_float4(r.f[0], r.f[1], r.f[2], r.f[3]);
    sh.f[tid][1] = make_float4(r.f[4], r.f[5], r.f[6], r.f[7]);
    sh.f[tid][2] = make_float4(r.f[8], r.f[9], ptt_inf(), -ptt_inf());
    sh.key[tid] = MM ? mm_key(r.best, r.best_tri) : walk_key(r.best, r.best_tri);
  }
  // The barrier after the boxes, features and keys are written.
  if (__syncthreads_or(PLAN || r.live)) {
    const int cnt = PLAN ? __ldg(a.cnt + b) : a.ct;
    for (int t = 0; t < cnt; ++t) {
      const int tile = PLAN ? __ldg(a.ids + (size_t)b * a.ct + t) : t;
      if constexpr (MM) {
        wide_mm_tile(sh, a.coef, tile);
      } else {
        wide_tile<FLAVOR == PTT_EPI_GATE>(sh, r, owner, a.coef, sh_aabb + 8 * tile, tile,
                                          a.baby_eps, a.eps_succ);
      }
    }
  }
  __syncthreads();
  if (owner && idx < a.n) {
    float t;
    int32_t tri;
    if (MM) {
      mm_unkey(sh.key[tid], r.tlim, &t, &tri);
    } else {
      walk_unkey(sh.key[tid], &t, &tri);
    }
    a.out_t[idx] = t;
    a.out_tri[idx] = tri;
  }
}

// #13a: lb_asc is #5's block schedule (plan_spread) fed the ascending plan
// row; lb_mm the floor over the same row at full width.  The <false>
// instantiation has ptt_planned_lanebest_kernel's body: it is kept so that
// launch kind 5 and the profiler's kernel name stay #13a's.
template <bool MM>
__global__ void PTT_SPREAD_BOUNDS ptt_lb_asc_kernel(const PttWalkArgs a) {
  if constexpr (MM) {
    wide_spread<PTT_EPI_MM, true>(a);
  } else {
    plan_spread<false, true>(a);
  }
}

// Blocks of #13b an SM holds at once: two at 512 threads, which caps a
// thread at 64 registers (the exact flavors take 79 with one).  A block's
// tiles take as long as its 256 rays, and a population leaves a few live
// blocks an SM (534 on 132 SMs at 5k), so the second block is the latency
// hiding: "full" 19-25% faster mid-bounce against one block (PERF.md).
constexpr int kWideMinBlocks = PTT_SPREAD_THREADS >= 1024 ? 1 : 1024 / PTT_SPREAD_THREADS;

// #13b.
template <int FLAVOR>
__global__ void __launch_bounds__(PTT_SPREAD_THREADS, kWideMinBlocks)
    ptt_epilogue_mono_kernel(const PttWalkArgs a) {
  wide_spread<FLAVOR, false>(a);
}

// The tiles of its ray block's plan row that one CTA of the plan prepass
// takes (its shared row): 64 timed best of 16-1,024 at 79, 196 and 489
// tiles.  Other widths build with -DPTT_PREPASS_SPLIT=k.
#ifndef PTT_PREPASS_SPLIT
#define PTT_PREPASS_SPLIT 64
#endif
static_assert(PTT_PREPASS_SPLIT >= 1 && PTT_PREPASS_SPLIT <= 1024,
              "PTT_PREPASS_SPLIT: 1 to 1,024 tiles");

// CTA (b, y) of ray block b takes the tiles [y * S, (y + 1) * S) of
// its row.  Its 256 threads stage the block's live rays, L of them, in
// shared memory, compacted (warp ballots and a prefix over the warps); each
// warp then takes tiles c = warp, warp + 8, ... of the slice, its lanes the
// live rays r = lane, lane + 32, ... < L, and reduces the tile's pairs
// with two warp votes (any; the minimum of the keys' int bits, which is the
// float order of the non-negative keys).  The slice's (h, lb) go to a
// shared row, written out coalesced.
__global__ void __launch_bounds__(PTT_RAY_TILE) ptt_plan_prepass_kernel(const PttPlanArgs a) {
  __shared__ float4 sh_o[PTT_RAY_TILE];  // live ray k: recentred origin, t_limit
  __shared__ float4 sh_i[PTT_RAY_TILE];  // live ray k: reciprocal direction
  __shared__ int sh_cnt[PTT_RAY_TILE / 32];
  __shared__ int sh_lb[PTT_PREPASS_SPLIT];
  __shared__ uint8_t sh_h[PTT_PREPASS_SPLIT];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.y * PTT_PREPASS_SPLIT;
  const int c1 = min(a.ct, c0 + PTT_PREPASS_SPLIT);
  const size_t idx = (size_t)b * PTT_RAY_TILE + tid;
  const bool live = a.live[idx] != 0;
  const unsigned lv = __ballot_sync(0xffffffffu, live);
  if (lane == 0) sh_cnt[warp] = __popc(lv);
  __syncthreads();
  int base = 0, total = 0;
#pragma unroll
  for (int w = 0; w < PTT_RAY_TILE / 32; ++w) {
    const int k = sh_cnt[w];
    base += w < warp ? k : 0;
    total += k;
  }
  uint8_t* out_h = a.out_h + (size_t)b * a.ct;
  float* out_lb = a.out_lb + (size_t)b * a.ct;
  if (total == 0) {  // no live ray: no tile (block-uniform, before any barrier)
    for (int c = c0 + tid; c < c1; c += PTT_RAY_TILE) {
      out_h[c] = 0;
      out_lb[c] = ptt_inf();
    }
    return;
  }
  if (live) {
    const int k = base + __popc(lv & ((1u << lane) - 1u));
    const V3 inv = inv_dir(v3(a.ray[3][idx], a.ray[4][idx], a.ray[5][idx]));
    sh_o[k] = make_float4(a.ray[0][idx], a.ray[1][idx], a.ray[2][idx], a.tlim[idx]);
    sh_i[k] = make_float4(inv.x, inv.y, inv.z, 0.0f);
  }
  __syncthreads();
  for (int c = c0 + warp; c < c1; c += PTT_RAY_TILE / 32) {
    const float* row = a.tile_aabb + 8 * c;
    const float box[6] = {__ldg(row), __ldg(row + 1), __ldg(row + 2),
                          __ldg(row + 3), __ldg(row + 4), __ldg(row + 5)};
    bool any = false;
    int best = ptt_as_int(ptt_inf());
    for (int r = lane; r < total; r += 32) {
      const float4 o = sh_o[r], i = sh_i[r];
      float key;
      if (plan_pair(box, v3(o.x, o.y, o.z), v3(i.x, i.y, i.z), true, o.w, &key)) {
        any = true;
        best = min(best, ptt_as_int(key));
      }
    }
    any = __any_sync(0xffffffffu, any);
    best = __reduce_min_sync(0xffffffffu, best);
    if (lane == 0) {
      sh_h[c - c0] = any ? 1 : 0;
      sh_lb[c - c0] = best;
    }
  }
  __syncthreads();
  for (int c = c0 + tid; c < c1; c += PTT_RAY_TILE) {
    out_h[c] = sh_h[c - c0];
    out_lb[c] = ptt_as_float(sh_lb[c - c0]);
  }
}

// #10: block v takes visit v's tile, one spread_entry (no running best
// carries across visits, which are independent).  Owner thread r < 256 is
// pair row r, the ray src[32 v + r / 8] * 8 + r % 8 of the packet in that
// slot (not live for an empty slot, p >= n_g, or a ray past n).  A packet
// holds at most one slot of a tile's run, but the keys are the pair rows'
// (owner tid's) in any case, so no two rows share one.  Each row starts at
// (t_limit, -1) and ends on the least hit below t_limit (a hit at or past
// it never lowers that key) with its lowest id, or on tri -1, which is
// written (inf, -1): binned_pair's rule, which starts at (inf, -1) and
// writes (inf, -1) unless the minimum lies below t_limit.
__global__ void PTT_SPREAD_BOUNDS ptt_binned_kernel(const PttBinnedArgs a) {
  __shared__ SpreadShared sh;
  const int v = blockIdx.x, tid = threadIdx.x;
  const bool owner = tid < PTT_RAY_TILE;
  const size_t out = (size_t)v * PTT_RAY_TILE + tid;
  const int tile = __ldg(a.vt + v);
  if (tile < 0) {  // an empty visit: the same for every thread, before any barrier
    if (owner) {
      a.out_t[out] = ptt_inf();
      a.out_tri[out] = -1;
    }
    return;
  }
  const int p =
      owner ? __ldg(a.src + (size_t)v * (PTT_RAY_TILE / PTT_BINNED_G) + tid / PTT_BINNED_G)
            : a.n_g;
  const long long ray = (long long)p * PTT_BINNED_G + tid % PTT_BINNED_G;
  WalkRay r = spread_ray(sh, owner, load_center(a.center), a.ray, a.live, a.tlim, ray,
                         p < a.n_g && ray < a.n);
  spread_entry(sh, r, owner, true, true, a.coef, a.tile_aabb + 8 * tile, tile, 0, a.baby_eps,
               a.eps_succ);
  if (owner) {
    const bool hit = r.best_tri >= 0;
    a.out_t[out] = hit ? r.best : ptt_inf();
    a.out_tri[out] = hit ? r.best_tri : -1;
  }
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
      (int32_t)offsetof(PttWalkArgs, cs),
      (int32_t)sizeof(PttPlanArgs),
      (int32_t)offsetof(PttPlanArgs, nb),
      (int32_t)sizeof(PttBinnedArgs),
      (int32_t)offsetof(PttBinnedArgs, baby_eps),
      (int32_t)offsetof(PttBinnedArgs, n),
      (int32_t)sizeof(PttMonoArgs),
      (int32_t)offsetof(PttMonoArgs, root_box),
      (int32_t)offsetof(PttMonoArgs, baby_eps),
      (int32_t)offsetof(PttMonoArgs, n),
      PTT_TRI_TILE,
      PTT_COEF_W,
      PTT_RAY_TILE,
      PTT_BINNED_G,
      PTT_PLANNED_MAX_CT,
      PTT_STREAMED_MAX_CT,
      PTT_SUPER_TILES,
      PTT_MONO_MAX_TILES,
  };
  const int32_t count = (int32_t)(sizeof(v) / sizeof(v[0]));
  for (int32_t i = 0; i < count && i < len; ++i) out[i] = v[i];
  return count;
}

// kind: 0 planned lane-best (#5), 1 planned (#6), 2 streamed (#7), 3 the
// super-tile streamed walk (#8), 4 the sweep (#9), 5 lb_asc and 6 its floor
// lb_mm (#13a), 7 the epilogue mono "full", 8 "gate" and 9 its floor "mm"
// (#13b).
int ptt_launch_walk(const PttWalkArgs* a, int32_t kind, void* stream) {
  if (kind < 0 || kind > 9) return (int)cudaErrorInvalidValue;
  const int cols = kind == 3 ? a->cs : a->ct;  // plan columns, or the sweep's tiles
  const int max_cols = (kind == 2 || kind == 3) ? PTT_STREAMED_MAX_CT : PTT_PLANNED_MAX_CT;
  if (a->ct < 1 || cols < 1 || cols > max_cols) return (int)cudaErrorInvalidValue;
  if (kind == 3 && a->cs != (a->ct + PTT_SUPER_TILES - 1) / PTT_SUPER_TILES) {
    return (int)cudaErrorInvalidValue;
  }
  if (a->n > 0) {
    const unsigned grid = blocks_for(a->n);
    cudaStream_t s = (cudaStream_t)stream;
    if (kind == 0) {
      ptt_planned_lanebest_kernel<<<grid, PTT_SPREAD_THREADS, 0, s>>>(*a);
    } else if (kind == 1) {
      ptt_planned_kernel<<<grid, PTT_SPREAD_THREADS, 0, s>>>(*a);
    } else if (kind == 2) {
      ptt_streamed_kernel<<<grid, PTT_SPREAD_THREADS, 0, s>>>(*a);
    } else if (kind == 3) {
      ptt_streamed_super_kernel<<<grid, PTT_SPREAD_THREADS, 0, s>>>(*a);
    } else if (kind == 4) {
      ptt_sweep_kernel<<<grid, PTT_SPREAD_THREADS, 0, s>>>(*a);
    } else if (kind == 5) {
      ptt_lb_asc_kernel<false><<<grid, PTT_SPREAD_THREADS, 0, s>>>(*a);
    } else if (kind == 6) {
      ptt_lb_asc_kernel<true><<<grid, PTT_SPREAD_THREADS, 0, s>>>(*a);
    } else if (kind == 7) {
      ptt_epilogue_mono_kernel<PTT_EPI_FULL><<<grid, PTT_SPREAD_THREADS, 0, s>>>(*a);
    } else if (kind == 8) {
      ptt_epilogue_mono_kernel<PTT_EPI_GATE><<<grid, PTT_SPREAD_THREADS, 0, s>>>(*a);
    } else {
      ptt_epilogue_mono_kernel<PTT_EPI_MM><<<grid, PTT_SPREAD_THREADS, 0, s>>>(*a);
    }
  }
  return (int)cudaGetLastError();
}

int ptt_launch_plan_prepass(const PttPlanArgs* a, void* stream) {
  if (a->ct < 1 || a->nb < 0) return (int)cudaErrorInvalidValue;
  if (a->nb > 0) {
    const dim3 grid((unsigned)a->nb,
                    (unsigned)((a->ct + PTT_PREPASS_SPLIT - 1) / PTT_PREPASS_SPLIT));
    ptt_plan_prepass_kernel<<<grid, PTT_RAY_TILE, 0, (cudaStream_t)stream>>>(*a);
  }
  return (int)cudaGetLastError();
}

int ptt_launch_binned(const PttBinnedArgs* a, void* stream) {
  if (a->ct < 1 || a->ct > PTT_STREAMED_MAX_CT) return (int)cudaErrorInvalidValue;
  if (a->nv > 0) {
    ptt_binned_kernel<<<(unsigned)a->nv, PTT_SPREAD_THREADS, 0, (cudaStream_t)stream>>>(*a);
  }
  return (int)cudaGetLastError();
}

int ptt_launch_mono(const PttMonoArgs* a, void* stream) {
  if (a->ct < 1 || a->ct > PTT_MONO_MAX_TILES || a->root_box == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  if (a->n > 0) {
    ptt_mono_kernel<<<blocks_for(a->n), PTT_SPREAD_THREADS, 0, (cudaStream_t)stream>>>(*a);
  }
  return (int)cudaGetLastError();
}

const char* ptt_walk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
