// Hand-written Hopper (sm_90a) kernels of the binned traversal's packet
// bins: ops/intersect_mxu.py::packet_bins on CUDA tensors, four launches a
// call (packet_bins_plain is the same function in torch).
//
// They replace no TPU kernel.  The JAX package's _packet_bins
// (project3_cuda_path_tracer_2025_tpu/ops/intersect_mxu.py) is XLA glue
// around its binned Pallas kernel: slabs, any, two cumsums, a top-K, a
// scatter and a searchsorted over [packets, tiles] planes.  In torch that
// glue was ~65 launches a call, most of them over [n_g, ct] int32 planes
// (63 MB each for 80,000 packets at 196 tiles), and the largest block of
// device and host time of the 200k mesh frame.
//
// The function.  The rays come padded to whole 256-ray blocks; a packet is 8
// consecutive rays and a group 32 consecutive packets (one block).  Packet p
// enters tile c when any of its rays passes plan_pair (the k = 2 widened
// slab, live, before its t_limit).  Tile c holds n_c such packets, padded to
// whole 32-slot visits (pad_cnt = bins_pad(n_c)); the tiles' runs are laid
// out in tile order (off[c] = the runs before c, cum_end[c] = off[c] +
// pad_cnt[c], total = cum_end[ct - 1]), and packet p's slot in tile c is
// off[c] + (the packets below p that enter c).  Outputs: src[slot] = p for
// slot < budget (n_g elsewhere); vt[v] = the tile whose run holds slot 32 v,
// -1 at or past the total; dst, each packet's slots in ascending order
// (INT_MAX past its hits); overflow, total > budget or a packet with more
// hits than dst lists.
//
// Why no sort.  The plain version takes dst as torch.topk(K, largest=False,
// sorted=True) of the [n_g, ct] slot plane.  For a fixed packet the slot
// strictly increases with the tile: its rank in tile c is below n_c <=
// pad_cnt[c], so off[c] + rank < off[c] + pad_cnt[c] = off[c + 1] <= the
// slot in any later tile.  So a packet's K smallest slots are its first K
// hits in tile order, already ascending, and the slots kernel writes them
// as it meets them; hits past the K-th are in no dst and, as in the plain
// version's scatter of dst, in no src.  With topk >= ct, dst is the plain
// version's whole slot plane (INT_MAX at a miss), and with topk 0 every hit
// is in src and there is no dst.
//
//   ptt_bins_mask_kernel     one thread a ray, a block a group: per tile a
//                            warp ballot of plan_pair gives its 4 packets'
//                            bits (bins_nibble), the 8 warps' nibbles make
//                            the group's word, words[g, c] (bit j: packet
//                            32 g + j enters c).  A warp with no live ray
//                            skips the tile loop.  Also fills src with n_g.
//   ptt_bins_scan_kernel     the column scan: for each tile, the packets of
//                            the groups before g that enter it, within
//                            segments of PTT_BINS_SEG groups (rank[g, c]),
//                            and each segment's column sum (seg[s, c]).  A
//                            block takes 32 tiles of one segment.
//   ptt_bins_offsets_kernel  one block: the segments' sums scanned into each
//                            segment's first rank, n_c, pad_cnt, a block
//                            scan of them to cum_end and off, seg[s, c] +=
//                            off[c]; overflow = total > budget; vt by a
//                            binary search of cum_end (bins_visit_tile).
//   ptt_bins_slot_kernel     a block a group, a warp 4 packets in turn, its
//                            lanes over 32 tiles at a time: slot = seg + rank
//                            + the group's lower packets in that tile
//                            (bins_slot), the hit's place in tile order by a
//                            ballot; src, dst, and overflow where a packet
//                            has more than topk hits.
//
// What bounds them on the H100: operations.  ~34 a (ray, tile) slab test
// (80,000 packets x 8 rays x 196 tiles: ~125 M a call, ~0.06 ms at 67
// TFLOP/s) against ~18 MB of rays read, ~2 MB of words and ~5 MB of slots
// and visits written, and dst (4 bytes a packet and listed slot: 41 MB at
// K = 128, written once, mostly INT_MAX).  The scan, offsets and slots
// kernels add the words' bytes again and a few operations a (packet, tile).
// The slab tests of a live warp run in full; a warp of dead rays (the tail
// of a sorted prefix) skips them.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// -shared -Xcompiler -fPIC (ops/kernels.py).  Plain C interface, loaded with
// ctypes; the launcher checks cudaGetLastError() after each launch.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mesh_path.cuh"

#define PTT_BINS_SEG 128      // groups a segment of the column scan
#define PTT_BINS_SCAN_ROWS 4  // PTT_BINS_SEG / 32: groups a scan thread takes

struct PttBinsArgs {
  const float* ray[6];     // recentred origin xyz, direction xyz [n_grp * 256]
  const uint8_t* live;     // bool [n_grp * 256]
  const float* tlim;       // [n_grp * 256]
  const float* tile_aabb;  // [ct, 8]
  uint32_t* words;         // [n_grp, ct] bit j: packet 32 g + j enters tile c
  int32_t* rank;           // [n_grp, ct] packets of the segment's groups before g in c
  int32_t* seg;            // [n_seg, ct] a segment's column sums, then its first slot
  int32_t* src;            // [budget] packet per slot, n_g = empty
  int32_t* vt;             // [nv] tile per visit, -1 = empty
  int32_t* dst;            // [n_g, min(topk, ct)] slots per packet (topk > 0)
  uint8_t* overflow;       // bool []
  int32_t n_grp, ct, budget, topk, n_seg, nv;
};

__global__ void __launch_bounds__(PTT_RAY_TILE) ptt_bins_mask_kernel(const PttBinsArgs a) {
  __shared__ float sh_box[PTT_STREAMED_MAX_CT * 6];
  __shared__ uint8_t sh_nib[PTT_RAY_TILE / 32][PTT_STREAMED_MAX_CT];
  const int g = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int32_t n_g = a.n_grp * (PTT_RAY_TILE / PTT_BINNED_G);
  const long long stride = (long long)gridDim.x * PTT_RAY_TILE;
  for (long long i = (long long)g * PTT_RAY_TILE + tid; i < a.budget; i += stride) a.src[i] = n_g;
  if (g >= a.n_grp) return;  // the src fill's block of an empty prefix
  for (int k = tid; k < a.ct * 6; k += PTT_RAY_TILE) {
    sh_box[k] = __ldg(a.tile_aabb + 8 * (k / 6) + k % 6);
  }
  const size_t idx = (size_t)g * PTT_RAY_TILE + tid;
  const bool live = a.live[idx] != 0;
  const V3 os = v3(a.ray[0][idx], a.ray[1][idx], a.ray[2][idx]);
  const V3 inv = inv_dir(v3(a.ray[3][idx], a.ray[4][idx], a.ray[5][idx]));
  const float tl = a.tlim[idx];
  __syncthreads();
  if (__any_sync(0xffffffffu, live)) {
    for (int c = 0; c < a.ct; ++c) {
      float key;
      const bool hit = plan_pair(sh_box + 6 * c, os, inv, live, tl, &key);
      const uint32_t nib = bins_nibble(__ballot_sync(0xffffffffu, hit));
      if (lane == 0) sh_nib[warp][c] = (uint8_t)nib;
    }
  } else {
    for (int c = lane; c < a.ct; c += 32) sh_nib[warp][c] = 0;
  }
  __syncthreads();
  for (int c = tid; c < a.ct; c += PTT_RAY_TILE) {
    uint32_t w = 0;
#pragma unroll
    for (int k = 0; k < PTT_RAY_TILE / 32; ++k) w |= (uint32_t)sh_nib[k][c] << (4 * k);
    a.words[(size_t)g * a.ct + c] = w;
  }
}

// Block (x, s): tiles 32 x .. 32 x + 31 of segment s; thread (tx, ty) the
// tile 32 x + tx over the segment's groups ty * 4 .. ty * 4 + 3.
__global__ void __launch_bounds__(1024) ptt_bins_scan_kernel(const PttBinsArgs a) {
  __shared__ int32_t sh[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * 32 + tx;
  const int r0 = blockIdx.y * PTT_BINS_SEG + ty * PTT_BINS_SCAN_ROWS;
  const int r1 = min(a.n_grp, r0 + PTT_BINS_SCAN_ROWS);
  int32_t sum = 0;
  if (c < a.ct) {
    for (int r = r0; r < r1; ++r) sum += ptt_popc(a.words[(size_t)r * a.ct + c]);
  }
  sh[ty][tx] = sum;
  __syncthreads();
  if (ty == 0) {
    int32_t run = 0;
    for (int k = 0; k < 32; ++k) {
      const int32_t v = sh[k][tx];
      sh[k][tx] = run;
      run += v;
    }
    if (c < a.ct) a.seg[(size_t)blockIdx.y * a.ct + c] = run;
  }
  __syncthreads();
  if (c < a.ct) {
    int32_t run = sh[ty][tx];
    for (int r = r0; r < r1; ++r) {
      const size_t i = (size_t)r * a.ct + c;
      a.rank[i] = run;
      run += ptt_popc(a.words[i]);
    }
  }
}

// One block of 1,024 threads, thread c the tile c (ct <= 1,024).
__global__ void __launch_bounds__(1024) ptt_bins_offsets_kernel(const PttBinsArgs a) {
  __shared__ int32_t sh_cum[PTT_STREAMED_MAX_CT];
  __shared__ int32_t sh_warp[32];
  const int c = threadIdx.x, lane = c & 31, warp = c >> 5;
  int32_t n_c = 0;
  if (c < a.ct) {
    for (int s = 0; s < a.n_seg; ++s) {
      int32_t* p = a.seg + (size_t)s * a.ct + c;
      const int32_t v = *p;
      *p = n_c;
      n_c += v;
    }
  }
  const int32_t pad = c < a.ct ? bins_pad(n_c) : 0;
  int32_t x = pad;  // inclusive scan of pad_cnt over the block
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int32_t w = sh_warp[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    sh_warp[lane] = w;
  }
  __syncthreads();
  const int32_t cum_end = x + (warp > 0 ? sh_warp[warp - 1] : 0);
  if (c < a.ct) {
    sh_cum[c] = cum_end;
    const int32_t off = cum_end - pad;
    for (int s = 0; s < a.n_seg; ++s) a.seg[(size_t)s * a.ct + c] += off;
  }
  __syncthreads();
  if (c == 0) *a.overflow = sh_cum[a.ct - 1] > a.budget ? 1 : 0;
  for (int v = c; v < a.nv; v += blockDim.x) a.vt[v] = bins_visit_tile(sh_cum, a.ct, v);
}

__global__ void __launch_bounds__(PTT_RAY_TILE) ptt_bins_slot_kernel(const PttBinsArgs a) {
  __shared__ uint32_t sh_w[PTT_STREAMED_MAX_CT];
  __shared__ int32_t sh_base[PTT_STREAMED_MAX_CT];
  const int g = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int32_t* seg = a.seg + (size_t)(g / PTT_BINS_SEG) * a.ct;
  for (int c = tid; c < a.ct; c += PTT_RAY_TILE) {
    const size_t i = (size_t)g * a.ct + c;
    sh_w[c] = a.words[i];
    sh_base[c] = seg[c] + a.rank[i];
  }
  __syncthreads();
  const bool dense = a.topk >= a.ct;
  const int32_t cols = dense ? a.ct : a.topk;  // dst's columns (topk > 0)
  const uint32_t below = (1u << lane) - 1u;
  for (int q = 0; q < 4; ++q) {
    const int j = warp * 4 + q;
    const int32_t p = g * (PTT_RAY_TILE / PTT_BINNED_G) + j;
    int32_t* row = a.topk > 0 ? a.dst + (size_t)p * cols : nullptr;
    int32_t count = 0;  // the packet's hits in the tiles before c0
    for (int c0 = 0; c0 < a.ct; c0 += 32) {
      const int c = c0 + lane;
      const bool hit = c < a.ct && ((sh_w[c] >> j) & 1u);
      const uint32_t bal = __ballot_sync(0xffffffffu, hit);
      const int32_t pos = count + ptt_popc(bal & below);
      count += ptt_popc(bal);
      const int32_t slot = hit ? bins_slot(sh_w[c], sh_base[c], j) : PTT_INT_MAX;
      if (hit && bins_listed(pos, a.topk, a.ct) && slot < a.budget) a.src[slot] = p;
      if (dense) {
        if (c < a.ct) row[c] = slot;
      } else if (row != nullptr && hit && pos < a.topk) {
        row[pos] = slot;
      }
    }
    if (row != nullptr && !dense) {
      for (int32_t i = count + lane; i < a.topk; i += 32) row[i] = PTT_INT_MAX;
      if (lane == 0 && count > a.topk) *a.overflow = 1;
    }
  }
}

extern "C" {

// Struct sizes and offsets, checked against the ctypes mirror at load time.
int ptt_bins_abi(int32_t* out, int32_t len) {
  const int32_t v[] = {
      (int32_t)sizeof(PttBinsArgs),
      (int32_t)offsetof(PttBinsArgs, overflow),
      (int32_t)offsetof(PttBinsArgs, n_grp),
      (int32_t)offsetof(PttBinsArgs, nv),
      PTT_RAY_TILE,
      PTT_BINNED_G,
      PTT_STREAMED_MAX_CT,
      PTT_BINS_GP,
      PTT_BINS_SEG,
  };
  const int32_t count = (int32_t)(sizeof(v) / sizeof(v[0]));
  for (int32_t i = 0; i < count && i < len; ++i) out[i] = v[i];
  return count;
}

// The four kernels in order on one stream (the scan and slots kernels only
// where there is a group).
int ptt_launch_bins(const PttBinsArgs* a, void* stream) {
  if (a->ct < 1 || a->ct > PTT_STREAMED_MAX_CT || a->n_grp < 0 || a->budget < 0 ||
      a->topk < 0 || a->nv != a->budget / PTT_BINS_GP ||
      a->n_seg != (a->n_grp + PTT_BINS_SEG - 1) / PTT_BINS_SEG) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  ptt_bins_mask_kernel<<<(unsigned)(a->n_grp > 0 ? a->n_grp : 1), PTT_RAY_TILE, 0, s>>>(*a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (a->n_grp > 0) {
    const dim3 grid((unsigned)((a->ct + 31) / 32), (unsigned)a->n_seg);
    ptt_bins_scan_kernel<<<grid, dim3(32, 32), 0, s>>>(*a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  ptt_bins_offsets_kernel<<<1, 1024, 0, s>>>(*a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (a->n_grp > 0) {
    ptt_bins_slot_kernel<<<(unsigned)a->n_grp, PTT_RAY_TILE, 0, s>>>(*a);
  }
  return (int)cudaGetLastError();
}

const char* ptt_bins_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
