// Hand-written Hopper (sm_90a) kernels of the scan library: the inclusive
// or exclusive prefix sum of a flat [n] int32 or float32 array, straight
// into its output, in two launches.
//
// They replace the TPU kernel
//   project3_cuda_path_tracer_2025_tpu/ops/scan.py::_scan_tile_kernel
//   (launched by _scan_pallas_f32) together with the jnp around it: that
//   package pads the input to [128, 128] float32 tiles, scans each row by a
//   matmul with an upper-triangular ones matrix, and adds the exclusive scan
//   of the row totals (and subtracts the input for the exclusive form)
//   outside the kernel.  A port of that shape costs some nine device
//   launches a scan (dtype casts, the pad, the row kernel, a cumsum of the
//   totals, three element-wise passes, the rounding back to integers), and
//   that glue, not the row kernel, was the scan's time on this card.
//
// What bounds it on the H100: bytes.  Each element is read once and its
// prefix written once (8 bytes) against one add, so the scan is a
// streaming pass at the memory rate; at the wavefront's 640,000 flags the
// bound (5.1 MB over 3.35 TB/s) is about 1.5 us, below a launch's cost,
// so the launch count and the host wrapper are what is left to cut.
//
// Design: reduce, then scan.  A tile is 2,048 elements, one block of 256
// threads, eight consecutive elements a thread (csrc/scan.cuh).
//   ptt_scan_reduce_kernel: each block scans its tile as below and writes
//     the tile's total (the same arithmetic, so the total is the tile's own
//     last inclusive value).
//   ptt_scan_kernel: each block first sums the totals of the tiles below it
//     (its carry: a stride of 256 over at most a few hundred totals, a
//     shuffle tree per warp, the eight warp partials in order), then scans
//     its tile: the eight values in registers, a five-step shuffle scan of
//     the 32 thread totals of each warp, the warp totals in order, and
//     writes the inclusive or exclusive prefix.
// The tile goes through shared memory in both directions so that global
// loads and stores are coalesced whatever the input's alignment: 2,048 +
// 64 pad words (8,448 bytes) plus 64 bytes of warp totals a block, so
// shared memory never limits occupancy.  One tile (n <= 2,048) skips the
// first launch.  Decoupled look-back would make it one pass, but needs its
// status flags zeroed before every call (a launch of its own) and a spin
// on the flags of earlier blocks; two launches with no flags and no host
// read are as few, and the carry sum is deterministic.  The carry read is
// quadratic in the tile count (each block reads the totals below it),
// which is 49,000 reads at 313 tiles; a float input of some 10^8 elements
// would want a middle pass over the totals instead.
//
// Integer inputs are exact (int32 sums; the wrapper keeps the JAX
// package's refusal of integer inputs beyond 2^24 elements).  Float sums run
// in another order than torch.cumsum's and agree to rounding.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// -shared -Xcompiler -fPIC (ops/kernels.py).  Plain C interface, loaded with
// ctypes; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "scan.cuh"

#define PTT_SCAN_FULL 0xFFFFFFFFu

// Stages tile `tile` of x (zeros past n) in shared memory, coalesced.
template <typename T>
__device__ __forceinline__ void scan_stage(const T* __restrict__ x, T* sh, long long n,
                                           long long tile) {
  const long long base = tile * PTT_SCAN_TILE;
#pragma unroll
  for (int j = 0; j < PTT_SCAN_ITEMS; ++j) {
    const int i = threadIdx.x + PTT_SCAN_THREADS * j;
    const long long g = base + i;
    sh[scan_pad(i)] = g < n ? x[g] : T(0);
  }
}

// The thread's eight values and their inclusive scan q, and the warp's
// inclusive scan s of the thread totals (lane 31: the warp's total).
template <typename T>
__device__ __forceinline__ T scan_thread(const T* sh, T q[PTT_SCAN_ITEMS]) {
  const int lane = threadIdx.x & (PTT_SCAN_WARP - 1);
  T v[PTT_SCAN_ITEMS];
#pragma unroll
  for (int k = 0; k < PTT_SCAN_ITEMS; ++k) v[k] = sh[scan_pad(threadIdx.x * PTT_SCAN_ITEMS + k)];
  scan_items(v, q);
  T s = q[PTT_SCAN_ITEMS - 1];
#pragma unroll
  for (int off = 1; off < PTT_SCAN_WARP; off <<= 1) {
    s = scan_step(s, __shfl_up_sync(PTT_SCAN_FULL, s, off), lane, off);
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(PTT_SCAN_THREADS)
    ptt_scan_reduce_kernel(const T* __restrict__ x, T* __restrict__ tot, long long n) {
  __shared__ T sh[PTT_SCAN_SHARED];
  __shared__ T sh_warp[PTT_SCAN_WARPS];
  scan_stage(x, sh, n, blockIdx.x);
  __syncthreads();
  T q[PTT_SCAN_ITEMS];
  const T s = scan_thread(sh, q);
  if ((threadIdx.x & (PTT_SCAN_WARP - 1)) == PTT_SCAN_WARP - 1) sh_warp[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) tot[blockIdx.x] = scan_sum(sh_warp, PTT_SCAN_WARPS);
}

template <typename T>
__global__ void __launch_bounds__(PTT_SCAN_THREADS)
    ptt_scan_kernel(const T* __restrict__ x, T* __restrict__ out, const T* __restrict__ tot,
                    long long n, int inclusive) {
  __shared__ T sh[PTT_SCAN_SHARED];
  __shared__ T sh_warp[PTT_SCAN_WARPS];
  __shared__ T sh_carry[PTT_SCAN_WARPS];
  const int lane = threadIdx.x & (PTT_SCAN_WARP - 1), warp = threadIdx.x >> 5;
  T c = scan_carry_part(tot, (int64_t)blockIdx.x, threadIdx.x);
#pragma unroll
  for (int off = PTT_SCAN_WARP / 2; off > 0; off >>= 1) {
    c = scan_tree_step(c, __shfl_down_sync(PTT_SCAN_FULL, c, off));
  }
  if (lane == 0) sh_carry[warp] = c;
  scan_stage(x, sh, n, blockIdx.x);
  __syncthreads();
  T q[PTT_SCAN_ITEMS];
  const T s = scan_thread(sh, q);
  const T ex_below = __shfl_up_sync(PTT_SCAN_FULL, s, 1);
  if (lane == PTT_SCAN_WARP - 1) sh_warp[warp] = s;
  __syncthreads();  // also: every thread has read its values from sh
  T o[PTT_SCAN_ITEMS];
  scan_finish(scan_sum(sh_carry, PTT_SCAN_WARPS), scan_sum(sh_warp, warp), ex_below, lane, q,
              inclusive != 0, o);
#pragma unroll
  for (int k = 0; k < PTT_SCAN_ITEMS; ++k) sh[scan_pad(threadIdx.x * PTT_SCAN_ITEMS + k)] = o[k];
  __syncthreads();
  const long long base = (long long)blockIdx.x * PTT_SCAN_TILE;
#pragma unroll
  for (int j = 0; j < PTT_SCAN_ITEMS; ++j) {
    const int i = threadIdx.x + PTT_SCAN_THREADS * j;
    if (base + i < n) out[base + i] = sh[scan_pad(i)];
  }
}

template <typename T>
static int scan_launch(const void* x, void* out, void* tot, long long n, int inclusive,
                       cudaStream_t s) {
  const long long tiles = (n + PTT_SCAN_TILE - 1) / PTT_SCAN_TILE;
  if (tiles > 1) {
    ptt_scan_reduce_kernel<T><<<(unsigned)tiles, PTT_SCAN_THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(tot), n);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  ptt_scan_kernel<T><<<(unsigned)tiles, PTT_SCAN_THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const T*>(tot), n, inclusive);
  return (int)cudaGetLastError();
}

extern "C" {

// Sizes the ctypes side checks at load time.
int ptt_scan_abi(int32_t* out, int32_t len) {
  const int32_t v[] = {PTT_SCAN_TILE, PTT_SCAN_THREADS};
  const int32_t count = (int32_t)(sizeof(v) / sizeof(v[0]));
  for (int32_t i = 0; i < count && i < len; ++i) out[i] = v[i];
  return count;
}

// x, out: [n] of dtype 0 (int32) or 1 (float32); tot: [ceil(n / 2,048)]
// scratch of the same dtype (not read for a single tile).
int ptt_launch_scan(const void* x, void* out, void* tot, long long n, int32_t dtype,
                    int32_t inclusive, void* stream) {
  if (n < 0 || dtype < 0 || dtype > 1 || (n + PTT_SCAN_TILE - 1) / PTT_SCAN_TILE > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? scan_launch<int32_t>(x, out, tot, n, inclusive, s)
                    : scan_launch<float>(x, out, tot, n, inclusive, s);
}

const char* ptt_scan_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
