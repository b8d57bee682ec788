// Hand-written Hopper (sm_90a) kernel of the scan library.
//
// ptt_scan_tile_kernel replaces the TPU kernel
//   project3_cuda_path_tracer_2025_tpu/ops/scan.py::_scan_tile_kernel
//   (launched by _scan_pallas_f32): per 128-lane row of an [R, 128] float32
//   array, the inclusive scan along the row and the row total (the scan's
//   last lane).  The row offsets (an exclusive scan of the [R] totals) and
//   the exclusive form stay outside the kernel, in torch, as they are jnp in
//   the JAX package (ops/scan.py::_scan_tiled).
//
// What bounds it on the H100: bytes.  Each element is read once and written
// once (8 bytes) against four adds, so the kernel is a streaming pass at the
// memory rate.  The TPU kernel scanned a [128, 128] tile as one matmul with
// an upper-triangular ones matrix on its matrix unit; here one warp owns one
// row: each lane loads four consecutive floats with one 16-byte load, scans
// them in registers, and a five-step shuffle scan (Hillis-Steele over the 32
// lane totals) gives each lane its exclusive prefix.  A block of eight warps
// takes eight rows.  The summation order differs from the matmul's and from
// torch.cumsum's, which is exact for integer-valued inputs while every prefix
// stays below 2^24 (the 0/1 flags of stream compaction); other float inputs
// agree to rounding.  A single-pass scan with decoupled look-back, which
// would fold the row offsets in, is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// -shared -Xcompiler -fPIC (ops/kernels.py).  Plain C interface, loaded with
// ctypes; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

#define PTT_SCAN_WARPS 8  // rows per block

__global__ void __launch_bounds__(PTT_SCAN_WARPS * 32)
    ptt_scan_tile_kernel(const float* __restrict__ x, float* __restrict__ lane_out,
                         float* __restrict__ tot_out, int32_t rows) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * PTT_SCAN_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;  // a whole warp leaves together
  const float4 v4 = reinterpret_cast<const float4*>(x + row * PTT_SCAN_LANES)[lane];
  const float v[4] = {v4.x, v4.y, v4.z, v4.w};
  float q[4];
  scan_quad(v, q);
  float s = q[3];
#pragma unroll
  for (int off = 1; off < PTT_SCAN_WARP; off <<= 1) {
    s = scan_step(s, __shfl_up_sync(0xFFFFFFFFu, s, off), lane, off);
  }
  float out[4];
  scan_finish(__shfl_up_sync(0xFFFFFFFFu, s, 1), lane, q, out);
  reinterpret_cast<float4*>(lane_out + row * PTT_SCAN_LANES)[lane] =
      make_float4(out[0], out[1], out[2], out[3]);
  if (lane == PTT_SCAN_WARP - 1) tot_out[row] = out[3];  // the row's last lane
}

extern "C" {

// Sizes the ctypes side checks at load time.
int ptt_scan_abi(int32_t* out, int32_t len) {
  const int32_t v[] = {PTT_SCAN_LANES, PTT_SCAN_WARPS};
  const int32_t count = (int32_t)(sizeof(v) / sizeof(v[0]));
  for (int32_t i = 0; i < count && i < len; ++i) out[i] = v[i];
  return count;
}

// x, lane_out: [rows, 128] float32, 16-byte aligned; tot_out: [rows].
int ptt_launch_scan_tiles(const float* x, float* lane_out, float* tot_out, int32_t rows,
                          void* stream) {
  if (rows < 0 || (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(lane_out) & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows > 0) {
    const unsigned blocks = (unsigned)((rows + PTT_SCAN_WARPS - 1) / PTT_SCAN_WARPS);
    ptt_scan_tile_kernel<<<blocks, PTT_SCAN_WARPS * 32, 0, (cudaStream_t)stream>>>(
        x, lane_out, tot_out, rows);
  }
  return (int)cudaGetLastError();
}

const char* ptt_scan_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
