// Host build of the whole-array scan's per-thread steps (csrc/scan.cuh), so
// the CPU tests can hold the arithmetic of ptt_scan_reduce_kernel and
// ptt_scan_kernel against the port's plain torch version.  One tile is one
// block: its 256 threads run in lockstep over arrays, each __shfl_up_sync
// of a kernel becomes a read of the previous step's array `off` lanes
// below, each __shfl_down_sync a read `off` lanes above (a lane past the
// warp reads its own value, as the shuffle returns it).
//
// Built by tests/test_torch_kernel_body.py with
//   c++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC -I<csrc>

#include <stddef.h>
#include <stdint.h>

#include <vector>

#include "scan.cuh"

namespace {

// One tile through scan_items and the warps' shuffle scans: each thread's
// q[8] and its warp's inclusive thread-total scan s; returns the tile total.
template <typename T>
T host_tile(const T* x, int64_t n, int64_t tile, T q[PTT_SCAN_THREADS][PTT_SCAN_ITEMS],
            T s[PTT_SCAN_THREADS], T warp_tot[PTT_SCAN_WARPS]) {
  T below[PTT_SCAN_THREADS];
  for (int t = 0; t < PTT_SCAN_THREADS; ++t) {
    T v[PTT_SCAN_ITEMS];
    for (int k = 0; k < PTT_SCAN_ITEMS; ++k) {
      const int64_t g = tile * PTT_SCAN_TILE + t * PTT_SCAN_ITEMS + k;
      v[k] = g < n ? x[g] : T(0);
    }
    scan_items(v, q[t]);
    s[t] = q[t][PTT_SCAN_ITEMS - 1];
  }
  for (int off = 1; off < PTT_SCAN_WARP; off <<= 1) {
    for (int t = 0; t < PTT_SCAN_THREADS; ++t) {
      const int lane = t % PTT_SCAN_WARP;
      below[t] = lane >= off ? s[t - off] : s[t];
    }
    for (int t = 0; t < PTT_SCAN_THREADS; ++t) s[t] = scan_step(s[t], below[t], t % PTT_SCAN_WARP, off);
  }
  for (int w = 0; w < PTT_SCAN_WARPS; ++w) warp_tot[w] = s[w * PTT_SCAN_WARP + PTT_SCAN_WARP - 1];
  return scan_sum(warp_tot, PTT_SCAN_WARPS);
}

template <typename T>
void host_scan(const T* x, T* out, T* tot, int64_t n, bool inclusive) {
  const int64_t tiles = (n + PTT_SCAN_TILE - 1) / PTT_SCAN_TILE;
  std::vector<T> qs((size_t)PTT_SCAN_THREADS * PTT_SCAN_ITEMS);
  auto q = reinterpret_cast<T(*)[PTT_SCAN_ITEMS]>(qs.data());
  T s[PTT_SCAN_THREADS], warp_tot[PTT_SCAN_WARPS];
  // ptt_scan_reduce_kernel (skipped for one tile)
  for (int64_t b = 0; tiles > 1 && b < tiles; ++b) tot[b] = host_tile(x, n, b, q, s, warp_tot);
  // ptt_scan_kernel
  for (int64_t b = 0; b < tiles; ++b) {
    T c[PTT_SCAN_THREADS], above[PTT_SCAN_THREADS], carry_part[PTT_SCAN_WARPS];
    for (int t = 0; t < PTT_SCAN_THREADS; ++t) c[t] = scan_carry_part(tot, b, t);
    for (int off = PTT_SCAN_WARP / 2; off > 0; off >>= 1) {
      for (int t = 0; t < PTT_SCAN_THREADS; ++t) {
        above[t] = t % PTT_SCAN_WARP + off < PTT_SCAN_WARP ? c[t + off] : c[t];
      }
      for (int t = 0; t < PTT_SCAN_THREADS; ++t) c[t] = scan_tree_step(c[t], above[t]);
    }
    for (int w = 0; w < PTT_SCAN_WARPS; ++w) carry_part[w] = c[w * PTT_SCAN_WARP];
    const T carry = scan_sum(carry_part, PTT_SCAN_WARPS);
    host_tile(x, n, b, q, s, warp_tot);
    for (int t = 0; t < PTT_SCAN_THREADS; ++t) {
      const int lane = t % PTT_SCAN_WARP;
      T o[PTT_SCAN_ITEMS];
      scan_finish(carry, scan_sum(warp_tot, t / PTT_SCAN_WARP), lane > 0 ? s[t - 1] : s[t], lane,
                  q[t], inclusive, o);
      for (int k = 0; k < PTT_SCAN_ITEMS; ++k) {
        const int64_t g = b * PTT_SCAN_TILE + t * PTT_SCAN_ITEMS + k;
        if (g < n) out[g] = o[k];
      }
    }
  }
}

}  // namespace

extern "C" {

// ptt_launch_scan: x, out [n] of dtype 0 (int32) or 1 (float32); tot
// [ceil(n / 2,048)] receives the tile totals.
void ptt_host_scan(const void* x, void* out, void* tot, int64_t n, int32_t dtype,
                   int32_t inclusive) {
  if (dtype == 0) {
    host_scan(static_cast<const int32_t*>(x), static_cast<int32_t*>(out),
              static_cast<int32_t*>(tot), n, inclusive != 0);
  } else {
    host_scan(static_cast<const float*>(x), static_cast<float*>(out), static_cast<float*>(tot), n,
              inclusive != 0);
  }
}

}  // extern "C"
