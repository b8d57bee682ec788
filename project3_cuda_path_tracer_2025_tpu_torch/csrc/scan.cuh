// Per-thread steps of the whole-array scan in scan.cu, shared with the host
// harness of the tests (tests/scan_host.cpp), which runs the 256 threads of
// a block in lockstep over arrays where the kernels use warp shuffles.
//
// A tile is PTT_SCAN_TILE = 2,048 consecutive elements, one block of 256
// threads; thread t owns elements 8t .. 8t+7 of its tile.
//   1. scan_items: the thread's inclusive scan of its eight values (left to
//      right; q[7] is its total);
//   2. five Hillis-Steele steps over a warp's 32 thread totals, s += the
//      total `off` lanes below for off = 1, 2, 4, 8, 16 (scan_step); lane
//      31 then holds the warp's total;
//   3. scan_sum over the warp totals below the thread's warp (its warp
//      offset; over all eight warps it is the tile's total, which the
//      first kernel writes out);
//   4. the carry of tile b, the sum of the totals of tiles 0 .. b-1:
//      scan_carry_part per thread (a stride of 256 over the totals), a
//      shuffle-down tree in each warp (scan_tree_step, offsets 16 .. 1) and
//      scan_sum over the eight warp partials;
//   5. scan_finish: base = (carry + warp offset) + the inclusive scan one
//      lane below (0 for lane 0), then base + q[k] (inclusive) or base +
//      q[k - 1] (exclusive; base for k = 0).
// T is int32_t (exact) or float.  Build with --fmad=false (nothing here may
// contract).

#pragma once

#include <stdint.h>

#ifndef PTT_HD
#if defined(__CUDACC__)
#define PTT_HD __host__ __device__ __forceinline__
#else
#define PTT_HD inline
#endif
#endif

#define PTT_SCAN_THREADS 256
#define PTT_SCAN_ITEMS 8
#define PTT_SCAN_TILE (PTT_SCAN_THREADS * PTT_SCAN_ITEMS)
#define PTT_SCAN_WARP 32
#define PTT_SCAN_WARPS (PTT_SCAN_THREADS / PTT_SCAN_WARP)
#define PTT_SCAN_SHARED (PTT_SCAN_TILE + PTT_SCAN_TILE / 32)  // scan_pad's slots of a tile

// The shared-memory slot of tile element i: one pad word per 32, so that a
// thread's eight consecutive elements and a warp's 32 strided ones both
// fall in distinct banks.
PTT_HD int scan_pad(int i) { return i + (i >> 5); }

template <typename T>
PTT_HD void scan_items(const T v[PTT_SCAN_ITEMS], T q[PTT_SCAN_ITEMS]) {
  q[0] = v[0];
  for (int k = 1; k < PTT_SCAN_ITEMS; ++k) q[k] = q[k - 1] + v[k];
}

// s: this lane's running inclusive total; below: the same value `off`
// lanes below (undefined where lane < off).
template <typename T>
PTT_HD T scan_step(T s, T below, int lane, int off) {
  return lane >= off ? s + below : s;
}

// v[0] + v[1] + ... + v[count - 1], left to right (0 for count 0).
template <typename T>
PTT_HD T scan_sum(const T* v, int count) {
  T acc = T(0);
  for (int i = 0; i < count; ++i) acc = acc + v[i];
  return acc;
}

// Thread tid's share of tile b's carry: tot[tid] + tot[tid + 256] + ...
// over the totals of tiles below b.
template <typename T>
PTT_HD T scan_carry_part(const T* tot, int64_t b, int tid) {
  T acc = T(0);
  for (int64_t i = tid; i < b; i += PTT_SCAN_THREADS) acc = acc + tot[i];
  return acc;
}

// One step of the shuffle-down tree: s plus the value `off` lanes above.
template <typename T>
PTT_HD T scan_tree_step(T s, T above) {
  return s + above;
}

// ex_below: the inclusive lane total one lane below (ignored for lane 0).
template <typename T>
PTT_HD void scan_finish(T carry, T warp_off, T ex_below, int lane, const T q[PTT_SCAN_ITEMS],
                        bool inclusive, T out[PTT_SCAN_ITEMS]) {
  const T base = (carry + warp_off) + (lane == 0 ? T(0) : ex_below);
  for (int k = 0; k < PTT_SCAN_ITEMS; ++k) {
    out[k] = inclusive ? base + q[k] : (k == 0 ? base : base + q[k - 1]);
  }
}
