// Per-lane steps of the row scan in scan.cu, shared with the host harness
// of the tests (tests/scan_host.cpp), which runs the 32 lanes of a warp in
// lockstep over arrays where the kernel uses warp shuffles.
//
// A 128-lane row is scanned by one warp: lane j owns elements 4j .. 4j+3.
//   1. scan_quad: the lane's inclusive scan of its four values (left to
//      right; q[3] is its total);
//   2. five Hillis-Steele steps over the 32 lane totals, s += the total
//      `off` lanes below for off = 1, 2, 4, 8, 16 (scan_step);
//   3. scan_finish: the exclusive prefix (the inclusive scan one lane
//      below, 0 for lane 0) added to each of the four partial sums.
// The row total is the last lane's last output.  Build with --fmad=false
// (nothing here may contract).

#pragma once

#include <stdint.h>

#ifndef PTT_HD
#if defined(__CUDACC__)
#define PTT_HD __host__ __device__ __forceinline__
#else
#define PTT_HD inline
#endif
#endif

#define PTT_SCAN_LANES 128
#define PTT_SCAN_WARP 32

PTT_HD void scan_quad(const float v[4], float q[4]) {
  q[0] = v[0];
  q[1] = q[0] + v[1];
  q[2] = q[1] + v[2];
  q[3] = q[2] + v[3];
}

// s: this lane's running inclusive total; below: the same value `off`
// lanes below (undefined where lane < off).
PTT_HD float scan_step(float s, float below, int lane, int off) {
  return lane >= off ? s + below : s;
}

// ex_below: the inclusive lane total one lane below (ignored for lane 0).
PTT_HD void scan_finish(float ex_below, int lane, const float q[4], float out[4]) {
  const float ex = lane == 0 ? 0.0f : ex_below;
  for (int k = 0; k < 4; ++k) out[k] = ex + q[k];
}
