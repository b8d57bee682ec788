// Host build of the scan kernel's per-lane steps (csrc/scan.cuh), so the
// CPU tests can hold the arithmetic ptt_scan_tile_kernel runs against the
// port's plain torch version.  One row is one warp: the 32 lanes run in
// lockstep over arrays, and each __shfl_up_sync of the kernel becomes a read
// of the previous step's array `off` lanes below.
//
// Built by tests/test_torch_kernel_body.py with
//   c++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC -I<csrc>

#include <stdint.h>

#include "scan.cuh"

extern "C" {

// ptt_scan_tile_kernel over rows [0, rows) of x [rows, 128].
void ptt_host_scan_tiles(const float* x, float* lane_out, float* tot_out, int32_t rows) {
  for (int32_t row = 0; row < rows; ++row) {
    const float* xr = x + (int64_t)row * PTT_SCAN_LANES;
    float q[PTT_SCAN_WARP][4], s[PTT_SCAN_WARP], below[PTT_SCAN_WARP];
    for (int lane = 0; lane < PTT_SCAN_WARP; ++lane) {
      scan_quad(xr + 4 * lane, q[lane]);
      s[lane] = q[lane][3];
    }
    for (int off = 1; off < PTT_SCAN_WARP; off <<= 1) {
      for (int lane = 0; lane < PTT_SCAN_WARP; ++lane) below[lane] = lane >= off ? s[lane - off] : s[lane];
      for (int lane = 0; lane < PTT_SCAN_WARP; ++lane) s[lane] = scan_step(s[lane], below[lane], lane, off);
    }
    for (int lane = 0; lane < PTT_SCAN_WARP; ++lane) {
      scan_finish(lane > 0 ? s[lane - 1] : s[lane], lane, q[lane],
                  lane_out + (int64_t)row * PTT_SCAN_LANES + 4 * lane);
    }
    tot_out[row] = lane_out[(int64_t)row * PTT_SCAN_LANES + PTT_SCAN_LANES - 1];
  }
}

}  // extern "C"
