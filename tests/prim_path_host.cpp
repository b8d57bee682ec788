// Host build of the CUDA kernels' per-ray body (csrc/prim_path.cuh), so the
// CPU tests can hold the arithmetic the kernels run against the port's plain
// torch path.  Each function is the loop over rays that the matching kernel
// in csrc/fused_prim.cu runs as one thread per ray; ptt_host_iteration is
// the iteration kernel's per-pixel schedule (one thread a pixel, every
// depth), the reference its regenerating schedule (ptt_host_iteration_regen)
// is held to.
//
// Built by tests/test_torch_kernel_body.py with
//   c++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC -I<csrc>

#include <stdint.h>

#include <vector>

#include "prim_path.cuh"

extern "C" {

int ptt_host_sizes(int32_t* out) {
  out[0] = (int32_t)sizeof(PttScene);
  out[1] = (int32_t)sizeof(PttCamera);
  return 2;
}

void ptt_host_uniforms(uint32_t k0, uint32_t k1, uint32_t total, float* out) {
  for (uint32_t flat = 0; flat < total; ++flat) out[flat] = uniform_at(k0, k1, flat);
}

// ptt_bounce_kernel
void ptt_host_bounce(const PttScene* s, const float* const* in_f, const int32_t* in_bounces,
                     const float* u, float* const* out_f, int32_t* out_bounces, int32_t n) {
  for (int32_t idx = 0; idx < n; ++idx) {
    Ray ray;
    ray.o = v3(in_f[0][idx], in_f[1][idx], in_f[2][idx]);
    ray.d = v3(in_f[3][idx], in_f[4][idx], in_f[5][idx]);
    ray.c = v3(in_f[6][idx], in_f[7][idx], in_f[8][idx]);
    ray.bounces = in_bounces[idx];
    bounce_ray(*s, ray, u[idx], u[n + idx], u[2 * n + idx]);
    out_f[0][idx] = ray.o.x;
    out_f[1][idx] = ray.o.y;
    out_f[2][idx] = ray.o.z;
    out_f[3][idx] = ray.d.x;
    out_f[4][idx] = ray.d.y;
    out_f[5][idx] = ray.d.z;
    out_f[6][idx] = ray.c.x;
    out_f[7][idx] = ray.c.y;
    out_f[8][idx] = ray.c.z;
    out_bounces[idx] = ray.bounces;
  }
}

// ptt_iteration_kernel: keys as in PttIterArgs (the camera key's two words,
// then the iteration key's, from which each depth's shade key is derived);
// film += color in place; alive[d] += rays alive after d.
void ptt_host_iteration(const PttScene* s, const PttCamera* cam, int32_t width,
                        int32_t height, int32_t n, int32_t depth, const uint32_t* keys,
                        float* film_x, float* film_y, float* film_z, int32_t* alive) {
  for (int32_t idx = 0; idx < n; ++idx) {
    Ray ray = camera_ray(*cam, width, height, depth, idx, (uint32_t)n, keys[0], keys[1]);
    for (int32_t d = 0; d < depth; ++d) {
      uint32_t k0, k1;
      shade_stage_key(keys[2], keys[3], (uint32_t)d, &k0, &k1);
      bounce_ray_inline(*s, ray, k0, k1, (uint32_t)n, idx);
      alive[d] += ray.bounces > 0 ? 1 : 0;
    }
    film_x[idx] = film_x[idx] + ray.c.x;
    film_y[idx] = film_y[idx] + ray.c.y;
    film_z[idx] = film_z[idx] + ray.c.z;
  }
}

// ptt_iteration_kernel's regenerating schedule (the arguments of
// ptt_host_iteration): `warps` warps of 32 lanes, stepped in turn, each
// step one pass of a warp's loop with its 32 lanes in lock step: the lanes
// whose paths are done write their pixels; once at least refill_min lanes
// are free they take the next pixels of one counter for all warps, in lane
// order; the live lanes bounce.  lanes[0] += lane-bounces issued (32 a step
// in which a warp bounces), lanes[1] += live ones.
void ptt_host_iteration_regen(const PttScene* s, const PttCamera* cam, int32_t width,
                              int32_t height, int32_t n, int32_t depth, const uint32_t* keys,
                              float* film_x, float* film_y, float* film_z, int32_t* alive,
                              int32_t warps, int32_t refill_min, int64_t* lanes) {
  std::vector<uint32_t> dkeys(2 * (size_t)depth);
  for (int32_t d = 0; d < depth; ++d) {
    shade_stage_key(keys[2], keys[3], (uint32_t)d, &dkeys[2 * d], &dkeys[2 * d + 1]);
  }
  std::vector<IterLane> lane((size_t)warps * 32);
  std::vector<bool> more(warps, true), done(warps, false);
  for (IterLane& l : lane) {
    l.pixel = -1;
    l.ray.bounces = 0;
  }
  int32_t next = 0;
  for (int32_t left = warps; left > 0;) {
    for (int32_t w = 0; w < warps; ++w) {
      if (done[w]) continue;
      IterLane* l = &lane[(size_t)w * 32];
      for (int i = 0; i < 32; ++i) {
        if (l[i].pixel >= 0 && l[i].ray.bounces <= 0) lane_finish(l[i], film_x, film_y, film_z);
      }
      if (more[w]) {
        int k = 0;
        for (int i = 0; i < 32; ++i) k += l[i].pixel < 0;
        if (k >= refill_min) {
          const int32_t base = next;
          next += k;
          int rank = 0;
          for (int i = 0; i < 32; ++i) {
            if (l[i].pixel >= 0) continue;
            const int32_t p = base + rank++;
            if (p < n) lane_start(l[i], p, *cam, width, height, depth, (uint32_t)n, keys[0], keys[1]);
          }
          more[w] = base + k < n;
        }
      }
      bool held = false, any_live = false;
      for (int i = 0; i < 32; ++i) {
        held = held || l[i].pixel >= 0;
        any_live = any_live || (l[i].pixel >= 0 && l[i].ray.bounces > 0);
      }
      if (!held && !more[w]) {
        done[w] = true;
        --left;
        continue;
      }
      if (any_live) lanes[0] += 32;
      for (int i = 0; i < 32; ++i) {
        if (l[i].pixel < 0 || l[i].ray.bounces <= 0) continue;
        lanes[1] += 1;
        const int d = lane_bounce(*s, l[i], dkeys.data(), depth, (uint32_t)n);
        if (d >= 0) alive[d] += 1;
      }
    }
  }
}

}  // extern "C"
