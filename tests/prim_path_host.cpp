// Host build of the CUDA kernels' per-ray body (csrc/prim_path.cuh), so the
// CPU tests can hold the arithmetic the kernels run against the port's plain
// torch path.  Each function is the loop over rays that the matching kernel
// in csrc/fused_prim.cu runs as one thread per ray; ptt_host_iteration is
// the iteration kernel's per-pixel schedule (one thread a pixel, every
// depth), the reference its regenerating schedule (ptt_host_iteration_regen)
// is held to, and ptt_host_bounce the bounce kernel's per-ray schedule, the
// reference of its packed one (ptt_host_bounce_packed).
//
// Built by tests/test_torch_kernel_body.py with
//   c++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC -I<csrc>

#include <stdint.h>

#include <algorithm>
#include <vector>

#include "prim_path.cuh"

extern "C" {

int ptt_host_sizes(int32_t* out) {
  out[0] = (int32_t)sizeof(PttScene);
  out[1] = (int32_t)sizeof(PttCamera);
  return 2;
}

// ptt_uniforms_kernel's element loop: the [k, ln] block at pixels
// [base, base + ln) of an rng_n-pixel stream.
void ptt_host_uniforms(uint32_t k0, uint32_t k1, uint32_t ln, uint32_t k, uint32_t base,
                       uint32_t rng_n, float* out) {
  for (uint32_t flat = 0; flat < ln * k; ++flat)
    out[flat] = uniform_block(k0, k1, ln, base, rng_n, flat);
}

// ptt_bounce_kernel's per-ray schedule (one thread a ray, intersect_prims)
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

// Live ray i of the packed schedule: bounce_live with its uniforms (u
// [3, n], or drawn at counters j * rng_n + pixel[i] under (k0, k1)).
static void packed_bounce_one(const PttScene* s, const float* const* in_f,
                              const int32_t* in_bounces, const float* u, const int32_t* pixel,
                              uint32_t k0, uint32_t k1, uint32_t rng_n, float* const* out_f,
                              int32_t* out_bounces, int32_t n, int32_t i) {
  Ray ray;
  ray.o = v3(in_f[0][i], in_f[1][i], in_f[2][i]);
  ray.d = v3(in_f[3][i], in_f[4][i], in_f[5][i]);
  ray.c = v3(in_f[6][i], in_f[7][i], in_f[8][i]);
  ray.bounces = in_bounces[i];
  float uu[3];
  if (u == nullptr) {
    draw3(k0, k1, rng_n, (uint32_t)pixel[i], uu);
  } else {
    for (int j = 0; j < 3; ++j) uu[j] = u[(size_t)j * n + i];
  }
  bounce_live(*s, ray, uu[0], uu[1], uu[2]);
  const float o[9] = {ray.o.x, ray.o.y, ray.o.z, ray.d.x, ray.d.y, ray.d.z,
                      ray.c.x, ray.c.y, ray.c.z};
  for (int k = 0; k < 9; ++k) out_f[k][i] = o[k];
  out_bounces[i] = ray.bounces;
}

// ptt_bounce_kernel's packed schedule (the arguments of ptt_host_bounce,
// then the inline draw's pixel, key and stream length, used when u is
// null): `blocks` blocks of 8 warps of 32 lanes in lock step, the warps
// stepped in turn, each step one chunk of 32 consecutive rays, the next of
// one counter for all warps.  A chunk live whole with the queue empty bounces in place, else
// the dead rays are copied through and the live ones appended to the
// warp's queue, which bounces 32 whenever it holds 32.  Then each block
// deals its warps' leftovers, in order, over its 256 threads.  lanes[0] +=
// lane-bounces issued (32 a warp step that bounces), lanes[1] += live ones.
void ptt_host_bounce_packed(const PttScene* s, const float* const* in_f,
                            const int32_t* in_bounces, const float* u, float* const* out_f,
                            int32_t* out_bounces, int32_t n, const int32_t* pixel, uint32_t k0,
                            uint32_t k1, uint32_t rng_n, int32_t blocks, int64_t* lanes) {
  const int warps_per_block = 8;
  const int64_t chunks = ((int64_t)n + 31) / 32;
  const int64_t warps = (int64_t)blocks * warps_per_block;
  auto bounce = [&](int32_t i) {
    packed_bounce_one(s, in_f, in_bounces, u, pixel, k0, k1, rng_n, out_f, out_bounces, n, i);
  };
  std::vector<std::vector<int32_t>> q(warps);
  std::vector<int64_t> c(warps);
  int64_t next = 0;  // the counter
  for (int64_t w = 0; w < warps; ++w) c[w] = next++;
  for (bool stepped = true; stepped;) {
    stepped = false;
    for (int64_t w = 0; w < warps; ++w) {
      if (c[w] >= chunks) continue;
      stepped = true;
      int live = 0;
      for (int lane = 0; lane < 32; ++lane) {
        const int64_t i = c[w] * 32 + lane;
        live += (i < n && in_bounces[i] > 0) ? 1 : 0;
      }
      if (q[w].empty() && live == 32) {
        lanes[0] += 32;
        lanes[1] += 32;
        for (int lane = 0; lane < 32; ++lane) bounce((int32_t)(c[w] * 32 + lane));
      } else {
        for (int lane = 0; lane < 32; ++lane) {
          const int64_t i = c[w] * 32 + lane;
          if (i >= n) break;
          if (in_bounces[i] > 0) {
            q[w].push_back((int32_t)i);
          } else {
            for (int k = 0; k < 9; ++k) out_f[k][i] = in_f[k][i];
            out_bounces[i] = in_bounces[i];
          }
        }
        if (q[w].size() >= 32) {
          lanes[0] += 32;
          lanes[1] += 32;
          for (int lane = 0; lane < 32; ++lane) bounce(q[w][lane]);
          q[w].erase(q[w].begin(), q[w].begin() + 32);
        }
      }
      c[w] = next++;
    }
  }
  for (int32_t b = 0; b < blocks; ++b) {
    std::vector<int32_t> left;
    for (int w = 0; w < warps_per_block; ++w) {
      const std::vector<int32_t>& qw = q[(size_t)b * warps_per_block + w];
      left.insert(left.end(), qw.begin(), qw.end());
    }
    for (size_t t = 0; t < left.size(); t += 32) {
      lanes[0] += 32;
      lanes[1] += (int64_t)std::min<size_t>(32, left.size() - t);
    }
    for (int32_t i : left) bounce(i);
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
// in which a warp bounces), lanes[1] += live ones.  lobes, unless null, is
// the counting variant's tally: lobes[d * PTT_LOBES + lobe] += the paths
// that lobe scattered at depth d.
void ptt_host_iteration_regen(const PttScene* s, const PttCamera* cam, int32_t width,
                              int32_t height, int32_t n, int32_t depth, const uint32_t* keys,
                              float* film_x, float* film_y, float* film_z, int32_t* alive,
                              int32_t warps, int32_t refill_min, int64_t* lanes,
                              int32_t* lobes) {
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
        int slot = -1;
        const int d = lobes ? lane_bounce_lobe(*s, l[i], dkeys.data(), depth, (uint32_t)n, &slot)
                            : lane_bounce(*s, l[i], dkeys.data(), depth, (uint32_t)n);
        if (d >= 0) alive[d] += 1;
        if (slot >= 0) lobes[slot] += 1;
      }
    }
  }
}

}  // extern "C"
