// Host build of the mesh kernels' per-ray bodies (csrc/mesh_path.cuh), so
// the CPU tests can hold the arithmetic the kernels run against the port's
// plain torch versions.  Each function is the loop over rays that the
// matching kernel in csrc/fused_mesh.cu or csrc/mesh_walk.cu runs as one
// thread per ray; the walks keep the kernels' block schedule (256 rays a
// block, the plan row in order, the block's exit vote), and the plan
// prepass its reduction over a block's rays (ptt_host_plan_prepass_live its
// compacted live rays, warps over tiles).  ptt_host_mono, ptt_host_walk,
// ptt_host_super, ptt_host_sweep, ptt_host_binned, ptt_host_lb_asc and
// ptt_host_epilogue_mono are the per-ray schedules, the references the
// block schedules (ptt_host_*_block: each tile's pairs spread over the
// threads) are held to.  ptt_host_packet_bins runs the four packet bins
// kernels of csrc/mesh_bins.cu in turn, each block's warps and lanes in
// order.
//
// Built by tests/test_torch_kernel_body.py with
//   c++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC -I<csrc>

#include <stdint.h>

#include <vector>

#include "mesh_path.cuh"

extern "C" {

int ptt_host_mesh_sizes(int32_t* out) {
  out[0] = (int32_t)sizeof(PttScene);
  out[1] = PTT_COEF_W;
  return 2;
}

// The per-ray schedule that ptt_mono_kernel had before its block schedule
// (ptt_host_mono_block): one thread a ray, mono_ray.
void ptt_host_mono(const float* coef, const float* aabb, int32_t ct, const float* box,
                   const float* center, const float* const* ray, const uint8_t* active,
                   const float* tlim, int32_t num_tris, float baby_eps, float eps_succ,
                   int32_t n, float* out_t, int32_t* out_tri) {
  const V3 c = v3(center[0], center[1], center[2]);
  for (int32_t i = 0; i < n; ++i) {
    mono_ray(coef, aabb, ct, box, c, v3(ray[0][i], ray[1][i], ray[2][i]),
             v3(ray[3][i], ray[4][i], ray[5][i]), active[i] != 0, tlim[i], num_tris, baby_eps,
             eps_succ, &out_t[i], &out_tri[i]);
  }
}

// mesh_surface over rays (ray: origin xyz, direction xyz): the normal
// (zero without a mesh hit) and material (-1 without one) of each ray's
// winner tri, from the rows of attrs (ops/fused.py::resolve_mesh_surface).
void ptt_host_mesh_surface(const float* attrs, int32_t rows, const int32_t* tri,
                           const float* const* ray, float baby_eps, int32_t n,
                           float* const* out_n, int32_t* out_mat) {
  for (int32_t i = 0; i < n; ++i) {
    V3 mn = v3(0.0f, 0.0f, 0.0f);
    out_mat[i] = mesh_surface(attrs, rows, tri[i], v3(ray[0][i], ray[1][i], ray[2][i]),
                              v3(ray[3][i], ray[4][i], ray[5][i]), baby_eps, &mn);
    out_n[0][i] = mn.x;
    out_n[1][i] = mn.y;
    out_n[2][i] = mn.z;
  }
}

// ptt_mesh_shade_kernel; emit: 0 none, 1 t_lim, 2 t_lim + key; mode: 0
// plain (each live lane's surface resolved from mesh_tri and the rows of
// attrs, as the kernel resolves it), 1 textured, 2 precomputed (mesh_n,
// mesh_mat and mesh_alb are read in modes 1 and 2); prim_win: the carried
// prim winner of each ray (null: test every prim); out_win (emit >= 1, may
// be null): the prim that gives out_tlim; aabb, box (the root box) and
// center: the key's tables (emit 2).
void ptt_host_mesh_shade_win(const PttScene* s, const float* const* in_f,
                             const int32_t* in_bounces, const int32_t* pixel,
                             const float* mesh_t, const float* const* mesh_n,
                             const int32_t* mesh_mat, const float* aabb, const float* box,
                             const float* center, float* const* out_f, int32_t* out_bounces,
                             float* out_tlim, int32_t* out_key, uint32_t k0, uint32_t k1,
                             uint32_t rng_n, int32_t n, int32_t ct, int32_t emit, int32_t mode,
                             const float* const* mesh_alb, const int32_t* prim_win,
                             int32_t* out_win, const int32_t* mesh_tri, const float* attrs,
                             int32_t rows, float baby_eps) {
  for (int32_t i = 0; i < n; ++i) {
    Ray ray;
    ray.o = v3(in_f[0][i], in_f[1][i], in_f[2][i]);
    ray.d = v3(in_f[3][i], in_f[4][i], in_f[5][i]);
    ray.c = v3(in_f[6][i], in_f[7][i], in_f[8][i]);
    ray.bounces = in_bounces[i];
    V3 mn = v3(0.0f, 0.0f, 0.0f), alb = mn;
    int32_t mmat = -1;
    if (mode != PTT_SHADE_PLAIN) {
      mn = v3(mesh_n[0][i], mesh_n[1][i], mesh_n[2][i]);
      mmat = mesh_mat[i];
      alb = v3(mesh_alb[0][i], mesh_alb[1][i], mesh_alb[2][i]);
    } else if (ray.bounces > 0) {
      mmat = mesh_surface(attrs, rows, mesh_tri[i], ray.o, ray.d, baby_eps, &mn);
    }
    mesh_shade_ray(*s, ray, mesh_t[i], mn, mmat, mode, alb, k0, k1, rng_n, pixel[i],
                   prim_win ? prim_win[i] : PTT_NO_WINNER);
    out_f[0][i] = ray.o.x;
    out_f[1][i] = ray.o.y;
    out_f[2][i] = ray.o.z;
    out_f[3][i] = ray.d.x;
    out_f[4][i] = ray.d.y;
    out_f[5][i] = ray.d.z;
    out_f[6][i] = ray.c.x;
    out_f[7][i] = ray.c.y;
    out_f[8][i] = ray.c.z;
    out_bounces[i] = ray.bounces;
    if (emit >= 1) {
      int32_t win;
      out_tlim[i] = prim_t_min_win(*s, ray.o, ray.d, &win);
      if (out_win) out_win[i] = win;
      if (emit == 2) {
        out_key[i] = coherence_key(aabb, ct, box, v3(center[0], center[1], center[2]), ray.o,
                                   ray.d, ray.bounces > 0, out_tlim[i]);
      }
    }
  }
}

// The same without the winner: every prim tested.
void ptt_host_mesh_shade(const PttScene* s, const float* const* in_f, const int32_t* in_bounces,
                         const int32_t* pixel, const float* mesh_t, const float* const* mesh_n,
                         const int32_t* mesh_mat, const float* aabb, const float* box,
                         const float* center, float* const* out_f, int32_t* out_bounces,
                         float* out_tlim, int32_t* out_key, uint32_t k0, uint32_t k1,
                         uint32_t rng_n, int32_t n, int32_t ct, int32_t emit, int32_t mode,
                         const float* const* mesh_alb, const int32_t* mesh_tri,
                         const float* attrs, int32_t rows, float baby_eps) {
  ptt_host_mesh_shade_win(s, in_f, in_bounces, pixel, mesh_t, mesh_n, mesh_mat, aabb, box,
                          center, out_f, out_bounces, out_tlim, out_key, k0, k1, rng_n, n, ct,
                          emit, mode, mesh_alb, nullptr, nullptr, mesh_tri, attrs, rows,
                          baby_eps);
}

// coherence_key over rays (ray: origin xyz, direction xyz; alive: 0/1).
void ptt_host_coherence_key(const float* aabb, int32_t ct, const float* box, const float* center,
                            const float* const* ray, const uint8_t* alive, const float* tlim,
                            int32_t n, int32_t* out_key) {
  const V3 c = v3(center[0], center[1], center[2]);
  for (int32_t i = 0; i < n; ++i) {
    out_key[i] = coherence_key(aabb, ct, box, c, v3(ray[0][i], ray[1][i], ray[2][i]),
                               v3(ray[3][i], ray[4][i], ray[5][i]), alive[i] != 0, tlim[i]);
  }
}

// ptt_mesh_prelude_kernel: bounce 0's t_lim, winner (out_win, may be null)
// and with emit 2 key of the rays in_f[0..5], alive where in_bounces > 0.
void ptt_host_mesh_prelude(const PttScene* s, const float* const* in_f,
                           const int32_t* in_bounces, const float* aabb, const float* box,
                           const float* center, float* out_tlim, int32_t* out_key,
                           int32_t* out_win, int32_t n, int32_t ct, int32_t emit) {
  for (int32_t i = 0; i < n; ++i) {
    const V3 o = v3(in_f[0][i], in_f[1][i], in_f[2][i]);
    const V3 d = v3(in_f[3][i], in_f[4][i], in_f[5][i]);
    int32_t win;
    out_tlim[i] = prim_t_min_win(*s, o, d, &win);
    if (out_win) out_win[i] = win;
    if (emit == 2) {
      out_key[i] = coherence_key(aabb, ct, box, v3(center[0], center[1], center[2]), o, d,
                                 in_bounces[i] > 0, out_tlim[i]);
    }
  }
}

// The per-ray schedule of the planned walks, without (exit 0) and with
// (exit 1) the early exit, which the planned and streamed kernels had
// before their block schedule: each block of 256 rays walks its plan row,
// one thread a ray; with exit, the block's vote becomes the loop over its
// rays.  The reference the block schedules are held to.
void ptt_host_walk(const float* coef, const float* aabb, int32_t ct, const float* center,
                   const float* const* ray, const uint8_t* live, const float* tlim,
                   const int32_t* ids, const float* tlo, const int32_t* cnt, int32_t exit_,
                   float baby_eps, float eps_succ, int32_t n, float* out_t, int32_t* out_tri) {
  const V3 c = v3(center[0], center[1], center[2]);
  const int32_t nb = (n + PTT_RAY_TILE - 1) / PTT_RAY_TILE;
  std::vector<WalkRay> r(PTT_RAY_TILE);
  for (int32_t b = 0; b < nb; ++b) {
    for (int32_t i = 0; i < PTT_RAY_TILE; ++i) {
      const int32_t idx = b * PTT_RAY_TILE + i;
      const bool in = idx < n;
      r[i] = walk_ray(c, in ? v3(ray[0][idx], ray[1][idx], ray[2][idx]) : v3(0.0f, 0.0f, 0.0f),
                      in ? v3(ray[3][idx], ray[4][idx], ray[5][idx]) : v3(0.0f, 0.0f, 0.0f),
                      in && live[idx] != 0, in ? tlim[idx] : 0.0f);
    }
    for (int32_t t = 0; t < cnt[b]; ++t) {
      if (exit_) {
        bool go = false;
        for (int32_t i = 0; i < PTT_RAY_TILE; ++i) go = go || walk_goes_on(r[i], tlo[b * ct + t]);
        if (!go) break;
      }
      const int32_t tile = ids[b * ct + t];
      for (int32_t i = 0; i < PTT_RAY_TILE; ++i) {
        walk_visit(r[i], coef, aabb + 8 * tile, tile, exit_ != 0, baby_eps, eps_succ);
      }
    }
    for (int32_t i = 0; i < PTT_RAY_TILE && b * PTT_RAY_TILE + i < n; ++i) {
      out_t[b * PTT_RAY_TILE + i] = r[i].best;
      out_tri[b * PTT_RAY_TILE + i] = r[i].best_tri;
    }
  }
}

// The block schedule of ptt_mono_kernel, ptt_planned_lanebest_kernel,
// ptt_planned_kernel, ptt_streamed_kernel, ptt_streamed_super_kernel,
// ptt_sweep_kernel and ptt_binned_kernel, one block at a time: its 256 rays
// and their keys.
struct HostBlock {
  std::vector<WalkRay> r = std::vector<WalkRay>(PTT_RAY_TILE);
  std::vector<uint64_t> key = std::vector<uint64_t>(PTT_RAY_TILE);
  std::vector<int32_t> list = std::vector<int32_t>(PTT_RAY_TILE);
  std::vector<float> lo = std::vector<float>(PTT_RAY_TILE), hi = std::vector<float>(PTT_RAY_TILE);
  std::vector<float> k = std::vector<float>((size_t)PTT_SPREAD * PTT_COEF_W);
};

// spread_ray for thread i: ray idx, not live unless in.
static void host_ray(HostBlock& hb, int32_t i, V3 c, const float* const* ray, const uint8_t* live,
                     const float* tlim, long long idx, bool in) {
  hb.r[i] = walk_ray(c, in ? v3(ray[0][idx], ray[1][idx], ray[2][idx]) : v3(0.0f, 0.0f, 0.0f),
                     in ? v3(ray[3][idx], ray[4][idx], ray[5][idx]) : v3(0.0f, 0.0f, 0.0f),
                     in && live[idx] != 0, in ? tlim[idx] : 0.0f);
  hb.key[i] = walk_key(hb.r[i].best, hb.r[i].best_tri);
}

// spread_ray for every thread of block b: rays past n are not live.
static void host_block_rays(HostBlock& hb, int32_t b, V3 c, const float* const* ray,
                            const uint8_t* live, const float* tlim, int32_t n) {
  for (int32_t i = 0; i < PTT_RAY_TILE; ++i) {
    const int32_t idx = b * PTT_RAY_TILE + i;
    host_ray(hb, i, c, ray, live, tlim, idx, idx < n);
  }
}

// spread_entry: every ray's take (may[i] besides walk_take's member test,
// gate and pair window; may nullptr: every ray may), the takers listed in
// thread order, as the warp ballots and per-warp counts list them; each
// thread's triangles (spread_load) against every listed ray (spread_key);
// each ray's key the minimum of the keys it is given, as the shared-memory
// atomicMin leaves it; then every ray's best read back.
static void host_spread_entry(HostBlock& hb, const float* coef, const float* row, int32_t tile,
                              const uint8_t* may, float baby_eps, float eps_succ) {
  float(*kk)[PTT_COEF_W] = reinterpret_cast<float(*)[PTT_COEF_W]>(hb.k.data());
  int32_t m = 0;
  for (int32_t i = 0; i < PTT_RAY_TILE; ++i) {
    float l = 0.0f, h = 0.0f;
    if ((may == nullptr || may[i]) && walk_take(hb.r[i], row, eps_succ, &l, &h)) {
      hb.list[m] = i;
      hb.lo[m] = l;
      hb.hi[m] = h;
      ++m;
    }
  }
  if (m == 0) return;
  for (int32_t tid = 0; tid < PTT_SPREAD_THREADS; ++tid) {
    spread_load(coef, tile, tid, kk);
    for (int32_t j = 0; j < m; ++j) {
      const int32_t i = hb.list[j];
      const uint64_t got =
          spread_key(hb.r[i].f, hb.lo[j], hb.hi[j], kk, tile * PTT_TRI_TILE + tid, baby_eps);
      hb.key[i] = got < hb.key[i] ? got : hb.key[i];
    }
  }
  for (int32_t i = 0; i < PTT_RAY_TILE; ++i) {
    walk_unkey(hb.key[i], &hb.r[i].best, &hb.r[i].best_tri);
  }
}

// The block's exit vote before a plan entry of bound tlo.
static bool host_block_goes_on(const HostBlock& hb, float tlo) {
  bool go = false;
  for (int32_t i = 0; i < PTT_RAY_TILE; ++i) go = go || walk_goes_on(hb.r[i], tlo);
  return go;
}

// spread_out: a tri at or past num_tris is written -1.
static void host_block_out(const HostBlock& hb, int32_t b, int32_t n, float* out_t,
                           int32_t* out_tri, int32_t num_tris = PTT_INT_MAX) {
  for (int32_t i = 0; i < PTT_RAY_TILE && b * PTT_RAY_TILE + i < n; ++i) {
    out_t[b * PTT_RAY_TILE + i] = hb.r[i].best;
    out_tri[b * PTT_RAY_TILE + i] = hb.r[i].best_tri >= num_tris ? -1 : hb.r[i].best_tri;
  }
}

// ptt_streamed_kernel and ptt_planned_kernel (exit 1: per plan entry the
// exit vote, then the entry's tile) and ptt_planned_lanebest_kernel (exit
// 0: every entry's tile, no vote).
void ptt_host_streamed_block(const float* coef, const float* aabb, int32_t ct,
                             const float* center, const float* const* ray, const uint8_t* live,
                             const float* tlim, const int32_t* ids, const float* tlo,
                             const int32_t* cnt, int32_t exit_, float baby_eps, float eps_succ,
                             int32_t n, float* out_t, int32_t* out_tri) {
  const V3 c = v3(center[0], center[1], center[2]);
  HostBlock hb;
  for (int32_t b = 0; b < (n + PTT_RAY_TILE - 1) / PTT_RAY_TILE; ++b) {
    host_block_rays(hb, b, c, ray, live, tlim, n);
    for (int32_t t = 0; t < cnt[b]; ++t) {
      if (exit_ && !host_block_goes_on(hb, tlo[b * ct + t])) break;
      const int32_t tile = ids[b * ct + t];
      host_spread_entry(hb, coef, aabb + 8 * tile, tile, nullptr, baby_eps, eps_succ);
    }
    host_block_out(hb, b, n, out_t, out_tri);
  }
}

// ptt_streamed_super_kernel: per plan entry (a super-tile of cs = ceil(ct /
// 8) columns) the exit vote and every ray's gate on the super box, then its
// member tiles below ct that are no padding.
void ptt_host_super_block(const float* coef, const float* aabb, const float* saabb, int32_t ct,
                          int32_t cs, const float* center, const float* const* ray,
                          const uint8_t* live, const float* tlim, const int32_t* ids,
                          const float* tlo, const int32_t* cnt, float baby_eps, float eps_succ,
                          int32_t n, float* out_t, int32_t* out_tri) {
  const V3 c = v3(center[0], center[1], center[2]);
  HostBlock hb;
  std::vector<uint8_t> gate(PTT_RAY_TILE);
  for (int32_t b = 0; b < (n + PTT_RAY_TILE - 1) / PTT_RAY_TILE; ++b) {
    host_block_rays(hb, b, c, ray, live, tlim, n);
    for (int32_t t = 0; t < cnt[b]; ++t) {
      if (!host_block_goes_on(hb, tlo[b * cs + t])) break;
      const int32_t sid = ids[b * cs + t];
      for (int32_t i = 0; i < PTT_RAY_TILE; ++i) gate[i] = super_take(hb.r[i], saabb + 8 * sid);
      for (int32_t k = 0; k < PTT_SUPER_TILES; ++k) {
        const int32_t tile = sid * PTT_SUPER_TILES + k;
        if (tile >= ct) break;
        if (padding_tile(aabb + 8 * tile)) continue;
        host_spread_entry(hb, coef, aabb + 8 * tile, tile, gate.data(), baby_eps, eps_succ);
      }
    }
    host_block_out(hb, b, n, out_t, out_tri);
  }
}

// sweep_spread: tiles 0..ct-1 in order, a block with no live ray skipped;
// with a root box (mono), each ray's root cull joins its live flag and a
// tri at or past num_tris is written -1.
static void host_sweep_blocks(const float* coef, const float* aabb, int32_t ct, const float* box,
                              const float* center, const float* const* ray, const uint8_t* live,
                              const float* tlim, int32_t num_tris, float baby_eps,
                              float eps_succ, int32_t n, float* out_t, int32_t* out_tri) {
  const V3 c = v3(center[0], center[1], center[2]);
  HostBlock hb;
  for (int32_t b = 0; b < (n + PTT_RAY_TILE - 1) / PTT_RAY_TILE; ++b) {
    host_block_rays(hb, b, c, ray, live, tlim, n);
    bool any = false;
    for (int32_t i = 0; i < PTT_RAY_TILE; ++i) {
      WalkRay& r = hb.r[i];
      if (box) r.live = r.live && root_hit(box, r.os, r.inv, r.tlim);
      any = any || r.live;
    }
    for (int32_t t = 0; any && t < ct; ++t) {
      host_spread_entry(hb, coef, aabb + 8 * t, t, nullptr, baby_eps, eps_succ);
    }
    host_block_out(hb, b, n, out_t, out_tri, num_tris);
  }
}

// ptt_sweep_kernel.
void ptt_host_sweep_block(const float* coef, const float* aabb, int32_t ct, const float* center,
                          const float* const* ray, const uint8_t* live, const float* tlim,
                          float baby_eps, float eps_succ, int32_t n, float* out_t,
                          int32_t* out_tri) {
  host_sweep_blocks(coef, aabb, ct, nullptr, center, ray, live, tlim, PTT_INT_MAX, baby_eps,
                    eps_succ, n, out_t, out_tri);
}

// ptt_mono_kernel (the arguments of ptt_host_mono).
void ptt_host_mono_block(const float* coef, const float* aabb, int32_t ct, const float* box,
                         const float* center, const float* const* ray, const uint8_t* active,
                         const float* tlim, int32_t num_tris, float baby_eps, float eps_succ,
                         int32_t n, float* out_t, int32_t* out_tri) {
  host_sweep_blocks(coef, aabb, ct, box, center, ray, active, tlim, num_tris, baby_eps,
                    eps_succ, n, out_t, out_tri);
}

// ptt_binned_kernel: per visit v one spread_entry of its tile against its
// 256 pair rows (an empty slot's row, or one past n, not live); a row with
// no hit below its t_limit (tri -1) written (inf, -1), as is every row of
// an empty visit.  The arguments of ptt_host_binned.
void ptt_host_binned_block(const float* coef, const float* aabb, const float* center,
                           const float* const* ray, const uint8_t* live, const float* tlim,
                           const int32_t* vt, const int32_t* src, int32_t n, int32_t n_g,
                           int32_t nv, float baby_eps, float eps_succ, float* out_t,
                           int32_t* out_tri) {
  const V3 c = v3(center[0], center[1], center[2]);
  HostBlock hb;
  for (int32_t v = 0; v < nv; ++v) {
    const int32_t tile = vt[v];
    for (int32_t row = 0; row < PTT_RAY_TILE; ++row) {
      const int32_t p = src[v * (PTT_RAY_TILE / PTT_BINNED_G) + row / PTT_BINNED_G];
      const long long i = (long long)p * PTT_BINNED_G + row % PTT_BINNED_G;
      host_ray(hb, row, c, ray, live, tlim, i, tile >= 0 && p < n_g && i < n);
    }
    if (tile >= 0) host_spread_entry(hb, coef, aabb + 8 * tile, tile, nullptr, baby_eps, eps_succ);
    for (int32_t row = 0; row < PTT_RAY_TILE; ++row) {
      const bool hit = hb.r[row].best_tri >= 0;
      out_t[v * PTT_RAY_TILE + row] = hit ? hb.r[row].best : ptt_inf();
      out_tri[v * PTT_RAY_TILE + row] = hit ? hb.r[row].best_tri : -1;
    }
  }
}

// ptt_streamed_super_kernel: each block walks its plan row of super-tiles
// (cs = ceil(ct / 8) columns) with the exit vote per entry.
void ptt_host_super(const float* coef, const float* aabb, const float* saabb, int32_t ct,
                    int32_t cs, const float* center, const float* const* ray,
                    const uint8_t* live, const float* tlim, const int32_t* ids,
                    const float* tlo, const int32_t* cnt, float baby_eps, float eps_succ,
                    int32_t n, float* out_t, int32_t* out_tri) {
  const V3 c = v3(center[0], center[1], center[2]);
  const int32_t nb = (n + PTT_RAY_TILE - 1) / PTT_RAY_TILE;
  std::vector<WalkRay> r(PTT_RAY_TILE);
  for (int32_t b = 0; b < nb; ++b) {
    for (int32_t i = 0; i < PTT_RAY_TILE; ++i) {
      const int32_t idx = b * PTT_RAY_TILE + i;
      const bool in = idx < n;
      r[i] = walk_ray(c, in ? v3(ray[0][idx], ray[1][idx], ray[2][idx]) : v3(0.0f, 0.0f, 0.0f),
                      in ? v3(ray[3][idx], ray[4][idx], ray[5][idx]) : v3(0.0f, 0.0f, 0.0f),
                      in && live[idx] != 0, in ? tlim[idx] : 0.0f);
    }
    for (int32_t t = 0; t < cnt[b]; ++t) {
      bool go = false;
      for (int32_t i = 0; i < PTT_RAY_TILE; ++i) go = go || walk_goes_on(r[i], tlo[b * cs + t]);
      if (!go) break;
      const int32_t sid = ids[b * cs + t];
      for (int32_t i = 0; i < PTT_RAY_TILE; ++i) {
        super_visit(r[i], coef, aabb, saabb + 8 * sid, sid, ct, baby_eps, eps_succ);
      }
    }
    for (int32_t i = 0; i < PTT_RAY_TILE && b * PTT_RAY_TILE + i < n; ++i) {
      out_t[b * PTT_RAY_TILE + i] = r[i].best;
      out_tri[b * PTT_RAY_TILE + i] = r[i].best_tri;
    }
  }
}

// The per-ray schedule that ptt_lb_asc_kernel had before its block
// schedules (ptt_host_lb_asc_block; mm 0: lb_asc, 1: lb_mm): each block
// walks its plan row of ascending tile ids, one thread a ray.
void ptt_host_lb_asc(const float* coef, const float* aabb, int32_t ct, const float* center,
                     const float* const* ray, const uint8_t* live, const float* tlim,
                     const int32_t* ids, const int32_t* cnt, int32_t mm, float baby_eps,
                     float eps_succ, int32_t n, float* out_t, int32_t* out_tri) {
  const V3 c = v3(center[0], center[1], center[2]);
  for (int32_t i = 0; i < n; ++i) {
    const int32_t b = i / PTT_RAY_TILE;
    WalkRay r = walk_ray(c, v3(ray[0][i], ray[1][i], ray[2][i]),
                         v3(ray[3][i], ray[4][i], ray[5][i]), live[i] != 0, tlim[i]);
    if (mm) mm_ray(r);
    for (int32_t t = 0; t < cnt[b]; ++t) {
      const int32_t tile = ids[b * ct + t];
      if (mm) {
        mm_fold(r, coef, tile);
      } else {
        asc_visit(r, coef, aabb + 8 * tile, tile, true, baby_eps, eps_succ);
      }
    }
    if (mm) mm_resolve(r);
    out_t[i] = r.best;
    out_tri[i] = r.best_tri;
  }
}

// The per-ray schedule that ptt_epilogue_mono_kernel had before its
// full-width schedule (ptt_host_epilogue_mono_block; flavor 0 full, 1
// gate, 2 mm): the block's live vote and, for "gate", its member vote per
// tile become loops over its rays.
void ptt_host_epilogue_mono(const float* coef, const float* aabb, int32_t ct, const float* center,
                            const float* const* ray, const uint8_t* live, const float* tlim,
                            int32_t flavor, float baby_eps, float eps_succ, int32_t n,
                            float* out_t, int32_t* out_tri) {
  const V3 c = v3(center[0], center[1], center[2]);
  const int32_t nb = (n + PTT_RAY_TILE - 1) / PTT_RAY_TILE;
  std::vector<WalkRay> r(PTT_RAY_TILE);
  std::vector<Slab> s(PTT_RAY_TILE);
  std::vector<uint8_t> member(PTT_RAY_TILE);
  for (int32_t b = 0; b < nb; ++b) {
    bool block_live = false;
    for (int32_t i = 0; i < PTT_RAY_TILE; ++i) {
      const int32_t idx = b * PTT_RAY_TILE + i;
      const bool in = idx < n;
      r[i] = walk_ray(c, in ? v3(ray[0][idx], ray[1][idx], ray[2][idx]) : v3(0.0f, 0.0f, 0.0f),
                      in ? v3(ray[3][idx], ray[4][idx], ray[5][idx]) : v3(0.0f, 0.0f, 0.0f),
                      in && live[idx] != 0, in ? tlim[idx] : 0.0f);
      block_live = block_live || r[i].live;
    }
    if (block_live) {
      if (flavor == 2) {
        for (int32_t i = 0; i < PTT_RAY_TILE; ++i) mm_ray(r[i]);
      }
      for (int32_t t = 0; t < ct; ++t) {
        if (flavor == 2) {
          for (int32_t i = 0; i < PTT_RAY_TILE; ++i) mm_fold(r[i], coef, t);
          continue;
        }
        bool any = false;
        for (int32_t i = 0; i < PTT_RAY_TILE; ++i) {
          member[i] = asc_member(r[i], aabb + 8 * t, &s[i]) ? 1 : 0;
          any = any || member[i];
        }
        if (flavor == 1 && !any) continue;
        for (int32_t i = 0; i < PTT_RAY_TILE; ++i) {
          asc_fold(r[i], coef, t, member[i] != 0, s[i], baby_eps, eps_succ);
        }
      }
      if (flavor == 2) {
        for (int32_t i = 0; i < PTT_RAY_TILE; ++i) mm_resolve(r[i]);
      }
    }
    for (int32_t i = 0; i < PTT_RAY_TILE && b * PTT_RAY_TILE + i < n; ++i) {
      out_t[b * PTT_RAY_TILE + i] = r[i].best;
      out_tri[b * PTT_RAY_TILE + i] = r[i].best_tri;
    }
  }
}

// wide_spread's per-tile step: the exact flavors' (0 full, 1 gate) pair
// windows by ray (asc_fold's, or (inf, -inf) for a ray that is not a live
// member) and gate's member vote; then every thread's triangles
// (spread_load) against every ray of the block: wide_key where the ray's
// window can be entered, and the floor's (2) wide_mm_key for every ray;
// each ray's key the minimum of the keys it is given, as the shared-memory
// atomicMin (after the floors' warp reductions) leaves it.
static void host_wide_tile(HostBlock& hb, const float* coef, const float* row, int32_t tile,
                           int32_t flavor, float baby_eps, float eps_succ) {
  float(*kk)[PTT_COEF_W] = reinterpret_cast<float(*)[PTT_COEF_W]>(hb.k.data());
  if (flavor != 2) {
    bool any = false;
    for (int32_t i = 0; i < PTT_RAY_TILE; ++i) {
      Slab s;
      const bool member = asc_member(hb.r[i], row, &s);
      hb.lo[i] = member ? ptt_max(s.lo, eps_succ) : ptt_inf();
      hb.hi[i] = member ? s.hi : -ptt_inf();
      any = any || member;
    }
    if (flavor == 1 && !any) return;
  }
  for (int32_t tid = 0; tid < PTT_SPREAD_THREADS; ++tid) {
    spread_load(coef, tile, tid, kk);
    for (int32_t j = 0; j < PTT_RAY_TILE; ++j) {
      uint64_t got;
      if (flavor == 2) {
        got = wide_mm_key(hb.r[j].f, kk, tid);
      } else if (hb.lo[j] <= hb.hi[j]) {
        got = wide_key(hb.r[j].f, hb.lo[j], hb.hi[j], kk, tile * PTT_TRI_TILE + tid, baby_eps);
      } else {
        continue;
      }
      hb.key[j] = got < hb.key[j] ? got : hb.key[j];
    }
  }
}

// wide_spread: per block its rays (a floor's through mm_ray, its keys the
// floor's first keys), then the tiles of its plan row (ids, cnt: #13a's
// floor) or, with ids null, every tile 0..ct-1 when some ray of the block is
// live (#13b); each ray's key read back by walk_unkey or, for a floor,
// mm_unkey.
static void host_wide_blocks(const float* coef, const float* aabb, int32_t ct,
                             const float* center, const float* const* ray, const uint8_t* live,
                             const float* tlim, const int32_t* ids, const int32_t* cnt,
                             int32_t flavor, float baby_eps, float eps_succ, int32_t n,
                             float* out_t, int32_t* out_tri) {
  const V3 c = v3(center[0], center[1], center[2]);
  HostBlock hb;
  for (int32_t b = 0; b < (n + PTT_RAY_TILE - 1) / PTT_RAY_TILE; ++b) {
    host_block_rays(hb, b, c, ray, live, tlim, n);
    bool go = ids != nullptr;
    for (int32_t i = 0; i < PTT_RAY_TILE; ++i) {
      WalkRay& r = hb.r[i];
      go = go || r.live;
      if (flavor == 2) {
        mm_ray(r);
        hb.key[i] = mm_key(r.best, r.best_tri);
      }
    }
    const int32_t tiles = !go ? 0 : ids ? cnt[b] : ct;
    for (int32_t t = 0; t < tiles; ++t) {
      const int32_t tile = ids ? ids[b * ct + t] : t;
      host_wide_tile(hb, coef, aabb + 8 * tile, tile, flavor, baby_eps, eps_succ);
    }
    for (int32_t i = 0; i < PTT_RAY_TILE && b * PTT_RAY_TILE + i < n; ++i) {
      float* t = &out_t[b * PTT_RAY_TILE + i];
      int32_t* tri = &out_tri[b * PTT_RAY_TILE + i];
      if (flavor == 2) {
        mm_unkey(hb.key[i], hb.r[i].tlim, t, tri);
      } else {
        walk_unkey(hb.key[i], t, tri);
      }
    }
  }
}

// ptt_lb_asc_kernel's block schedules (the arguments of ptt_host_lb_asc):
// mm 0, lb_asc, the planned lane-best walk's (host_spread_entry per entry
// of the ascending plan row); mm 1, lb_mm, the full-width floor over the
// same rows.
void ptt_host_lb_asc_block(const float* coef, const float* aabb, int32_t ct, const float* center,
                           const float* const* ray, const uint8_t* live, const float* tlim,
                           const int32_t* ids, const int32_t* cnt, int32_t mm, float baby_eps,
                           float eps_succ, int32_t n, float* out_t, int32_t* out_tri) {
  if (mm) {
    host_wide_blocks(coef, aabb, ct, center, ray, live, tlim, ids, cnt, 2, baby_eps, eps_succ,
                     n, out_t, out_tri);
    return;
  }
  const V3 c = v3(center[0], center[1], center[2]);
  HostBlock hb;
  for (int32_t b = 0; b < (n + PTT_RAY_TILE - 1) / PTT_RAY_TILE; ++b) {
    host_block_rays(hb, b, c, ray, live, tlim, n);
    for (int32_t t = 0; t < cnt[b]; ++t) {
      const int32_t tile = ids[b * ct + t];
      host_spread_entry(hb, coef, aabb + 8 * tile, tile, nullptr, baby_eps, eps_succ);
    }
    host_block_out(hb, b, n, out_t, out_tri);
  }
}

// ptt_epilogue_mono_kernel's full-width schedule (flavor 0 full, 1 gate, 2
// mm; the arguments of ptt_host_epilogue_mono).
void ptt_host_epilogue_mono_block(const float* coef, const float* aabb, int32_t ct,
                                  const float* center, const float* const* ray,
                                  const uint8_t* live, const float* tlim, int32_t flavor,
                                  float baby_eps, float eps_succ, int32_t n, float* out_t,
                                  int32_t* out_tri) {
  host_wide_blocks(coef, aabb, ct, center, ray, live, tlim, nullptr, nullptr, flavor, baby_eps,
                   eps_succ, n, out_t, out_tri);
}

// ptt_sweep_kernel: one ray per thread, every tile in order.
void ptt_host_sweep(const float* coef, const float* aabb, int32_t ct, const float* center,
                    const float* const* ray, const uint8_t* live, const float* tlim,
                    float baby_eps, float eps_succ, int32_t n, float* out_t, int32_t* out_tri) {
  const V3 c = v3(center[0], center[1], center[2]);
  for (int32_t i = 0; i < n; ++i) {
    WalkRay r = walk_ray(c, v3(ray[0][i], ray[1][i], ray[2][i]),
                         v3(ray[3][i], ray[4][i], ray[5][i]), live[i] != 0, tlim[i]);
    sweep_ray(r, coef, aabb, ct, baby_eps, eps_succ);
    out_t[i] = r.best;
    out_tri[i] = r.best_tri;
  }
}

// ptt_plan_prepass_kernel's per-block schedule before its live rays were
// compacted (the reference of ptt_host_plan_prepass_live): per (block,
// tile), any and min over the block's 256 rays (ray: recentred origins and
// directions, padded to whole blocks).
void ptt_host_plan_prepass(const float* aabb, int32_t ct, const float* const* ray,
                           const uint8_t* live, const float* tlim, int32_t nb, uint8_t* out_h,
                           float* out_lb) {
  for (int32_t b = 0; b < nb; ++b) {
    for (int32_t c = 0; c < ct; ++c) {
      bool any = false;
      float best = ptt_inf();
      for (int32_t i = b * PTT_RAY_TILE; i < (b + 1) * PTT_RAY_TILE; ++i) {
        float key;
        if (plan_pair(aabb + 8 * c, v3(ray[0][i], ray[1][i], ray[2][i]),
                      inv_dir(v3(ray[3][i], ray[4][i], ray[5][i])), live[i] != 0, tlim[i],
                      &key)) {
          any = true;
          best = key < best ? key : best;
        }
      }
      out_h[b * ct + c] = any ? 1 : 0;
      out_lb[b * ct + c] = best;
    }
  }
}

// ptt_plan_prepass_kernel's schedule: CTA (b, y) of ray block b takes the
// tiles [y * split, (y + 1) * split) of its row; its live rays, compacted
// in order, are dealt over 8 warps of 32 lanes (tiles c = c0 + w, c0 + w
// + 8, ... to warp w; rays r = lane, lane + 32, ... to each lane), each lane
// folding its rays' keys as ints, then the warp's any and int minimum.
void ptt_host_plan_prepass_live(const float* aabb, int32_t ct, const float* const* ray,
                                const uint8_t* live, const float* tlim, int32_t nb,
                                int32_t split, uint8_t* out_h, float* out_lb) {
  const int warps = PTT_RAY_TILE / 32;
  std::vector<int32_t> rays;
  for (int32_t b = 0; b < nb; ++b) {
    rays.clear();
    for (int32_t i = b * PTT_RAY_TILE; i < (b + 1) * PTT_RAY_TILE; ++i) {
      if (live[i]) rays.push_back(i);
    }
    const int total = (int)rays.size();
    for (int32_t c0 = 0; c0 < ct; c0 += split) {
      const int32_t c1 = c0 + split < ct ? c0 + split : ct;
      for (int w = 0; w < warps; ++w) {
        for (int32_t c = c0 + w; c < c1; c += warps) {
          bool any = false;
          int32_t best = ptt_as_int(ptt_inf());
          for (int lane = 0; lane < 32; ++lane) {
            bool lane_any = false;
            int32_t lane_best = ptt_as_int(ptt_inf());
            for (int r = lane; r < total; r += 32) {
              const int32_t i = rays[r];
              float key;
              if (plan_pair(aabb + 8 * c, v3(ray[0][i], ray[1][i], ray[2][i]),
                            inv_dir(v3(ray[3][i], ray[4][i], ray[5][i])), true, tlim[i],
                            &key)) {
                lane_any = true;
                lane_best = ptt_as_int(key) < lane_best ? ptt_as_int(key) : lane_best;
              }
            }
            any = any || lane_any;
            best = lane_best < best ? lane_best : best;
          }
          out_h[(size_t)b * ct + c] = any ? 1 : 0;
          out_lb[(size_t)b * ct + c] = ptt_as_float(best);
        }
      }
    }
  }
}

// The per-ray schedule that ptt_binned_kernel had before its block schedule
// (ptt_host_binned_block): visit v's 256 pair rows against its tile, one
// thread a row, binned_pair.
void ptt_host_binned(const float* coef, const float* aabb, const float* center,
                     const float* const* ray, const uint8_t* live, const float* tlim,
                     const int32_t* vt, const int32_t* src, int32_t n, int32_t n_g, int32_t nv,
                     float baby_eps, float eps_succ, float* out_t, int32_t* out_tri) {
  const V3 c = v3(center[0], center[1], center[2]);
  for (int32_t v = 0; v < nv; ++v) {
    for (int32_t row = 0; row < PTT_RAY_TILE; ++row) {
      const int32_t out = v * PTT_RAY_TILE + row;
      out_t[out] = ptt_inf();
      out_tri[out] = -1;
      const int32_t tile = vt[v];
      if (tile < 0) continue;
      const int32_t p = src[v * (PTT_RAY_TILE / PTT_BINNED_G) + row / PTT_BINNED_G];
      const long long i = (long long)p * PTT_BINNED_G + row % PTT_BINNED_G;
      if (p >= n_g || i >= n) continue;
      binned_pair(coef, aabb + 8 * tile, tile, c, v3(ray[0][i], ray[1][i], ray[2][i]),
                  v3(ray[3][i], ray[4][i], ray[5][i]), live[i] != 0, tlim[i], baby_eps,
                  eps_succ, &out_t[out], &out_tri[out]);
    }
  }
}

// The packet bins kernels (csrc/mesh_bins.cu) in turn over n_grp groups of
// 256 rays (ray: recentred origins and directions): the mask kernel's warp
// ballots of plan_pair per tile (a warp of dead rays skips them) and its
// src fill; the column scan in segments of seg_groups groups (the kernel's
// PTT_BINS_SEG; the tests take smaller ones too, so that small cases span
// several segments); the offsets kernel (segment sums scanned, pad_cnt,
// cum_end, off, overflow, vt); the slots kernel, each packet's tiles in
// order.  dst: [n_g, min(topk, ct)] (unused for topk 0).
void ptt_host_packet_bins(const float* aabb, int32_t ct, const float* const* ray,
                          const uint8_t* live, const float* tlim, int32_t n_grp, int32_t budget,
                          int32_t topk, int32_t seg_groups, int32_t* src, int32_t* vt,
                          int32_t* dst, uint8_t* overflow) {
  const int32_t gpp = PTT_RAY_TILE / PTT_BINNED_G;  // packets a group
  const int32_t n_g = n_grp * gpp;
  std::vector<uint32_t> words((size_t)n_grp * ct, 0u);
  for (int32_t i = 0; i < budget; ++i) src[i] = n_g;
  for (int32_t g = 0; g < n_grp; ++g) {
    for (int w = 0; w < PTT_RAY_TILE / 32; ++w) {
      const int32_t i0 = g * PTT_RAY_TILE + 32 * w;
      bool any = false;
      for (int lane = 0; lane < 32; ++lane) any = any || live[i0 + lane] != 0;
      if (!any) continue;
      for (int32_t c = 0; c < ct; ++c) {
        uint32_t ballot = 0;
        for (int lane = 0; lane < 32; ++lane) {
          const int32_t i = i0 + lane;
          float key;
          if (plan_pair(aabb + 8 * c, v3(ray[0][i], ray[1][i], ray[2][i]),
                        inv_dir(v3(ray[3][i], ray[4][i], ray[5][i])), live[i] != 0, tlim[i],
                        &key)) {
            ballot |= 1u << lane;
          }
        }
        words[(size_t)g * ct + c] |= bins_nibble(ballot) << (4 * w);
      }
    }
  }
  const int32_t n_seg = (n_grp + seg_groups - 1) / seg_groups;
  std::vector<int32_t> rank((size_t)n_grp * ct), seg((size_t)n_seg * ct);
  for (int32_t s = 0; s < n_seg; ++s) {
    for (int32_t c = 0; c < ct; ++c) {
      int32_t run = 0;
      for (int32_t g = s * seg_groups; g < n_grp && g < (s + 1) * seg_groups; ++g) {
        rank[(size_t)g * ct + c] = run;
        run += ptt_popc(words[(size_t)g * ct + c]);
      }
      seg[(size_t)s * ct + c] = run;
    }
  }
  std::vector<int32_t> cum_end(ct);
  int32_t cum = 0;
  for (int32_t c = 0; c < ct; ++c) {
    int32_t n_c = 0;
    for (int32_t s = 0; s < n_seg; ++s) {
      const int32_t v = seg[(size_t)s * ct + c];
      seg[(size_t)s * ct + c] = n_c;
      n_c += v;
    }
    const int32_t pad = bins_pad(n_c);
    cum += pad;
    cum_end[c] = cum;
    for (int32_t s = 0; s < n_seg; ++s) seg[(size_t)s * ct + c] += cum - pad;
  }
  *overflow = cum_end[ct - 1] > budget ? 1 : 0;
  for (int32_t v = 0; v < budget / PTT_BINS_GP; ++v) vt[v] = bins_visit_tile(cum_end.data(), ct, v);
  const bool dense = topk >= ct;
  const int32_t cols = dense ? ct : topk;
  for (int32_t g = 0; g < n_grp; ++g) {
    for (int32_t j = 0; j < gpp; ++j) {
      const int32_t p = g * gpp + j;
      int32_t* row = dst + (size_t)p * cols;
      int32_t count = 0;
      for (int32_t c = 0; c < ct; ++c) {
        const size_t i = (size_t)g * ct + c;
        const bool hit = (words[i] >> j) & 1u;
        const int32_t pos = count;
        count += hit ? 1 : 0;
        const int32_t slot =
            hit ? bins_slot(words[i], seg[(size_t)(g / seg_groups) * ct + c] + rank[i], j)
                : PTT_INT_MAX;
        if (hit && bins_listed(pos, topk, ct) && slot < budget) src[slot] = p;
        if (topk > 0 && dense) {
          row[c] = slot;
        } else if (topk > 0 && hit && pos < topk) {
          row[pos] = slot;
        }
      }
      if (topk > 0 && !dense) {
        for (int32_t k = count; k < topk; ++k) row[k] = PTT_INT_MAX;
        if (count > topk) *overflow = 1;
      }
    }
  }
}

}  // extern "C"

