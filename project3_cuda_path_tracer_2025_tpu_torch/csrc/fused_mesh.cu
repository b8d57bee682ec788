// Hand-written Hopper (sm_90a) kernel of a mesh scene's bounce.
//
// ptt_mesh_shade_kernel replaces
//   project3_cuda_path_tracer_2025_tpu/ops/fused.py::_mesh_bounce_kernel
//   in its three modes (launched by _fused_mesh_shade): analytic-prim
//   intersect, merge with the mesh hit, BSDF scatter with inline Threefry,
//   and optionally the next bounce's prim t_limit (with the prim that gives
//   it) and coherence sort key, at any number of tiles.
//   Mode "plain" resolves each live lane's mesh surface itself from the
//   walk's (t, tri) and the tables' attrs_shade rows (mesh_surface: the
//   winner's (u, v), interpolated normal and material, which
//   ops/fused.py::resolve_mesh_surface computes in torch for the plain
//   version); mode "textured" takes the mesh lanes' albedo and final
//   shading normal (texture and bump resolved in torch before the launch);
//   mode "precomputed" takes every lane's resolved surface and skips the
//   prim intersection (a scene with a textured prim).
// ptt_mesh_prelude_kernel gives bounce 0 the same three planes from the
//   camera rays (ops/fused.py::mesh_prelude_plain: ops/intersect.py::prim_t_min
//   with its winner and ops/intersect_mxu.py::signature_key), so no
//   bounce builds its sort key or prim t_limit in torch.
// The bounce's traversal kernels (the mono walk of meshes of at most 8
// tiles among them) are in mesh_walk.cu.
//
// What bounds it on the H100: arithmetic, like the prim bounce kernel: ~80
// B per ray in and out (and in mode "plain" 76 B of a mesh-hit lane's
// attrs_shade row) against a few thousand flops (BSDF, 3 x 20 Threefry
// rounds, the prim tests and the key).  The JAX kernel's function tests
// every prim twice per ray and bounce: once for the ray it shades and once,
// with emit, for the ray it scatters -- the next bounce's t_limit.  The
// walk between two bounces leaves each ray's origin and direction as they
// are, so the first pass repeats the second one of the bounce before.  So
// the design carries the second pass's winner across the bounce (out_win
// here, prim_win in the next launch, permuted with the rays when they are
// sorted): a lane with a mesh hit tests no prim, and a lane without one
// tests its winner alone, which gives the same hit bit for bit.  What is
// left is one pass over the prims per ray with emit, the scatter and the
// key.  A launch given no winner tests every prim of the lanes without a
// mesh hit.  One thread a ray.
//
// The key reads the root box (root_box, 6 floats) and the tile boxes (32 B
// a tile: 6.3 KB at the 200k mesh's 196) from device memory, at any number
// of tiles: every thread of a warp reads the same word in the same
// iteration, which the L1 serves as one broadcast.  A ray that is not live
// takes no tile (coherence_key), and the rays of a sorted state sit with
// their kind, so the warps stay whole.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// -shared -Xcompiler -fPIC (ops/kernels.py).  Plain C interface, loaded with
// ctypes; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mesh_path.cuh"

#define PTT_THREADS 256

// The arguments of both kernels; the prelude reads the ray (in_f[0..5],
// in_bounces), the key's inputs and the outputs of emit.
struct PttMeshShadeArgs {
  const PttScene* scene;     // prims only
  const float* in_f[9];      // origin xyz, direction xyz, color rgb
  const int32_t* in_bounces;
  const int32_t* pixel;
  const float* mesh_t;
  const float* mesh_n[3];    // the resolved normal (mode >= 1)
  const int32_t* mesh_mat;   // the material, -1 = no mesh hit (mode >= 1)
  const float* mesh_alb[3];  // albedo rgb (mode >= 1)
  const int32_t* mesh_tri;   // the walk's winner, -1 = no mesh hit (mode 0)
  const float* attrs_shade;  // [padded_tris, PTT_SHADE_ROW] (mode 0)
  const int32_t* prim_win;   // the carried prim winner (-1 none); null: test every prim
  const float* tile_aabb;    // [ct, 8] (emit == 2)
  const float* center;       // [3] (emit == 2)
  const float* root_box;     // [8] the envelope of tile_aabb (emit == 2)
  float* out_f[9];
  int32_t* out_bounces;
  float* out_tlim;           // emit >= 1
  int32_t* out_key;          // emit == 2
  int32_t* out_win;          // emit >= 1, optional: the prim that gives out_tlim
  uint32_t k0, k1, rng_n;
  int32_t n, ct, emit;       // emit: 0 none, 1 t_lim, 2 t_lim + key
  int32_t mode;              // PTT_SHADE_PLAIN / _TEXTURED / _PRECOMPUTED
  int32_t num_geoms, num_materials;  // the scene's counts, for the launcher
  int32_t padded_tris;       // attrs_shade's rows (mode 0)
  float baby_eps;            // the resolve's |det| floor (mode 0)
};

extern __shared__ __align__(16) unsigned char ptt_smem[];

// The next bounce's planes of ray idx (origin o, direction d): its prim
// t_limit, the prim that gives it (out_win, optional) and with emit 2 its
// sort key.
__device__ __forceinline__ void emit_next(const PttMeshShadeArgs& a, const PttScene& s, int idx,
                                          V3 o, V3 d, bool alive) {
  int32_t win;
  const float tl = prim_t_min_win(s, o, d, &win);
  a.out_tlim[idx] = tl;
  if (a.out_win) a.out_win[idx] = win;
  if (a.emit == 2) {
    a.out_key[idx] = coherence_key(a.tile_aabb, a.ct, a.root_box,
                                   v3(a.center[0], a.center[1], a.center[2]), o, d, alive, tl);
  }
}

// Dynamic shared memory: the scene's tables (STAGE_SCENE), sized by the
// launcher from the scene; any number of primitives and materials.
template <bool STAGE_SCENE>
__global__ void __launch_bounds__(PTT_THREADS) ptt_mesh_shade_kernel(const PttMeshShadeArgs a) {
  const PttScene sh_scene = load_scene<STAGE_SCENE>(a.scene, ptt_smem);
  __syncthreads();
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= a.n) return;
  Ray ray;
  ray.o = v3(a.in_f[0][idx], a.in_f[1][idx], a.in_f[2][idx]);
  ray.d = v3(a.in_f[3][idx], a.in_f[4][idx], a.in_f[5][idx]);
  ray.c = v3(a.in_f[6][idx], a.in_f[7][idx], a.in_f[8][idx]);
  ray.bounces = a.in_bounces[idx];
  V3 mn = v3(0.0f, 0.0f, 0.0f), alb = mn;
  int32_t mmat = -1;
  if (a.mode != PTT_SHADE_PLAIN) {
    mn = v3(a.mesh_n[0][idx], a.mesh_n[1][idx], a.mesh_n[2][idx]);
    mmat = a.mesh_mat[idx];
    alb = v3(a.mesh_alb[0][idx], a.mesh_alb[1][idx], a.mesh_alb[2][idx]);
  } else if (ray.bounces > 0) {  // a dead lane is left untouched: no row read
    mmat = mesh_surface(a.attrs_shade, a.padded_tris, a.mesh_tri[idx], ray.o, ray.d, a.baby_eps,
                        &mn);
  }
  mesh_shade_ray(sh_scene, ray, a.mesh_t[idx], mn, mmat, a.mode, alb, a.k0, a.k1, a.rng_n,
                 a.pixel[idx], a.prim_win ? a.prim_win[idx] : PTT_NO_WINNER);
  a.out_f[0][idx] = ray.o.x;
  a.out_f[1][idx] = ray.o.y;
  a.out_f[2][idx] = ray.o.z;
  a.out_f[3][idx] = ray.d.x;
  a.out_f[4][idx] = ray.d.y;
  a.out_f[5][idx] = ray.d.z;
  a.out_f[6][idx] = ray.c.x;
  a.out_f[7][idx] = ray.c.y;
  a.out_f[8][idx] = ray.c.z;
  a.out_bounces[idx] = ray.bounces;
  if (a.emit >= 1) {
    emit_next(a, sh_scene, idx, ray.o, ray.d, ray.bounces > 0);
  }
}

// Bounce 0's emit from the camera rays, as #3 emits it for the bounces
// after it: the rays themselves are not written.
template <bool STAGE_SCENE>
__global__ void __launch_bounds__(PTT_THREADS) ptt_mesh_prelude_kernel(const PttMeshShadeArgs a) {
  const PttScene sh_scene = load_scene<STAGE_SCENE>(a.scene, ptt_smem);
  __syncthreads();
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= a.n) return;
  emit_next(a, sh_scene, idx, v3(a.in_f[0][idx], a.in_f[1][idx], a.in_f[2][idx]),
            v3(a.in_f[3][idx], a.in_f[4][idx], a.in_f[5][idx]), a.in_bounces[idx] > 0);
}

static unsigned blocks_for(long long n) {
  return (unsigned)((n + PTT_THREADS - 1) / PTT_THREADS);
}

template <bool STAGE_SCENE>
static cudaError_t launch_mesh(bool prelude, const PttMeshShadeArgs* a, size_t smem,
                               cudaStream_t st) {
  void (*kernel)(const PttMeshShadeArgs) =
      prelude ? ptt_mesh_prelude_kernel<STAGE_SCENE> : ptt_mesh_shade_kernel<STAGE_SCENE>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks_for(a->n), PTT_THREADS, smem, st>>>(*a);
  return cudaGetLastError();
}

// Either kernel over a->n rays, with the scene's tables in shared memory
// where they fit.
static int launch_either(bool prelude, const PttMeshShadeArgs* a, void* stream) {
  if (a->emit == 2 &&
      (a->ct < 1 || a->tile_aabb == nullptr || a->center == nullptr || a->root_box == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (a->num_geoms < 0 || a->num_materials < 0) return (int)cudaErrorInvalidValue;
  if (a->n <= 0) return (int)cudaGetLastError();
  const size_t tables = scene_table_bytes(a->num_geoms, a->num_materials);
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = tables <= PTT_SMEM_LIMIT ? launch_mesh<true>(prelude, a, tables, st)
                                                   : launch_mesh<false>(prelude, a, 0, st);
  return (int)err;
}

extern "C" {

// Struct sizes and offsets, checked against the ctypes mirror at load time.
int ptt_mesh_abi(int32_t* out, int32_t len) {
  const int32_t v[] = {
      (int32_t)sizeof(PttScene),
      (int32_t)sizeof(PttMeshShadeArgs),
      (int32_t)offsetof(PttMeshShadeArgs, mesh_tri),
      (int32_t)offsetof(PttMeshShadeArgs, prim_win),
      (int32_t)offsetof(PttMeshShadeArgs, root_box),
      (int32_t)offsetof(PttMeshShadeArgs, out_win),
      (int32_t)offsetof(PttMeshShadeArgs, k0),
      (int32_t)offsetof(PttMeshShadeArgs, n),
      (int32_t)offsetof(PttMeshShadeArgs, mode),
      (int32_t)offsetof(PttMeshShadeArgs, num_geoms),
      (int32_t)offsetof(PttMeshShadeArgs, baby_eps),
      (int32_t)sizeof(PttGeom),
      (int32_t)sizeof(PttMaterial),
      (int32_t)offsetof(PttScene, geoms),
      PTT_TRI_TILE,
      PTT_COEF_W,
      PTT_SHADE_ROW,
  };
  const int32_t count = (int32_t)(sizeof(v) / sizeof(v[0]));
  for (int32_t i = 0; i < count && i < len; ++i) out[i] = v[i];
  return count;
}

int ptt_launch_mesh_shade(const PttMeshShadeArgs* a, void* stream) {
  if (a->mode < PTT_SHADE_PLAIN || a->mode > PTT_SHADE_PRECOMPUTED) {
    return (int)cudaErrorInvalidValue;
  }
  if (a->mode == PTT_SHADE_PLAIN &&
      (a->mesh_tri == nullptr || a->attrs_shade == nullptr || a->padded_tris < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_either(false, a, stream);
}

// Bounce 0's t_lim (out_tlim), winner (out_win, optional) and with emit 2
// key (out_key) of the rays in_f[0..5] / in_bounces.
int ptt_launch_mesh_prelude(const PttMeshShadeArgs* a, void* stream) {
  if (a->emit < 1 || a->out_tlim == nullptr) return (int)cudaErrorInvalidValue;
  return launch_either(true, a, stream);
}

const char* ptt_mesh_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
