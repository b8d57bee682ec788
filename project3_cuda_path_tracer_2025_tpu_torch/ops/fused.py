"""Fused bounce and iteration kernels.

The JAX package fuses a prim-only, untextured scene's bounce (and, on the
main path, its whole spp iteration) into Pallas kernels
(``project3_cuda_path_tracer_2025_tpu/ops/fused.py``): ``_bounce_kernel``
via ``fused_prim_bounce`` and ``_iteration_kernel`` via
``fused_prim_iteration``.  A mesh scene's bounce runs the mesh traversal
(``ops.intersect_mxu``) and then ``_mesh_bounce_kernel`` via
``_fused_mesh_shade``: prim intersect, merge with the mesh hit, BSDF
scatter, inline RNG and the next bounce's prune and sort key.  A textured
mesh resolves its albedo and bump normal in the surface stage (torch, as
XLA in the JAX package) and shades in mode "textured"; a scene with a
textured prim resolves the whole surface there and shades in mode
"precomputed" (``fused_tex_bounce``).  Here all three are hand-written CUDA
kernels (``csrc/fused_prim.cu``, ``csrc/fused_mesh.cu``), each behind a
wrapper with:

* a plain PyTorch version (``*_plain``) of the same function, built from the
  same building blocks as the unfused path (``intersect_scene``, the
  constant material select chain, ``shade.scatter_compose``);
* a launch count (``wrapper.launches``), which grows by one per kernel
  launch and nowhere else.

Given CUDA tensors a wrapper launches its kernel or raises; given CPU
tensors it runs its plain version.  There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..config import RenderConfig
from ..scene.camera import CameraState
from ..scene.device import SceneStatic
from ..scene.types import GeomType
from ..utils import prng
from ..utils import vec
from ..utils.timers import span
from ..utils.vec import Vec3, f32
from . import camera as camera_ops
from . import film as film_ops
from . import intersect_mxu, kernels
from . import shade as shade_ops
from .compaction import front_pack_permutation, permute_path_state
from .intersect import FLT_MAX, intersect_scene, intersect_winner, prim_t_min, ray_sorting_on
from .rays import Intersections, PathState


def fused_applicable(static: SceneStatic, cfg: RenderConfig) -> bool:
    return (
        not static.has_triangles
        and static.num_textures == 0
        and cfg.shader == "full"
    )


def camera_statics(cam_state: CameraState) -> tuple:
    """CameraState -> the 16 float32 values the kernels take, in the JAX
    package's order (there they are baked into the kernel; here they are a
    runtime argument)."""
    c = camera_ops.camera_floats(cam_state)
    return (
        *c["position"], *c["view"], *c["up"], *c["right"],
        *c["pixel_length"], c["aperture"], c["focal_dist"],
    )


def camera_struct(cam_state: CameraState) -> kernels.PttCamera:
    """The camera as the kernels' ``PttCamera`` struct."""
    c = camera_statics(cam_state)
    pc = kernels.PttCamera()
    pc.position[:] = c[0:3]
    pc.view[:] = c[3:6]
    pc.up[:] = c[6:9]
    pc.right[:] = c[9:12]
    pc.pixel_length[:] = c[12:14]
    pc.aperture, pc.focal_dist = c[14], c[15]
    return pc


def _const_material_params(static: SceneStatic, mid: torch.Tensor):
    """Per-lane material parameters via a constant select chain."""
    ms = static.material_consts

    def chain(get):
        out = torch.full(mid.shape, f32(get(ms[0])), dtype=torch.float32,
                         device=mid.device)
        for i in range(1, len(ms)):
            out = torch.where(mid == i, f32(get(ms[i])), out)
        return out

    albedo = Vec3(
        chain(lambda m: m.color[0]),
        chain(lambda m: m.color[1]),
        chain(lambda m: m.color[2]),
    )
    return (
        albedo,
        chain(lambda m: m.emittance),
        chain(lambda m: m.has_reflective),
        chain(lambda m: m.has_refractive),
        chain(lambda m: m.ior),
        chain(lambda m: m.roughness),
        chain(lambda m: m.metallic),
    )


def _prim_bounce(static: SceneStatic, cfg: RenderConfig, paths: PathState,
                 uniforms) -> PathState:
    """One bounce: the body both kernels run per ray, as tensor ops."""
    isect = intersect_scene(None, static, paths, cfg)
    mid = torch.clamp(isect.material_id, 0, static.num_materials - 1)
    albedo, emitt, refl, refr, ior, rough, metal = _const_material_params(
        static, mid
    )
    return shade_ops.scatter_compose(
        cfg, paths, isect, isect.normal,
        albedo, emitt, refl, refr, ior, rough, metal,
        (uniforms[0], uniforms[1], uniforms[2]),
        lobes=shade_ops.lobes_present(static),
    )


# ---------------------------------------------------------------------------
# Scene struct for the kernels
# ---------------------------------------------------------------------------

def _rows12(m) -> list:
    return [f32(m[r][c]) for r in range(3) for c in range(4)]


def scene_struct(static: SceneStatic, cfg: RenderConfig) -> kernels.PttScene:
    """The scene constants as the kernels' ``PttScene`` header with its two
    tables in host memory (what the host build of the per-ray body reads).
    The returned struct keeps the tables alive."""
    s, geoms, mats = _scene_tables(static, _eps(cfg))
    s.geoms = ctypes.addressof(geoms)
    s.materials = ctypes.addressof(mats)
    s._tables = (geoms, mats)
    return s


@functools.lru_cache(maxsize=8)
def _scene_buffer(static: SceneStatic, eps: tuple, device: torch.device) -> torch.Tensor:
    """The scene on the device, uploaded once per (scene, device): one
    buffer holding the ``PttScene`` header, then the primitive table, then
    the material table, the header's pointers aimed at the buffer's own
    tables.  The cache holds the tensor, so the addresses live as long as
    the entry; a scene of any number of primitives and materials fits."""
    s, geoms, mats = _scene_tables(static, eps)
    off_g = (ctypes.sizeof(s) + 15) // 16 * 16
    off_m = off_g + (ctypes.sizeof(geoms) + 15) // 16 * 16
    buf = torch.empty((off_m + max(ctypes.sizeof(mats), 1),), dtype=torch.uint8, device=device)
    s.geoms = buf.data_ptr() + off_g
    s.materials = buf.data_ptr() + off_m
    blob = np.zeros((buf.shape[0],), np.uint8)
    for off, part in ((0, s), (off_g, geoms), (off_m, mats)):
        raw = np.frombuffer(bytes(part), dtype=np.uint8)
        blob[off:off + raw.shape[0]] = raw
    buf.copy_(torch.from_numpy(blob))
    return buf


def _scene_tables(static: SceneStatic, eps: tuple):
    """(header without pointers, PttGeom array, PttMaterial array)."""
    s = kernels.PttScene()
    s.num_geoms = len(static.geoms)
    s.num_materials = static.num_materials
    (s.lobe_glass, s.lobe_mirror, s.lobe_trans, s.lobe_micro) = (
        int(b) for b in shade_ops.lobes_present(static)
    )
    s.baby_eps, s.larger_eps, s.ray_eps = (f32(e) for e in eps)
    geoms = (kernels.PttGeom * len(static.geoms))()
    for i, g in enumerate(static.geoms):
        geoms[i].type = 1 if g.gtype == int(GeomType.CUBE) else 0
        geoms[i].material_id = g.material_id
        geoms[i].inverse[:] = _rows12(g.inverse)
        geoms[i].transform[:] = _rows12(g.transform)
        geoms[i].inv_transpose[:] = _rows12(g.inv_transpose)
    mats = (kernels.PttMaterial * len(static.material_consts))()
    for i, m in enumerate(static.material_consts):
        mat = mats[i]
        mat.color[:] = [f32(c) for c in m.color]
        mat.emittance = m.emittance
        mat.has_reflective = m.has_reflective
        mat.has_refractive = m.has_refractive
        mat.ior = m.ior
        mat.roughness = m.roughness
        mat.metallic = m.metallic
    return s, geoms, mats


def _scene_counts(static: SceneStatic) -> tuple:
    """(primitives, materials): the launchers size shared memory from them."""
    return len(static.geoms), len(static.material_consts)


def _eps(cfg: RenderConfig) -> tuple:
    return (cfg.baby_epsilon, cfg.larger_epsilon, cfg.ray_advance_epsilon)


def _check_planes(what: str, tensors, n: int, dtype, device) -> None:
    for t in tensors:
        if t.device != device or t.dtype != dtype or t.shape != (n,) or not t.is_contiguous():
            raise ValueError(
                f"{what}: expected contiguous {dtype} [{n}] on {device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )


def _require_cuda(device: torch.device, what: str) -> None:
    if device.type != "cuda":
        raise ValueError(
            f"{what}: the kernel takes CUDA tensors (a wrapper runs its plain "
            f"version on CPU tensors), got {device}"
        )


# ---------------------------------------------------------------------------
# fused_prim_bounce  (replaces ops/fused.py::_bounce_kernel)
# ---------------------------------------------------------------------------

def _bounce_uniforms(paths: PathState, uniforms, su_key, rng_n):
    """Check the bounce's uniform form: exactly one of ``uniforms`` ([3, n])
    and ``su_key``; returns ``rng_n`` (the pixel count ``n`` by default)."""
    if (uniforms is None) == (su_key is None):
        raise ValueError("fused_prim_bounce: give exactly one of uniforms and su_key")
    if su_key is None:
        return None
    rng_n = rng_n or paths.pixel.shape[0]
    if rng_n * 3 >= 2**32:
        raise ValueError(f"3 x {rng_n} uniforms exceed the 32-bit counter")
    return rng_n


def fused_prim_bounce_plain(
    static: SceneStatic, cfg: RenderConfig, paths: PathState,
    uniforms: torch.Tensor = None, *, su_key: tuple = None, rng_n: int = None,
) -> PathState:
    """The plain PyTorch version of the bounce kernel (its arguments)."""
    rng_n = _bounce_uniforms(paths, uniforms, su_key, rng_n)
    if su_key is not None:
        uniforms = prng.uniforms_at(su_key, paths.pixel, 3, rng_n)
    return _prim_bounce(static, cfg, paths, uniforms)


_CHUNK_COUNTERS = {}


def _chunk_counter(device: torch.device, stream: int) -> torch.Tensor:
    """The bounce kernel's chunk counter for the launches on ``stream`` of
    ``device``: zeroed once, on that stream; each launch's last warp zeroes
    it again for the next.  One counter a stream, because the launches of
    one stream run one after another and those of two streams may overlap."""
    key = (device, stream)
    if key not in _CHUNK_COUNTERS:
        _CHUNK_COUNTERS[key] = torch.zeros((2,), dtype=torch.int32, device=device)
    return _CHUNK_COUNTERS[key]


def fused_prim_bounce(
    static: SceneStatic,
    cfg: RenderConfig,
    paths: PathState,
    uniforms: torch.Tensor = None,  # [3, N]
    *,
    su_key: tuple = None,  # the bounce's shade key: uniforms drawn inline
    rng_n: int = None,  # RNG stream length (default N)
) -> PathState:
    """One bounce of intersect + shade for a prim-only, untextured scene.

    The uniforms come as ``uniforms`` [3, N] (the JAX package's signature)
    or, with ``su_key``, are drawn in the kernel: ray i draws
    ``uniform_at(su_key, j * rng_n + paths.pixel[i])`` for j = 0, 1, 2
    (``prng.uniforms_at(su_key, paths.pixel, 3, rng_n)``, the JAX
    ``megakernel_iteration``'s ``draw3`` unsharded and sharded), and only
    when it is live.  Exactly one of the two is given."""
    rng_n = _bounce_uniforms(paths, uniforms, su_key, rng_n)
    device = paths.origin.x.device
    if device.type == "cpu":
        return fused_prim_bounce_plain(static, cfg, paths, uniforms, su_key=su_key, rng_n=rng_n)
    _require_cuda(device, "fused_prim_bounce")
    n = paths.pixel.shape[0]
    f_in = (*paths.origin, *paths.direction, *paths.color)
    _check_planes("fused_prim_bounce paths", f_in, n, torch.float32, device)
    _check_planes("fused_prim_bounce bounces", (paths.bounces,), n, torch.int32, device)
    if su_key is not None:
        _check_planes("fused_prim_bounce pixel", (paths.pixel,), n, torch.int32, device)
    elif uniforms.shape != (3, n) or uniforms.dtype != torch.float32 \
            or uniforms.device != device or not uniforms.is_contiguous():
        raise ValueError(
            f"fused_prim_bounce uniforms: expected contiguous float32 [3, {n}] "
            f"on {device}, got {uniforms.dtype} {tuple(uniforms.shape)} on "
            f"{uniforms.device}"
        )
    lib = kernels.load()
    scene = _scene_buffer(static, _eps(cfg), device)
    f_out = [torch.empty_like(t) for t in f_in]
    b_out = torch.empty_like(paths.bounces)
    a = kernels.PttBounceArgs()
    a.scene = scene.data_ptr()
    a.in_f[:] = [t.data_ptr() for t in f_in]
    a.in_bounces = paths.bounces.data_ptr()
    if su_key is None:
        a.u = uniforms.data_ptr()
    else:
        a.pixel = paths.pixel.data_ptr()
        a.k0, a.k1 = su_key
        a.rng_n = rng_n
    stream = kernels.stream_handle(device)
    a.chunks = _chunk_counter(device, stream).data_ptr()
    a.out_f[:] = [t.data_ptr() for t in f_out]
    a.out_bounces = b_out.data_ptr()
    a.n = n
    a.num_geoms, a.num_materials = _scene_counts(static)
    code = lib.lib.ptt_launch_bounce(ctypes.byref(a), stream)
    lib.check(code, "fused_prim_bounce")
    fused_prim_bounce.launches += 1
    return PathState(
        origin=Vec3(*f_out[0:3]),
        direction=Vec3(*f_out[3:6]),
        color=Vec3(*f_out[6:9]),
        pixel=paths.pixel,
        bounces=b_out,
    )


fused_prim_bounce.launches = 0


# ---------------------------------------------------------------------------
# fused_prim_iteration  (replaces ops/fused.py::_iteration_kernel)
# ---------------------------------------------------------------------------

def iteration_keys(static: SceneStatic, iteration: int, base_key: tuple):
    ik = prng.iteration_key(base_key, iteration)
    cam_key = prng.stage_key(ik, 0, 0)
    shade_keys = [prng.stage_key(ik, d, 1) for d in range(static.trace_depth)]
    return cam_key, shade_keys


def kernel_key_words(iteration: int, base_key: tuple) -> tuple:
    """What the iteration kernel takes by value: (camera key, iteration
    key); it derives the shade key of each depth from the latter."""
    ik = prng.iteration_key(base_key, iteration)
    return prng.stage_key(ik, 0, 0), ik


def fused_prim_iteration_plain(
    static: SceneStatic, cfg: RenderConfig, cam: CameraState, film: Vec3,
    iteration: int, base_key: tuple,
):
    """The plain PyTorch version of the iteration kernel: raygen, depth x
    bounce, film += color (in place).  Returns (film, alive_counts[depth])."""
    n, depth = static.pixel_count, static.trace_depth
    device = film.x.device
    idx = torch.arange(n, dtype=torch.int32, device=device)
    cam_key, shade_keys = iteration_keys(static, iteration, base_key)
    paths = camera_ops.generate_camera_rays(
        cam, static.width, static.height, depth,
        prng.uniforms_at(cam_key, idx, 4, n), idx=idx,
    )
    counts = []
    for d in range(depth):
        paths = _prim_bounce(
            static, cfg, paths, prng.uniforms_at(shade_keys[d], idx, 3, n)
        )
        counts.append(torch.sum(paths.alive.to(torch.int32)))
    film_ops.accumulate(film, paths)
    return film, torch.stack(counts).to(torch.int32)


def fused_prim_iteration(
    static: SceneStatic,
    cfg: RenderConfig,
    cam: CameraState,
    film: Vec3,  # [N] float32 each; updated in place
    iteration: int,
    base_key: tuple,
):
    """One full spp iteration in a single kernel.

    The uniforms are drawn inside the kernel, which derives each depth's
    stage key from the iteration key (the same ``(iteration, depth, stage)``
    streams as ``megakernel_iteration``), and the camera is an argument, so
    an orbit rebuilds nothing.  The film is updated in place (the JAX package donates
    it).  The kernel hands pixels to free lanes as paths end (its schedule,
    ``csrc/fused_prim.cu``), tracing each pixel's path as the plain version
    does.  Returns (film, alive_counts[depth])."""
    device = film.x.device
    if device.type == "cpu":
        return fused_prim_iteration_plain(static, cfg, cam, film, iteration, base_key)
    _require_cuda(device, "fused_prim_iteration")
    n, depth = static.pixel_count, static.trace_depth
    _check_planes("fused_prim_iteration film", film, n, torch.float32, device)
    lib = kernels.load()
    scene = _scene_buffer(static, _eps(cfg), device)
    # One zeroed buffer: the alive counts [depth], the kernel's pixel
    # counter [1] and room for the shade keys [2 * depth] should they
    # exceed shared memory.
    scratch = torch.zeros((3 * depth + 1,), dtype=torch.int32, device=device)
    alive = scratch[:depth]

    a = kernels.PttIterArgs()
    a.scene = scene.data_ptr()
    a.film_x, a.film_y, a.film_z = (t.data_ptr() for t in film)
    a.alive = alive.data_ptr()
    a.next_pixel = scratch[depth:].data_ptr()
    a.keys = scratch[depth + 1:].data_ptr()
    a.cam = camera_struct(cam)
    a.width, a.height, a.n, a.depth = static.width, static.height, n, depth
    a.num_geoms, a.num_materials = _scene_counts(static)
    # The keys travel by value: the camera's, and the iteration's, from which
    # the kernel derives the shade key of each depth (any depth).
    cam_key, ik = kernel_key_words(iteration, base_key)
    a.cam_key[:] = cam_key
    a.iter_key[:] = ik
    code = lib.lib.ptt_launch_iteration(ctypes.byref(a), kernels.stream_handle(device))
    lib.check(code, "fused_prim_iteration")
    fused_prim_iteration.launches += 1
    return film, alive


fused_prim_iteration.launches = 0


# ---------------------------------------------------------------------------
# Threefry uniforms on the card (utils/prng.py::uniforms on a CUDA device)
# ---------------------------------------------------------------------------

def kernel_uniforms(key: tuple, n: int, k: int, device, base: int = 0,
                    rng_n: int = None) -> torch.Tensor:
    """``prng.uniforms(key, n, k, base=base, rng_n=rng_n)`` drawn by the
    in-kernel Threefry: the columns ``[base, base + n)`` of the ``[k, rng_n]``
    rows (``rng_n`` defaults to ``n``), bit-identical to the plain version
    ``prng.uniforms_at(key, base + arange(n), k, rng_n)``."""
    device = torch.device(device)
    _require_cuda(device, "kernel_uniforms")
    rng_n = n if rng_n is None else rng_n
    if not 0 <= base <= rng_n - n:
        raise ValueError(f"kernel_uniforms: pixels [{base}, {base + n}) outside a "
                         f"stream of {rng_n}")
    if rng_n * k >= 2**32:
        raise ValueError(f"{k} x {rng_n} uniforms exceed the 32-bit counter")
    out = torch.empty((k, n), dtype=torch.float32, device=device)
    lib = kernels.load()
    code = lib.lib.ptt_launch_uniforms(
        key[0], key[1], n, k, base, rng_n, out.data_ptr(), kernels.stream_handle(device)
    )
    lib.check(code, "kernel_uniforms")
    kernel_uniforms.launches += 1
    return out


kernel_uniforms.launches = 0


# ---------------------------------------------------------------------------
# Fused mesh bounce  (the shade kernel replaces ops/fused.py::_mesh_bounce_kernel,
# modes "plain", "textured" and "precomputed"; the traversals are in
# ops.intersect_mxu)
# ---------------------------------------------------------------------------

EMIT_MODES = ("", "tlim", "tlim+key")
SHADE_MODES = ("plain", "textured", "precomputed")


def fused_mesh_applicable(static: SceneStatic, cfg: RenderConfig) -> bool:
    """A mesh scene takes the fused mesh bounce when it runs the MXU
    tables' traversal.  Textures on mesh materials resolve in the surface
    stage (``textured_mesh_surface``); a textured or bump-mapped prim takes
    ``fused_tex_bounce`` instead."""
    return (
        static.has_triangles
        and not (static.num_textures > 0 and static.prim_textured)
        and cfg.shader == "full"
        and cfg.bvh_acceleration
        and cfg.mesh_intersector in ("auto", "mxu")
    )


def _check_mode(mode: str, emit: str, mesh_albedo, prim_winner=None,
                want_winner: bool = False) -> None:
    if mode not in SHADE_MODES:
        raise ValueError(f"mode={mode!r}: use one of {SHADE_MODES}")
    if (mode == "plain") != (mesh_albedo is None):
        raise ValueError(f"mode={mode!r}: mesh_albedo is required in the textured and "
                         "precomputed modes and only there")
    if emit not in EMIT_MODES:
        raise ValueError(f"emit={emit!r}: use one of {EMIT_MODES}")
    if prim_winner is not None and mode == "precomputed":
        raise ValueError("mode='precomputed' tests no prim: it takes no prim_winner")
    if want_winner and not emit:
        raise ValueError("want_winner needs emit: the winner is the emitted t_limit's prim")


def fused_mesh_shade_plain(
    prim_static: SceneStatic,
    cfg: RenderConfig,
    paths: PathState,
    mesh_t: torch.Tensor,
    mesh_normal: Vec3,
    mesh_mat: torch.Tensor,
    su_key: tuple,
    rng_n: int,
    emit: str = "",
    tile_aabb: torch.Tensor = None,
    center: torch.Tensor = None,
    mode: str = "plain",
    mesh_albedo: Vec3 = None,
    prim_winner: torch.Tensor = None,
    want_winner: bool = False,
):
    """The plain PyTorch version of the mesh-shade kernel (see
    ``fused_mesh_shade``).  It uses ``prim_winner`` as the kernel does: the
    prim hit of every lane comes from its winner's test alone
    (``intersect_winner``), which gives the same outputs bit for bit as
    testing every prim (``intersect_scene``) does without it."""
    _check_mode(mode, emit, mesh_albedo, prim_winner, want_winner)
    uni = prng.uniforms_at(su_key, paths.pixel, 3, rng_n)
    if mode == "precomputed":
        # The whole surface arrives resolved: (t, shading normal, material,
        # albedo) of every lane; no prim intersection here.
        zero = torch.zeros_like(mesh_t)
        t, normal, mat = mesh_t, mesh_normal, mesh_mat
        isect = Intersections(t=t, normal=normal, material_id=mat, uv_u=zero, uv_v=zero,
                              dpdu=Vec3(zero, zero, zero), dpdv=Vec3(zero, zero, zero),
                              is_triangle=zero > 0.0)
    else:
        isect_p = (intersect_scene(None, prim_static, paths, cfg) if prim_winner is None
                   else intersect_winner(prim_static, paths, cfg, prim_winner))
        # The traversal ran with the prim nearest t as its t_limit, so a mesh
        # hit is closer than every prim (an exact tie stays with the prim).
        tri_hit = mesh_mat >= 0
        mn = mesh_normal
        if mode == "plain":
            # "textured" passes the final shading normal, already oriented
            # and bump-perturbed in the surface stage.
            flip = vec.dot(paths.direction, mesh_normal) > 0.0
            mn = vec.where(flip, -mesh_normal, mesh_normal)
        t = torch.where(tri_hit, mesh_t, isect_p.t)
        normal = vec.where(tri_hit, mn, isect_p.normal)
        mat = torch.where(tri_hit, mesh_mat, isect_p.material_id)
        isect = isect_p._replace(t=t, normal=normal, material_id=mat)
    mid = torch.clamp(mat, 0, prim_static.num_materials - 1)
    albedo, emitt, refl, refr, ior, rough, metal = _const_material_params(
        prim_static, mid
    )
    if mode == "textured":
        # Mesh lanes take the surface stage's albedo; prim lanes keep the
        # constant chain's (no prim material is textured on this path).
        albedo = vec.where(tri_hit, mesh_albedo, albedo)
    elif mode == "precomputed":
        albedo = mesh_albedo
    out = shade_ops.scatter_compose(
        cfg, paths, isect, normal,
        albedo, emitt, refl, refr, ior, rough, metal,
        (uni[0], uni[1], uni[2]),
        lobes=shade_ops.lobes_present(prim_static),
    )
    if not emit:
        return out
    tl_n, win_n = prim_t_min(prim_static, cfg, out.origin, out.direction, winner=True)
    key_n = None
    if emit == "tlim+key":
        key_n = intersect_mxu.coherence_key_planes(
            tile_aabb, center[0], center[1], center[2],
            *out.origin, *out.direction, out.bounces > 0, tl_n,
        )
    return out, ((tl_n, key_n, win_n) if want_winner else (tl_n, key_n))


def fused_mesh_shade(
    prim_static: SceneStatic,
    cfg: RenderConfig,
    paths: PathState,
    mesh_t: torch.Tensor,  # [N] f32, the traversal's t
    mesh_normal: Vec3,  # [N] f32 each, interpolated (zero where no mesh hit)
    mesh_mat: torch.Tensor,  # [N] i32, -1 = no mesh hit
    su_key: tuple,  # the bounce's shade key: uniforms drawn inline
    rng_n: int,  # RNG stream length (the pixel count)
    emit: str = "",  # "" | "tlim" | "tlim+key": next-bounce outputs
    tile_aabb: torch.Tensor = None,  # [ct, 8] recentred (emit == "tlim+key")
    center: torch.Tensor = None,  # [3] (emit == "tlim+key")
    mode: str = "plain",  # "plain" | "textured" | "precomputed"
    mesh_albedo: Vec3 = None,  # [N] f32 each, textured/precomputed only
    prim_winner: torch.Tensor = None,  # [N] i32, the carried winner (plain/textured)
    want_winner: bool = False,  # with emit: also return the emitted t_lim's prim
):
    """Prim intersect + merge with the mesh hit + BSDF scatter of one
    bounce, with the uniforms drawn inline at ``(su_key, j*rng_n + pixel)``
    (a slot's stream follows its pixel, so a permuted state draws the same
    numbers).  ``prim_static`` is the scene's static with
    ``num_triangles=0``.  With ``emit`` it also returns the scattered rays'
    prim nearest t (the next bounce's t_limit) and, for "tlim+key", their
    coherence sort key: ``(paths, (t_lim, key | None))``.

    ``mode`` "plain": ``mesh_normal`` is the interpolated normal, flipped
    toward the ray here.  "textured": it is the final shading normal (not
    flipped), and mesh lanes take ``mesh_albedo``.  "precomputed": no prim
    intersection; ``(mesh_t, mesh_normal, mesh_mat, mesh_albedo)`` is every
    lane's resolved surface (``fused_tex_bounce``).

    The prim winner: with ``want_winner`` the emitted tuple is ``(t_lim,
    key | None, win)``, ``win`` [N] int32 the prim that gives ``t_lim``
    (``prim_t_min(..., winner=True)``; -1: none).  Given back as
    ``prim_winner`` on the next bounce (permuted with the rays), it spares
    that shade every prim test but the winner's, with the same outputs bit
    for bit; a lane with a mesh hit tests no prim either way."""
    _check_mode(mode, emit, mesh_albedo, prim_winner, want_winner)
    device = paths.origin.x.device
    if device.type == "cpu":
        return fused_mesh_shade_plain(
            prim_static, cfg, paths, mesh_t, mesh_normal, mesh_mat, su_key,
            rng_n, emit, tile_aabb, center, mode, mesh_albedo, prim_winner, want_winner,
        )
    _require_cuda(device, "fused_mesh_shade")
    n = paths.pixel.shape[0]
    f_in = (*paths.origin, *paths.direction, *paths.color)
    _check_planes("fused_mesh_shade paths", (*f_in, mesh_t, *mesh_normal), n,
                  torch.float32, device)
    ints = (paths.bounces, paths.pixel, mesh_mat)
    _check_planes("fused_mesh_shade ints",
                  ints if prim_winner is None else (*ints, prim_winner), n, torch.int32, device)
    if mode != "plain":
        mesh_albedo = Vec3(*(c.contiguous() for c in mesh_albedo))
        _check_planes("fused_mesh_shade albedo", mesh_albedo, n, torch.float32, device)
    if rng_n * 3 >= 2**32:
        raise ValueError(f"3 x {rng_n} uniforms exceed the 32-bit counter")
    ct = 0
    if emit == "tlim+key":
        ct = tile_aabb.shape[0]
        if tile_aabb.shape != (ct, 8) or tile_aabb.dtype != torch.float32 \
                or tile_aabb.device != device or not tile_aabb.is_contiguous() \
                or center.shape != (3,) or center.device != device \
                or center.dtype != torch.float32:
            raise ValueError("fused_mesh_shade: tile_aabb [ct, 8] and center [3] "
                             f"float32 on {device} are required for the key")
    lib = kernels.load("fused_mesh")
    scene = _scene_buffer(prim_static, _eps(cfg), device)
    f_out = [torch.empty_like(t) for t in f_in]
    b_out = torch.empty_like(paths.bounces)
    tl_out = torch.empty_like(mesh_t) if emit else None
    key_out = torch.empty_like(mesh_mat) if emit == "tlim+key" else None
    win_out = torch.empty_like(mesh_mat) if want_winner else None
    a = kernels.PttMeshShadeArgs()
    a.scene = scene.data_ptr()
    a.in_f[:] = [t.data_ptr() for t in f_in]
    a.in_bounces = paths.bounces.data_ptr()
    a.pixel = paths.pixel.data_ptr()
    a.mesh_t = mesh_t.data_ptr()
    a.mesh_n[:] = [t.data_ptr() for t in mesh_normal]
    a.mesh_mat = mesh_mat.data_ptr()
    if mode != "plain":
        a.mesh_alb[:] = [t.data_ptr() for t in mesh_albedo]
    if prim_winner is not None:
        a.prim_win = prim_winner.data_ptr()
    if win_out is not None:
        a.out_win = win_out.data_ptr()
    a.out_f[:] = [t.data_ptr() for t in f_out]
    a.out_bounces = b_out.data_ptr()
    if emit:
        a.out_tlim = tl_out.data_ptr()
    if key_out is not None:
        a.out_key = key_out.data_ptr()
        a.tile_aabb = tile_aabb.data_ptr()
        a.center = center.data_ptr()
    a.k0, a.k1 = su_key
    a.rng_n = rng_n
    a.n, a.ct, a.emit = n, ct, EMIT_MODES.index(emit)
    a.mode = SHADE_MODES.index(mode)
    a.num_geoms, a.num_materials = _scene_counts(prim_static)
    code = lib.lib.ptt_launch_mesh_shade(ctypes.byref(a), kernels.stream_handle(device))
    lib.check(code, "fused_mesh_shade")
    fused_mesh_shade.launches += 1
    out = PathState(
        origin=Vec3(*f_out[0:3]),
        direction=Vec3(*f_out[3:6]),
        color=Vec3(*f_out[6:9]),
        pixel=paths.pixel,
        bounces=b_out,
    )
    if not emit:
        return out
    return out, ((tl_out, key_out, win_out) if want_winner else (tl_out, key_out))


fused_mesh_shade.launches = 0


def fused_mesh_bounce(
    dev,
    static: SceneStatic,
    cfg: RenderConfig,
    paths: PathState,
    su_key: tuple,
    resort: bool = True,
    rng_n: int = None,
    carry: tuple = None,  # the previous bounce's (t_lim, key | None[, win])
    want_carry: bool = False,
    plain: bool = False,
    carry_winner: bool = False,
):
    """One mesh-scene bounce: the prim t prepass (or the carried one), the
    persistent coherence sort, the traversal, the winner's attributes
    and normal (torch), and the fused shade kernel.

    ``carry``/``want_carry`` thread the shade kernel's next-bounce outputs
    across bounces, so the prim prepass and the key build run only when no
    carry exists; the carry lives in the current (sorted) order.  With
    ``want_carry`` the return is ``(paths, (t_lim, key | None))``, and with
    ``carry_winner`` too ``(paths, (t_lim, key | None, win))``: the prim
    that gives each ray's t_lim, which the next bounce's shade takes instead
    of testing every prim (the prepass gives it at the first bounce).  The
    film is the same bit for bit either way.  ``plain`` runs both kernels'
    plain versions instead, on any device (the reference the kernels are
    held to on the card).

    With prefix tiers (``cfg.resolved_prefix_tiers``) and sorting on, the
    whole bounce runs over the smallest tier holding every alive ray
    (``run_tiered_carry``): the persistent sort packs the alive rays into
    the previous bounce's alive prefix, so every stage -- prepass, sort,
    traversal, attributes, the shade kernel -- takes ``[:npre]`` rows and
    the dead tail passes through.  Every stage is per ray with
    pixel-keyed draws, so only the dead rows' layout differs, which the
    by-pixel film scatter erases: the film is the same bit for bit."""
    n = paths.pixel.shape[0]
    rng_n = rng_n or n
    device = paths.origin.x.device
    sort_rays = ray_sorting_on(cfg, device)
    npres = tier_sizes(n, cfg.resolved_prefix_tiers(device)) if sort_rays else []

    def body(head, head_carry):
        # The binned pair budget stays anchored to the unsliced count: a
        # budget of the head's own would overflow on mid bounces and fall
        # back to the streamed walk (the JAX package's budget_anchor_n).
        return _fused_mesh_bounce_at(
            dev, static, cfg, head, resort, su_key, rng_n, sort_rays, head_carry,
            want_carry, plain, carry_winner, budget_rays=n,
        )

    return run_tiered_carry(paths, carry, npres, body, want_carry)


def tier_sizes(n: int, tiers) -> list:
    """Prefix-tier row counts for an n-ray state: each configured divisor d
    yields an n/d prefix rounded UP to intersect-block units (256 rows --
    every kernel pads internally so any multiple works, and 256 keeps tiers
    engageable at test-sized ray counts)."""
    npres = []
    unit = 256
    for div in sorted({int(d) for d in tiers}, reverse=True):
        npre = min(n, ((n // max(1, div) + unit - 1) // unit) * unit)
        if 0 < npre < n and npre not in npres:
            npres.append(npre)
    return npres


def engaged_tier(paths: PathState, npres: list):
    """The smallest of ``npres`` that holds every alive ray (the last alive
    position below it; one host read), or None for the full state.  The
    JAX package's ``lax.cond`` chain on the same predicate."""
    if not npres:
        return None
    live_pos = intersect_mxu.live_position(paths.alive)
    return next((p for p in sorted(npres) if live_pos < p), None)


def _head(paths: PathState, npre: int) -> PathState:
    """The first ``npre`` rows of ``paths`` (views)."""
    cut = lambda a: a[:npre]
    return PathState(Vec3(*map(cut, paths.origin)), Vec3(*map(cut, paths.direction)),
                     Vec3(*map(cut, paths.color)), cut(paths.pixel), cut(paths.bounces))


def _join(head: PathState, paths: PathState, npre: int) -> PathState:
    """``head`` over the first ``npre`` rows of ``paths``, its tail after."""
    cat = lambda a, b: torch.cat([a, b[npre:]])
    return PathState(*(Vec3(*map(cat, h, p)) for h, p in zip(head[:3], paths[:3])),
                     cat(head.pixel, paths.pixel), cat(head.bounces, paths.bounces))


def run_tiered(paths: PathState, npres: list, body) -> PathState:
    """Run ``body`` (a whole bounce, PathState -> PathState) over the
    smallest of the prefixes ``npres`` that holds every alive ray (the
    caller keeps the alive rays packed at the front), the dead tail
    passing through untouched; over the full state when none holds them."""
    return run_tiered_carry(paths, None, npres, lambda head, _: body(head), False)


def run_tiered_carry(paths: PathState, carry, npres: list, body, want_carry: bool):
    """``run_tiered`` for the mesh bounce, whose body also takes and (with
    ``want_carry``) returns the carry ``(t_lim, key | None[, win])``: the
    carry is cut to the head, and the full-length carry out gets constant
    tails.  A row past the engaged tier is dead, and stays past every later
    bounce's tier (the alive rays only shrink into the prefix), so no later
    bounce reads its tail values for a live ray: t_lim ``FLT_MAX``, the key
    ``DEAD_KEY`` (which a dead ray's key is, so the sort keeps those rows
    last), and the winner -1, "no prim" (a dead lane's prim hit is never
    used, and -1 is the value the shade already takes for a lane no prim
    bounds, so it indexes nothing)."""
    npre = engaged_tier(paths, npres)
    if npre is None:
        return body(paths, carry)
    head_carry = None if carry is None else tuple(
        None if c is None else c[:npre] for c in carry)
    out = body(_head(paths, npre), head_carry)
    out_p, out_c = out if want_carry else (out, None)
    full_p = _join(out_p, paths, npre)
    if not want_carry:
        return full_p
    tail = paths.pixel.shape[0] - npre
    fills = (FLT_MAX, intersect_mxu.DEAD_KEY, -1)
    full_c = tuple(
        None if c is None else torch.cat([c, c.new_full((tail,), fill)])
        for c, fill in zip(out_c, fills)
    )
    return full_p, full_c


def _mesh_traversal(tables, static: SceneStatic, cfg: RenderConfig, paths: PathState,
                    t_lim: torch.Tensor, plain: bool, budget_rays: int = None):
    """The traversal of a fused bounce's rays; ``budget_rays`` anchors the
    binned pair budget (the frame's unsliced ray count under a prefix tier;
    by default the rays given)."""
    return intersect_mxu.mesh_intersect_mxu(
        tables, static.num_triangles, static.mxu_padded_tris, paths.origin,
        paths.direction, paths.alive, t_lim, cfg.baby_epsilon,
        mesh_bounds=static.mesh_bounds, compute_uv=False, plain=plain,
        **intersect_mxu.traversal_flags(
            cfg.mxu_traversal, static.mxu_padded_tris,
            binned_tiers=cfg.mxu_binned_tiers,
            binned_budget_rays=budget_rays or paths.pixel.shape[0],
        ),
    )


def mesh_surface(tables, static: SceneStatic, cfg: RenderConfig, paths: PathState,
                 t_lim: torch.Tensor, plain: bool = False, budget_rays: int = None):
    """The mesh half of a fused bounce's surface, in torch around the
    traversal: ``(mesh_t, mesh_normal, mesh_mat)`` -- the traversal's t,
    the winner's interpolated vertex normal (zero without a mesh hit) and
    its material (-1 without a mesh hit)."""
    ro, rd = paths.origin, paths.direction
    mh = _mesh_traversal(tables, static, cfg, paths, t_lim, plain, budget_rays)
    with span("mesh.surface"):
        tri_hit = mh.tri >= 0
        at = intersect_mxu.resolve_shade_attributes(tables, static.mxu_padded_tris, mh.tri)
        uu, vv = intersect_mxu.winner_uv_from_geom(
            at[:, 10:13], at[:, 13:16], at[:, 16:19], mh.tri, ro, rd, cfg.baby_epsilon,
        )
        w = 1.0 - uu - vv
        cols = lambda a: Vec3(at[:, a], at[:, a + 1], at[:, a + 2])
        mesh_normal = vec.normalize(cols(0) * w + cols(3) * uu + cols(6) * vv)
        # Miss rows are all zero, whose normalize is NaN: mask them out.
        zero = torch.zeros_like(uu)
        mesh_normal = vec.where(tri_hit, mesh_normal, Vec3(zero, zero, zero))
        mesh_mat = torch.where(tri_hit, at[:, 9].to(torch.int32), -1)
    return mh.t, mesh_normal, mesh_mat


def textured_mesh_surface(dev, static: SceneStatic, cfg: RenderConfig, paths: PathState,
                          t_lim: torch.Tensor, plain: bool = False, budget_rays: int = None):
    """``mesh_surface`` of a scene with textures on mesh materials:
    ``(mesh_t, shading_normal, mesh_mat, albedo)``.  The full attribute rows
    (``resolve_attributes``: normals 0-8, uv 9-14, dpdu/dpdv 15-20, the
    material 21, v0/e1/e2 24-32) give the interpolated uv and the tangents;
    the normal is oriented toward the ray before the bump, as the unfused
    path's ``isect.normal`` arrives, and ``shade.textured_surface`` gives the
    albedo and the bump-perturbed normal (zero without a mesh hit)."""
    tables = dev.mxu_mesh
    ro, rd = paths.origin, paths.direction
    mh = _mesh_traversal(tables, static, cfg, paths, t_lim, plain, budget_rays)
    tri_hit = mh.tri >= 0
    at = intersect_mxu.resolve_attributes(tables, static.mxu_padded_tris, mh.tri)
    uu, vv = intersect_mxu.winner_uv_from_geom(
        at[:, 24:27], at[:, 27:30], at[:, 30:33], mh.tri, ro, rd, cfg.baby_epsilon,
    )
    w = 1.0 - uu - vv
    cols = lambda a: Vec3(at[:, a], at[:, a + 1], at[:, a + 2])
    zero = torch.zeros_like(uu)
    zeros = Vec3(zero, zero, zero)
    ng = vec.normalize(cols(0) * w + cols(3) * uu + cols(6) * vv)
    ng = vec.where(tri_hit, ng, zeros)
    ng = vec.where(vec.dot(rd, ng) > 0.0, -ng, ng)
    mesh_mat = torch.where(tri_hit, at[:, 21].to(torch.int32), -1)
    isect_m = Intersections(
        t=mh.t, normal=ng, material_id=mesh_mat,
        uv_u=at[:, 9] * w + at[:, 11] * uu + at[:, 13] * vv,
        uv_v=at[:, 10] * w + at[:, 12] * uu + at[:, 14] * vv,
        dpdu=cols(15), dpdv=cols(18), is_triangle=tri_hit,
    )
    mid = torch.clamp(mesh_mat, 0, static.num_materials - 1)
    base = vec.select_gather(dev.materials.color, mid.long())
    albedo, normal = shade_ops.textured_surface(dev, static, isect_m, mid, base,
                                                live=tri_hit & paths.alive)
    return mh.t, vec.where(tri_hit, normal, zeros), mesh_mat, albedo


def _fused_mesh_bounce_at(dev, static, cfg, paths, resort, su_key, rng_n,
                          sort_rays, carry, want_carry, plain, carry_winner,
                          budget_rays=None):
    """The mesh bounce's body (``fused_mesh_bounce``), over the whole state
    or a prefix tier's head of it."""
    ckey = win = None
    if carry is not None:
        t_lim, ckey, *rest = carry
        win = rest[0] if rest else None
    else:
        with span("mesh.prepass"):
            if carry_winner:
                t_lim, win = prim_t_min(static, cfg, paths.origin, paths.direction,
                                        winner=True)
            else:
                t_lim = prim_t_min(static, cfg, paths.origin, paths.direction)
    tables = dev.mxu_mesh
    if sort_rays and resort:
        with span("mesh.sort"):
            if ckey is not None:
                perm = torch.argsort(ckey, stable=True)
            else:
                mode = "signature" if cfg.ray_sort_mode == "auto" else cfg.ray_sort_mode
                perm = intersect_mxu.coherence_perm(
                    tables, paths.origin, paths.direction, paths.alive, t_lim,
                    cfg.ray_sort_bits, cfg.ray_sort_dir_bits, mode=mode,
                )
            paths, extra = permute_path_state(
                paths, perm, extra=(t_lim,) if win is None else (t_lim, win))
            t_lim, win = extra[0], (extra[1] if win is not None else None)

    if static.num_textures > 0:
        mesh_t, mesh_normal, mesh_mat, albedo = textured_mesh_surface(
            dev, static, cfg, paths, t_lim, plain, budget_rays)
        mode = "textured"
    else:
        mesh_t, mesh_normal, mesh_mat = mesh_surface(tables, static, cfg, paths, t_lim, plain,
                                                     budget_rays)
        mode, albedo = "plain", None
    with span("mesh.shade"):
        prim_static = dataclasses.replace(static, num_triangles=0)
        emit = ""
        if want_carry:
            ct = tables.tile_aabb.shape[0]
            emit = "tlim+key" if ct <= intersect_mxu.KEY_INLINE_MAX_CT else "tlim"
        shade = fused_mesh_shade_plain if plain else fused_mesh_shade
        return shade(
            prim_static, cfg, paths, mesh_t, mesh_normal, mesh_mat, su_key, rng_n,
            emit=emit,
            tile_aabb=tables.tile_aabb if emit == "tlim+key" else None,
            center=tables.center if emit == "tlim+key" else None,
            mode=mode, mesh_albedo=albedo, prim_winner=win,
            want_winner=want_carry and carry_winner,
        )


# ---------------------------------------------------------------------------
# Textured-prim bounce (the shade kernel in mode "precomputed")
# ---------------------------------------------------------------------------

def fused_tex_applicable(static: SceneStatic, cfg: RenderConfig) -> bool:
    """Scenes with a textured or bump-mapped prim (with or without a mesh):
    the whole intersect and texture/bump surface resolve in torch, shared
    with the unfused shade, and the BSDF scatter in the shade kernel."""
    return static.num_textures > 0 and static.prim_textured and cfg.shader == "full"


def tex_sort_active(cfg: RenderConfig, device) -> bool:
    """Whether the textured-prim bounce runs liveness-packed (and so prefix
    tiered, its film scattered by pixel).  A pure liveness sort only buys
    the tier slicing, so it engages only when tiers are configured
    (``RenderConfig.resolved_prefix_tiers``) and sorting is on."""
    return bool(cfg.resolved_prefix_tiers(device)) and ray_sorting_on(cfg, device)


def fused_tex_bounce(
    dev,
    static: SceneStatic,
    cfg: RenderConfig,
    paths: PathState,
    su_key: tuple,
    rng_n: int = None,
    plain: bool = False,
    resort: bool = True,
) -> PathState:
    """One bounce of a textured-prim scene: ``intersect_scene`` (any mesh
    intersector) and ``shade.textured_surface`` in torch, exactly as the
    unfused shade runs them, then the shade kernel in mode "precomputed"
    with the uniforms drawn inline.  ``plain`` runs the traversal's and the
    shade kernel's plain versions.

    With ``tex_sort_active``, the bounce runs liveness-packed: with
    ``resort`` a stable alive-first permutation (``_liveness_pack``; pixel
    order kept within the alive and the dead rays, so texel locality is
    unchanged) packs the alive rays into a prefix, and the whole bounce --
    intersect, surface, the shade kernel -- runs over the smallest prefix
    tier holding them (``run_tiered``; the pack runs inside the tier, so
    its cost shrinks with the population).  The same film bit for bit:
    every stage is per ray with pixel-keyed draws (``rng_n``, the frame's
    pixel count, whatever the rows), and the film scatters by pixel."""
    n = paths.pixel.shape[0]
    rng_n = rng_n or n
    device = paths.origin.x.device
    sort_rays = tex_sort_active(cfg, device)
    npres = tier_sizes(n, cfg.resolved_prefix_tiers(device)) if sort_rays else []

    def body(head):
        if sort_rays and resort:
            head = _liveness_pack(head)
        return _fused_tex_bounce_at(dev, static, cfg, head, su_key, rng_n, plain)

    return run_tiered(paths, npres, body)


def _liveness_pack(paths: PathState) -> PathState:
    """Stable alive-first permutation of the whole path state: the
    compaction's front pack (the scan kernel on the card), which is the
    stable argsort of ``where(alive, 0, 1)``."""
    perm, _ = front_pack_permutation(paths.alive)
    return permute_path_state(paths, perm)[0]


def _fused_tex_bounce_at(dev, static, cfg, paths, su_key, rng_n, plain) -> PathState:
    """The textured-prim bounce's body, over the whole state or a prefix
    tier's head of it."""
    isect = intersect_scene(dev, static, paths, cfg, plain=plain)
    mid = torch.clamp(isect.material_id, 0, static.num_materials - 1)
    base = vec.select_gather(dev.materials.color, mid.long())
    live = (paths.bounces > 0) & (isect.t > 0.0)
    albedo, shading_normal = shade_ops.textured_surface(dev, static, isect, mid, base,
                                                        live=live)
    prim_static = dataclasses.replace(static, num_triangles=0)
    shade = fused_mesh_shade_plain if plain else fused_mesh_shade
    return shade(
        prim_static, cfg, paths, isect.t, shading_normal, isect.material_id, su_key,
        rng_n, mode="precomputed", mesh_albedo=albedo,
    )
