"""Fused bounce and iteration kernels.

The JAX package fuses a prim-only, untextured scene's bounce (and, on the
main path, its whole spp iteration) into Pallas kernels
(``project3_cuda_path_tracer_2025_tpu/ops/fused.py``): ``_bounce_kernel``
via ``fused_prim_bounce`` and ``_iteration_kernel`` via
``fused_prim_iteration``.  A mesh scene's bounce runs the mesh traversal
(``ops.intersect_mxu``) and then ``_mesh_bounce_kernel`` via
``_fused_mesh_shade``: prim intersect, merge with the mesh hit, BSDF
scatter, inline RNG and the next bounce's prune and sort key.  Here all
three are hand-written CUDA kernels (``csrc/fused_prim.cu``,
``csrc/fused_mesh.cu``), each behind a wrapper with:

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
from ..utils.vec import Vec3, f32
from . import camera as camera_ops
from . import film as film_ops
from . import intersect_mxu, kernels
from . import shade as shade_ops
from .compaction import permute_path_state
from .intersect import intersect_scene, prim_t_min, ray_sorting_on
from .rays import PathState


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
    """The scene constants as the kernels' ``PttScene`` struct."""
    return _scene_struct(static, _eps(cfg))


@functools.lru_cache(maxsize=8)
def _scene_buffer(static: SceneStatic, eps: tuple, device: torch.device) -> torch.Tensor:
    """The scene's ``PttScene`` struct, uploaded once per (scene, device)."""
    blob = np.frombuffer(bytes(_scene_struct(static, eps)), dtype=np.uint8).copy()
    return torch.from_numpy(blob).to(device)


def _scene_struct(static: SceneStatic, eps: tuple) -> kernels.PttScene:
    if len(static.geoms) > kernels.MAX_GEOMS:
        raise ValueError(
            f"{len(static.geoms)} primitives exceed the kernels' capacity of "
            f"{kernels.MAX_GEOMS} (PTT_MAX_GEOMS in csrc/prim_path.cuh)"
        )
    if static.num_materials > kernels.MAX_MATERIALS:
        raise ValueError(
            f"{static.num_materials} materials exceed the kernels' capacity of "
            f"{kernels.MAX_MATERIALS} (PTT_MAX_MATERIALS in csrc/prim_path.cuh)"
        )
    s = kernels.PttScene()
    s.num_geoms = len(static.geoms)
    s.num_materials = static.num_materials
    (s.lobe_glass, s.lobe_mirror, s.lobe_trans, s.lobe_micro) = (
        int(b) for b in shade_ops.lobes_present(static)
    )
    s.baby_eps, s.larger_eps, s.ray_eps = (f32(e) for e in eps)
    for i, g in enumerate(static.geoms):
        s.geoms[i].type = 1 if g.gtype == int(GeomType.CUBE) else 0
        s.geoms[i].material_id = g.material_id
        s.geoms[i].inverse[:] = _rows12(g.inverse)
        s.geoms[i].transform[:] = _rows12(g.transform)
        s.geoms[i].inv_transpose[:] = _rows12(g.inv_transpose)
    for i, m in enumerate(static.material_consts):
        mat = s.materials[i]
        mat.color[:] = [f32(c) for c in m.color]
        mat.emittance = m.emittance
        mat.has_reflective = m.has_reflective
        mat.has_refractive = m.has_refractive
        mat.ior = m.ior
        mat.roughness = m.roughness
        mat.metallic = m.metallic
    return s


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

def fused_prim_bounce_plain(
    static: SceneStatic, cfg: RenderConfig, paths: PathState,
    uniforms: torch.Tensor,
) -> PathState:
    """The plain PyTorch version of the bounce kernel."""
    return _prim_bounce(static, cfg, paths, uniforms)


def fused_prim_bounce(
    static: SceneStatic,
    cfg: RenderConfig,
    paths: PathState,
    uniforms: torch.Tensor,  # [3, N]
) -> PathState:
    """One bounce of intersect + shade for a prim-only, untextured scene."""
    device = paths.origin.x.device
    if device.type == "cpu":
        return fused_prim_bounce_plain(static, cfg, paths, uniforms)
    _require_cuda(device, "fused_prim_bounce")
    n = paths.pixel.shape[0]
    f_in = (*paths.origin, *paths.direction, *paths.color)
    _check_planes("fused_prim_bounce paths", f_in, n, torch.float32, device)
    _check_planes("fused_prim_bounce bounces", (paths.bounces,), n, torch.int32, device)
    if uniforms.shape != (3, n) or uniforms.dtype != torch.float32 \
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
    a.u = uniforms.data_ptr()
    a.out_f[:] = [t.data_ptr() for t in f_out]
    a.out_bounces = b_out.data_ptr()
    a.n = n
    code = lib.lib.ptt_launch_bounce(ctypes.byref(a), kernels.stream_handle(device))
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

    The uniforms are drawn inside the kernel from the stage keys derived
    here (the same ``(iteration, depth, stage)`` streams as
    ``megakernel_iteration``), and the camera is an argument, so an orbit
    rebuilds nothing.  The film is updated in place (the JAX package donates
    it).  Returns (film, alive_counts[depth])."""
    device = film.x.device
    if device.type == "cpu":
        return fused_prim_iteration_plain(static, cfg, cam, film, iteration, base_key)
    _require_cuda(device, "fused_prim_iteration")
    n, depth = static.pixel_count, static.trace_depth
    if depth > kernels.MAX_DEPTH:
        raise ValueError(
            f"depth {depth} exceeds the iteration kernel's capacity of "
            f"{kernels.MAX_DEPTH} (PTT_MAX_DEPTH in csrc/prim_path.cuh)"
        )
    _check_planes("fused_prim_iteration film", film, n, torch.float32, device)
    lib = kernels.load()
    scene = _scene_buffer(static, _eps(cfg), device)
    alive = torch.zeros((depth,), dtype=torch.int32, device=device)
    cam_key, shade_keys = iteration_keys(static, iteration, base_key)

    a = kernels.PttIterArgs()
    a.scene = scene.data_ptr()
    a.film_x, a.film_y, a.film_z = (t.data_ptr() for t in film)
    a.alive = alive.data_ptr()
    a.cam = camera_struct(cam)
    a.width, a.height, a.n, a.depth = static.width, static.height, n, depth
    keys = [*cam_key] + [k for sk in shade_keys for k in sk]
    a.keys[: len(keys)] = keys
    code = lib.lib.ptt_launch_iteration(ctypes.byref(a), kernels.stream_handle(device))
    lib.check(code, "fused_prim_iteration")
    fused_prim_iteration.launches += 1
    return film, alive


fused_prim_iteration.launches = 0


# ---------------------------------------------------------------------------
# Threefry uniforms on the card (utils/prng.py::uniforms on a CUDA device)
# ---------------------------------------------------------------------------

def kernel_uniforms(key: tuple, n: int, k: int, device) -> torch.Tensor:
    """``prng.uniforms(key, n, k)`` drawn by the in-kernel Threefry:
    bit-identical to the plain version."""
    device = torch.device(device)
    _require_cuda(device, "kernel_uniforms")
    total = n * k
    if total >= 2**32:
        raise ValueError(f"{k} x {n} uniforms exceed the 32-bit counter")
    out = torch.empty((k, n), dtype=torch.float32, device=device)
    lib = kernels.load()
    code = lib.lib.ptt_launch_uniforms(
        key[0], key[1], total, out.data_ptr(), kernels.stream_handle(device)
    )
    lib.check(code, "kernel_uniforms")
    kernel_uniforms.launches += 1
    return out


kernel_uniforms.launches = 0


# ---------------------------------------------------------------------------
# Fused mesh bounce  (the shade kernel replaces ops/fused.py::_mesh_bounce_kernel,
# mode "plain"; the traversal is ops.intersect_mxu.mono_intersect)
# ---------------------------------------------------------------------------

EMIT_MODES = ("", "tlim", "tlim+key")


def fused_mesh_applicable(static: SceneStatic, cfg: RenderConfig) -> bool:
    """A mesh scene takes the fused mesh bounce when it runs the MXU
    tables' traversal (textured scenes are not ported: ``build_device_scene``
    refuses them)."""
    return (
        static.has_triangles
        and not (static.num_textures > 0 and static.prim_textured)
        and cfg.shader == "full"
        and cfg.bvh_acceleration
        and cfg.mesh_intersector in ("auto", "mxu")
    )


def _check_mode(mode: str, emit: str) -> None:
    if mode != "plain":
        raise NotImplementedError(
            f"the fused mesh shade's mode {mode!r} is not ported yet "
            "(ROADMAP.md, Queue 1: textures)"
        )
    if emit not in EMIT_MODES:
        raise ValueError(f"emit={emit!r}: use one of {EMIT_MODES}")


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
):
    """The plain PyTorch version of the mesh-shade kernel (see
    ``fused_mesh_shade``)."""
    uni = prng.uniforms_at(su_key, paths.pixel, 3, rng_n)
    isect_p = intersect_scene(None, prim_static, paths, cfg)
    # The traversal ran with the prim nearest t as its t_limit, so a mesh
    # hit is closer than every prim (an exact tie stays with the prim).
    tri_hit = mesh_mat >= 0
    flip = vec.dot(paths.direction, mesh_normal) > 0.0
    mn = vec.where(flip, -mesh_normal, mesh_normal)
    t = torch.where(tri_hit, mesh_t, isect_p.t)
    normal = vec.where(tri_hit, mn, isect_p.normal)
    mat = torch.where(tri_hit, mesh_mat, isect_p.material_id)
    mid = torch.clamp(mat, 0, prim_static.num_materials - 1)
    albedo, emitt, refl, refr, ior, rough, metal = _const_material_params(
        prim_static, mid
    )
    out = shade_ops.scatter_compose(
        cfg, paths, isect_p._replace(t=t, normal=normal, material_id=mat), normal,
        albedo, emitt, refl, refr, ior, rough, metal,
        (uni[0], uni[1], uni[2]),
        lobes=shade_ops.lobes_present(prim_static),
    )
    if not emit:
        return out
    tl_n = prim_t_min(prim_static, cfg, out.origin, out.direction)
    key_n = None
    if emit == "tlim+key":
        key_n = intersect_mxu.coherence_key_planes(
            tile_aabb, center[0], center[1], center[2],
            *out.origin, *out.direction, out.bounces > 0, tl_n,
        )
    return out, (tl_n, key_n)


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
    mode: str = "plain",
):
    """Prim intersect + merge with the mesh hit + BSDF scatter of one
    bounce, with the uniforms drawn inline at ``(su_key, j*rng_n + pixel)``
    (a slot's stream follows its pixel, so a permuted state draws the same
    numbers).  ``prim_static`` is the scene's static with
    ``num_triangles=0``.  With ``emit`` it also returns the scattered rays'
    prim nearest t (the next bounce's t_limit) and, for "tlim+key", their
    coherence sort key: ``(paths, (t_lim, key | None))``."""
    _check_mode(mode, emit)
    device = paths.origin.x.device
    if device.type == "cpu":
        return fused_mesh_shade_plain(
            prim_static, cfg, paths, mesh_t, mesh_normal, mesh_mat, su_key,
            rng_n, emit, tile_aabb, center,
        )
    _require_cuda(device, "fused_mesh_shade")
    n = paths.pixel.shape[0]
    f_in = (*paths.origin, *paths.direction, *paths.color)
    _check_planes("fused_mesh_shade paths", (*f_in, mesh_t, *mesh_normal), n,
                  torch.float32, device)
    _check_planes("fused_mesh_shade ints", (paths.bounces, paths.pixel, mesh_mat), n,
                  torch.int32, device)
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
    a = kernels.PttMeshShadeArgs()
    a.scene = scene.data_ptr()
    a.in_f[:] = [t.data_ptr() for t in f_in]
    a.in_bounces = paths.bounces.data_ptr()
    a.pixel = paths.pixel.data_ptr()
    a.mesh_t = mesh_t.data_ptr()
    a.mesh_n[:] = [t.data_ptr() for t in mesh_normal]
    a.mesh_mat = mesh_mat.data_ptr()
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
    return (out, (tl_out, key_out)) if emit else out


fused_mesh_shade.launches = 0


def fused_mesh_bounce(
    dev,
    static: SceneStatic,
    cfg: RenderConfig,
    paths: PathState,
    su_key: tuple,
    resort: bool = True,
    rng_n: int = None,
    carry: tuple = None,  # the previous bounce's (t_lim, key | None)
    want_carry: bool = False,
    plain: bool = False,
):
    """One mesh-scene bounce: the prim t prepass (or the carried one), the
    persistent coherence sort, the mono traversal, the winner's attributes
    and normal (torch), and the fused shade kernel.

    ``carry``/``want_carry`` thread the shade kernel's next-bounce outputs
    across bounces, so the prim prepass and the key build run only when no
    carry exists; the carry lives in the current (sorted) order.  With
    ``want_carry`` the return is ``(paths, (t_lim, key | None))``.  The
    JAX package's bounce prefix tiers resolve to none in the port
    (``RenderConfig.bounce_prefix_tiers``).  ``plain`` runs both kernels'
    plain versions instead, on any device (the reference the kernels are
    held to on the card)."""
    rng_n = rng_n or paths.pixel.shape[0]
    sort_rays = ray_sorting_on(cfg, paths.origin.x.device)
    return _fused_mesh_bounce_at(
        dev, static, cfg, paths, resort, su_key, rng_n, sort_rays, carry,
        want_carry, plain,
    )


def mesh_surface(tables, static: SceneStatic, cfg: RenderConfig, paths: PathState,
                 t_lim: torch.Tensor, plain: bool = False):
    """The mesh half of a fused bounce's surface, in torch around the mono
    traversal: ``(mesh_t, mesh_normal, mesh_mat)`` -- the traversal's t,
    the winner's interpolated vertex normal (zero without a mesh hit) and
    its material (-1 without a mesh hit)."""
    ro, rd = paths.origin, paths.direction
    mh = intersect_mxu.mesh_intersect_mxu(
        tables, static.num_triangles, static.mxu_padded_tris, ro, rd,
        paths.alive, t_lim, cfg.baby_epsilon,
        mesh_bounds=static.mesh_bounds, compute_uv=False, plain=plain,
        **intersect_mxu.traversal_flags(cfg.mxu_traversal, static.mxu_padded_tris),
    )
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


def _fused_mesh_bounce_at(dev, static, cfg, paths, resort, su_key, rng_n,
                          sort_rays, carry, want_carry, plain):
    ckey = None
    if carry is not None:
        t_lim, ckey = carry
    else:
        t_lim = prim_t_min(static, cfg, paths.origin, paths.direction)
    tables = dev.mxu_mesh
    if sort_rays and resort:
        if ckey is not None:
            perm = torch.argsort(ckey, stable=True)
        else:
            mode = "signature" if cfg.ray_sort_mode == "auto" else cfg.ray_sort_mode
            perm = intersect_mxu.coherence_perm(
                tables, paths.origin, paths.direction, paths.alive, t_lim,
                cfg.ray_sort_bits, cfg.ray_sort_dir_bits, mode=mode,
            )
        paths, (t_lim,) = permute_path_state(paths, perm, extra=(t_lim,))

    mesh_t, mesh_normal, mesh_mat = mesh_surface(tables, static, cfg, paths, t_lim, plain)
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
    )
