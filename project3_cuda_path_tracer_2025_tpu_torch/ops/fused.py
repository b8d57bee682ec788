"""Fused bounce and iteration kernels for analytic-primitive scenes.

The JAX package fuses a prim-only, untextured scene's bounce (and, on the
main path, its whole spp iteration) into Pallas kernels
(``project3_cuda_path_tracer_2025_tpu/ops/fused.py``): ``_bounce_kernel``
via ``fused_prim_bounce`` and ``_iteration_kernel`` via
``fused_prim_iteration``.  Here both are hand-written CUDA kernels
(``csrc/fused_prim.cu``), each behind a wrapper with:

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
import functools

import numpy as np
import torch

from ..config import RenderConfig
from ..scene.camera import CameraState
from ..scene.device import SceneStatic
from ..scene.types import GeomType
from ..utils import prng
from ..utils.vec import Vec3, f32
from . import camera as camera_ops
from . import film as film_ops
from . import kernels
from . import shade as shade_ops
from .intersect import intersect_scene
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
