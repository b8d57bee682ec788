"""Device scene: torch tensors + hashable static metadata.

Counterpart of the JAX package's ``scene/device.py`` for the slice the port
runs: analytic primitives and untextured materials.  The primitives are not
uploaded at all: their transforms are ``SceneStatic`` constants, folded term
by term into the unfused torch path (``utils.vec._row_dot``) and packed into
the kernels' scene struct (``ops.fused``).  The material table is uploaded
for the unfused shade's per-lane gathers.

``SceneStatic``, ``GeomConst`` and ``MaterialConst`` keep the JAX package's
fields and values exactly (including ``_snap``), so a test can hold the two
packages' scene constants equal and ``from_jax_scene`` can carry a JAX scene
across unchanged.  Triangle meshes and textures are not ported yet
(``ROADMAP.md``, Queue 1: meshes, textures).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..utils.vec import Vec3
from .textures import build_texture_stack
from .types import HostScene


class GeomConst(NamedTuple):
    """One analytic primitive, fully static (nested float tuples hash)."""

    gtype: int  # GeomType value
    material_id: int
    transform: Tuple[Tuple[float, ...], ...]
    inverse: Tuple[Tuple[float, ...], ...]
    inv_transpose: Tuple[Tuple[float, ...], ...]


class MaterialConst(NamedTuple):
    """One material as static constants (the fused kernels' scene struct)."""

    color: Tuple[float, float, float]
    emittance: float
    has_reflective: float
    has_refractive: float
    ior: float
    roughness: float
    metallic: float
    texture_id: int = -1
    bump_id: int = -1
    bump_scale: float = 0.0


@dataclass(frozen=True)
class SceneStatic:
    geoms: Tuple[GeomConst, ...]
    material_consts: Tuple[MaterialConst, ...]
    width: int
    height: int
    trace_depth: int
    iterations: int
    num_materials: int
    num_triangles: int
    num_nodes: int
    leaf_size: int
    num_textures: int
    tex_wmax: int
    tex_hmax: int
    image_name: str
    mxu_padded_tris: int = 0
    mesh_bounds: Tuple[float, float, float, float, float, float] = (
        0.0, 0.0, 0.0, 1.0, 1.0, 1.0,
    )
    prim_textured: bool = False
    tex_dims: Tuple[Tuple[int, int], ...] = ()

    @property
    def has_triangles(self) -> bool:
        return self.num_triangles > 0

    @property
    def pixel_count(self) -> int:
        return self.width * self.height


class MaterialTable(NamedTuple):
    color: Vec3  # [M]
    emittance: torch.Tensor
    has_reflective: torch.Tensor
    has_refractive: torch.Tensor
    ior: torch.Tensor
    roughness: torch.Tensor
    metallic: torch.Tensor
    texture_id: torch.Tensor  # i32, -1 = none
    bump_id: torch.Tensor  # i32, -1 = none
    bump_scale: torch.Tensor


class DeviceScene(NamedTuple):
    materials: MaterialTable


def _snap(x: float) -> float:
    """Snap rotation float-dust to exact constants so the constant folding
    in ``utils.vec`` triggers (cos(90 deg) in float64 is 6.1e-17, not 0)."""
    for target in (0.0, 1.0, -1.0):
        if abs(x - target) < 1e-12:
            return target
    return x


def _mat_tuple(m: np.ndarray) -> Tuple[Tuple[float, ...], ...]:
    return tuple(tuple(_snap(float(x)) for x in row) for row in np.asarray(m))


def _check_slice(num_triangles: int, num_textures: int) -> None:
    if num_triangles > 0:
        raise NotImplementedError(
            "triangle meshes are not ported yet (ROADMAP.md, Queue 1: meshes)"
        )
    if num_textures > 0:
        raise NotImplementedError(
            "textures are not ported yet (ROADMAP.md, Queue 1: textures)"
        )


def _material_table(cols: dict, device) -> MaterialTable:
    # torch.tensor copies: the table never aliases a caller's (possibly
    # read-only) array.
    f = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    i = lambda a: torch.tensor(np.asarray(a, np.int32), device=device)
    return MaterialTable(
        color=Vec3(f(cols["r"]), f(cols["g"]), f(cols["b"])),
        emittance=f(cols["emittance"]),
        has_reflective=f(cols["has_reflective"]),
        has_refractive=f(cols["has_refractive"]),
        ior=f(cols["ior"]),
        roughness=f(cols["roughness"]),
        metallic=f(cols["metallic"]),
        texture_id=i(cols["texture_id"]),
        bump_id=i(cols["bump_id"]),
        bump_scale=f(cols["bump_scale"]),
    )


def build_device_scene(
    scene: HostScene, device="cuda"
) -> tuple[DeviceScene, SceneStatic]:
    _check_slice(scene.num_triangles, len(scene.textures))
    ms = scene.materials
    if not ms:
        raise ValueError("scene has no materials")
    geoms = tuple(
        GeomConst(
            gtype=int(g.type),
            material_id=int(g.material_id),
            transform=_mat_tuple(g.transform),
            inverse=_mat_tuple(g.inverse_transform),
            inv_transpose=_mat_tuple(g.inv_transpose),
        )
        for g in scene.geoms
    )
    color = np.stack([m.color for m in ms]).astype(np.float32)
    materials = _material_table(
        dict(
            r=color[:, 0], g=color[:, 1], b=color[:, 2],
            emittance=[m.emittance for m in ms],
            has_reflective=[m.has_reflective for m in ms],
            has_refractive=[m.has_refractive for m in ms],
            ior=[m.index_of_refraction for m in ms],
            roughness=[m.roughness for m in ms],
            metallic=[m.metallic for m in ms],
            texture_id=[m.texture_id if m.has_texture else -1 for m in ms],
            bump_id=[m.bump_id if m.has_bump_map else -1 for m in ms],
            bump_scale=[m.bump_scale for m in ms],
        ),
        device,
    )
    material_consts = tuple(
        MaterialConst(
            color=tuple(float(x) for x in m.color),
            emittance=float(m.emittance),
            has_reflective=float(m.has_reflective),
            has_refractive=float(m.has_refractive),
            ior=float(m.index_of_refraction),
            roughness=float(m.roughness),
            metallic=float(m.metallic),
            texture_id=int(m.texture_id) if m.has_texture else -1,
            bump_id=int(m.bump_id) if m.has_bump_map else -1,
            bump_scale=float(m.bump_scale),
        )
        for m in ms
    )
    stack, wh = build_texture_stack(scene.textures)
    _, hmax, wmax, _ = stack.shape
    static = SceneStatic(
        geoms=geoms,
        material_consts=material_consts,
        width=int(scene.state.camera.resolution[0]),
        height=int(scene.state.camera.resolution[1]),
        trace_depth=int(scene.state.trace_depth),
        iterations=int(scene.state.iterations),
        num_materials=len(ms),
        num_triangles=0,
        num_nodes=0,
        leaf_size=4,
        num_textures=0,
        tex_wmax=wmax,
        tex_hmax=hmax,
        image_name=scene.state.image_name,
        prim_textured=any(
            ms[g.material_id].has_texture or ms[g.material_id].has_bump_map
            for g in scene.geoms
        ),
        tex_dims=tuple((int(w), int(h)) for w, h in wh),
    )
    return DeviceScene(materials), static


def from_jax_scene(dev_np, static, device="cpu") -> tuple[DeviceScene, SceneStatic]:
    """Carry a scene built by the JAX package across, unchanged.

    ``dev_np`` is the JAX package's ``DeviceScene`` with its leaves as numpy
    arrays (``jax.tree.map(np.asarray, dev)``); ``static`` is its
    ``SceneStatic``.  Only the fields of the ported slice are read, so this
    module needs no JAX.  Returns the port's ``(DeviceScene, SceneStatic)``
    with identical constants, which lets a test run both packages on
    bit-identical scene data."""
    _check_slice(static.num_triangles, static.num_textures)
    m = dev_np.materials
    materials = _material_table(
        dict(
            r=m.color.x, g=m.color.y, b=m.color.z,
            emittance=m.emittance,
            has_reflective=m.has_reflective,
            has_refractive=m.has_refractive,
            ior=m.ior,
            roughness=m.roughness,
            metallic=m.metallic,
            texture_id=m.texture_id,
            bump_id=m.bump_id,
            bump_scale=m.bump_scale,
        ),
        device,
    )
    fields = {f: getattr(static, f) for f in SceneStatic.__dataclass_fields__}
    fields["geoms"] = tuple(GeomConst(*g) for g in static.geoms)
    fields["material_consts"] = tuple(
        MaterialConst(*mc) for mc in static.material_consts
    )
    return DeviceScene(materials), SceneStatic(**fields)
