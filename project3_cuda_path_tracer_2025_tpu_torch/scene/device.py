"""Device scene: torch tensors + hashable static metadata.

Counterpart of the JAX package's ``scene/device.py`` for the slices the
port runs: analytic primitives, textured and untextured materials and
triangle meshes of any number of tiles of 1,024 triangles.  The primitives are not
uploaded at all: their transforms are ``SceneStatic`` constants, folded term
by term into the unfused torch path (``utils.vec._row_dot``) and packed into
the kernels' scene struct (``ops.fused``).  The material table is uploaded
for the unfused shade's per-lane gathers.  A mesh is uploaded as the JAX
package lays it out: triangles in BVH-leaf order with the flat-normal
fallback resolved once, the packed octant BVH for the threaded walk, and
the MXU intersector's tables (``ops.intersect_mxu.MXUMeshTables``).
Textures are uploaded as the JAX package's ``TextureTable``: one padded RGBA
row per texel, the wrapped forward height differences (``grad``) and the
packed u8 albedo / 10-bit gradient words (``packed``).

``SceneStatic``, ``GeomConst`` and ``MaterialConst`` keep the JAX package's
fields and values exactly (including ``_snap``), so a test can hold the two
packages' scene constants equal and ``from_jax_scene`` can carry a JAX scene
across unchanged (tables the JAX package padded to whole super-tiles
included: the tables keep their shapes, ``mxu_padded_tris`` its value).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

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


class TriangleTable(NamedTuple):
    """Per-triangle arrays in BVH-leaf order (the JAX package's layout)."""

    v0: Vec3
    v1: Vec3
    v2: Vec3
    n0: Vec3
    n1: Vec3
    n2: Vec3
    uv0u: torch.Tensor
    uv0v: torch.Tensor
    uv1u: torch.Tensor
    uv1v: torch.Tensor
    uv2u: torch.Tensor
    uv2v: torch.Tensor
    material_id: torch.Tensor  # i32
    dpdu: Vec3
    dpdv: Vec3


class BVHTable(NamedTuple):
    """Packed, octant-ordered BVH for the threaded walk.

    ``nodes``: [8*M, 16] f32, the 8 direction-ordered layouts of
    ``scene.bvh.build_octant_layouts``; a row holds aabb_min (0-2),
    aabb_max (3-5), miss link (6), leaf start (7) and leaf count (8), links
    and counts as exact small-integer floats.  ``tris``: [T, 12] f32, v0
    (0-2), edge1 (3-5), edge2 (6-8) in leaf order."""

    nodes: torch.Tensor
    tris: torch.Tensor


class TextureTable(NamedTuple):
    """Padded texture stack as row tables (the JAX package's layout).

    ``rgba``: [NT * Hmax * Wmax, 4] f32, one row per texel.  ``grad``: [.., 2]
    f32, the per-texel wrapped forward differences of the height (red)
    channel, (h[y][x+1] - h[y][x], h[y-1][x] - h[y][x]); bilinear samples of
    them are the reference's bump-map finite differences of bilinear height
    samples (the interpolation weights distribute).  ``packed``: [.., 2] i32,
    word0 = r | g << 8 | b << 16 (u8 codes; ``/ 255`` gives the f32 stack
    back exactly), word1 = (gdu * 255 + 256) | (gdv * 255 + 256) << 10: the
    albedo and gradients of one texel in one 8-byte row, for the single
    texel-quad gather (``ops.texture.sample_surface``)."""

    rgba: torch.Tensor
    grad: torch.Tensor
    width: torch.Tensor  # [NT] i32
    height: torch.Tensor  # [NT] i32
    packed: torch.Tensor


class DeviceScene(NamedTuple):
    materials: MaterialTable
    # Meshes only (None in a prim-only scene):
    triangles: Optional[TriangleTable] = None
    bvh: Optional[BVHTable] = None
    mxu_mesh: Optional["object"] = None  # ops.intersect_mxu.MXUMeshTables
    textures: Optional[TextureTable] = None  # None in an untextured scene


def _snap(x: float) -> float:
    """Snap rotation float-dust to exact constants so the constant folding
    in ``utils.vec`` triggers (cos(90 deg) in float64 is 6.1e-17, not 0)."""
    for target in (0.0, 1.0, -1.0):
        if abs(x - target) < 1e-12:
            return target
    return x


def _mat_tuple(m: np.ndarray) -> Tuple[Tuple[float, ...], ...]:
    return tuple(tuple(_snap(float(x)) for x in row) for row in np.asarray(m))


def _padded_tris(num_triangles: int) -> int:
    from ..ops import intersect_mxu as mxu

    g = mxu.GROUP_TRIS
    return ((num_triangles + g - 1) // g) * g


def _vec3(a, device) -> Vec3:
    a = np.asarray(a, np.float32)
    return Vec3(*(torch.tensor(a[..., i], device=device) for i in range(3)))


def _mesh_tables(scene: HostScene, device):
    """(TriangleTable, BVHTable, MXUMeshTables, num_nodes, leaf_size,
    mesh_bounds) of a mesh scene, in BVH-leaf order."""
    from ..ops import intersect_mxu as mxu
    from .bvh import build_octant_layouts

    t = scene.num_triangles
    order = (
        scene.bvh.tri_indices.astype(np.int64) if scene.bvh is not None
        else np.arange(t)
    )
    pos = scene.tri_positions[order]
    nrm = scene.tri_normals[order].copy()
    uv = scene.tri_uvs[order]
    mat = scene.tri_material_ids[order]
    dpdu = scene.tri_dpdu[order]
    dpdv = scene.tri_dpdv[order]
    # The reference's per-intersection flat-normal fallback
    # (src/intersections.cu:202-207), resolved once: if any vertex normal of
    # a triangle is ~zero, all three become the geometric normal.
    degenerate = (np.linalg.norm(nrm, axis=-1) < 1e-6).any(axis=-1)
    if degenerate.any():
        gn = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
        gn = gn / np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-30)
        nrm[degenerate] = gn[degenerate][:, None, :]
    f = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    triangles = TriangleTable(
        v0=_vec3(pos[:, 0], device), v1=_vec3(pos[:, 1], device),
        v2=_vec3(pos[:, 2], device),
        n0=_vec3(nrm[:, 0], device), n1=_vec3(nrm[:, 1], device),
        n2=_vec3(nrm[:, 2], device),
        uv0u=f(uv[:, 0, 0]), uv0v=f(uv[:, 0, 1]), uv1u=f(uv[:, 1, 0]),
        uv1v=f(uv[:, 1, 1]), uv2u=f(uv[:, 2, 0]), uv2v=f(uv[:, 2, 1]),
        material_id=torch.tensor(np.asarray(mat, np.int32), device=device),
        dpdu=_vec3(dpdu, device), dpdv=_vec3(dpdv, device),
    )
    tables = mxu.build_mxu_tables(pos, nrm, uv, dpdu, dpdv, mat, device=device)
    flat = pos.reshape(-1, 3)
    bounds = tuple(float(x) for x in np.concatenate([flat.min(0), flat.max(0)]))

    if scene.bvh is None:
        bvh, num_nodes, leaf_size = None, 0, 4
    else:
        b = scene.bvh
        oct_b = build_octant_layouts(b)
        num_nodes, leaf_size = b.num_nodes, b.leaf_size
        nodes = np.zeros((8, num_nodes, 16), np.float32)
        nodes[:, :, 0:3] = oct_b.aabb_min
        nodes[:, :, 3:6] = oct_b.aabb_max
        nodes[:, :, 6] = oct_b.miss.astype(np.float32)
        # Leaf starts index tri_indices, which is the order the triangles
        # were just put in.
        nodes[:, :, 7] = oct_b.start.astype(np.float32)
        nodes[:, :, 8] = oct_b.count.astype(np.float32)
        tris12 = np.zeros((t, 12), np.float32)
        tris12[:, 0:3] = pos[:, 0]
        tris12[:, 3:6] = pos[:, 1] - pos[:, 0]
        tris12[:, 6:9] = pos[:, 2] - pos[:, 0]
        bvh = BVHTable(nodes=f(nodes.reshape(8 * num_nodes, 16)), tris=f(tris12))
    return triangles, bvh, tables, num_nodes, leaf_size, bounds


def texture_rows(stack: np.ndarray, wh: np.ndarray) -> tuple:
    """(grad, packed) row tables of a padded [NT, Hmax, Wmax, 4] stack with
    true sizes ``wh`` [NT, 2], exactly as the JAX package builds them."""
    nt, hmax, wmax, _ = stack.shape
    grad = np.zeros((nt, hmax, wmax, 2), np.float32)
    for i in range(nt):
        w_i, h_i = int(wh[i, 0]), int(wh[i, 1])
        h_ch = stack[i, :h_i, :w_i, 0]
        grad[i, :h_i, :w_i, 0] = np.roll(h_ch, -1, axis=1) - h_ch
        grad[i, :h_i, :w_i, 1] = np.roll(h_ch, 1, axis=0) - h_ch
    u8 = np.clip(np.round(stack * 255.0), 0, 255).astype(np.uint32)
    word0 = u8[..., 0] | (u8[..., 1] << 8) | (u8[..., 2] << 16)
    gcode = (
        np.clip(np.round(grad * 255.0), -255, 255).astype(np.int32) + 256
    ).astype(np.uint32)
    word1 = gcode[..., 0] | (gcode[..., 1] << 10)
    packed = np.stack([word0, word1], axis=-1).view(np.int32)
    return grad.reshape(-1, 2), packed.reshape(-1, 2)


def _texture_table(rgba, grad, width, height, packed, device) -> TextureTable:
    f = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    i = lambda a: torch.tensor(np.asarray(a, np.int32), device=device)
    return TextureTable(rgba=f(rgba), grad=f(grad), width=i(width), height=i(height),
                        packed=i(packed))


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
    t = scene.num_triangles
    triangles = bvh = tables = None
    num_nodes, leaf_size, bounds = 0, 4, (0.0, 0.0, 0.0, 1.0, 1.0, 1.0)
    if t > 0:
        triangles, bvh, tables, num_nodes, leaf_size, bounds = _mesh_tables(
            scene, device
        )
    stack, wh = build_texture_stack(scene.textures)
    _, hmax, wmax, _ = stack.shape
    textures = None
    if scene.textures:
        grad, packed = texture_rows(stack, wh)
        textures = _texture_table(stack.reshape(-1, 4), grad, wh[:, 0], wh[:, 1], packed,
                                  device)
    static = SceneStatic(
        geoms=geoms,
        material_consts=material_consts,
        width=int(scene.state.camera.resolution[0]),
        height=int(scene.state.camera.resolution[1]),
        trace_depth=int(scene.state.trace_depth),
        iterations=int(scene.state.iterations),
        num_materials=len(ms),
        num_triangles=t,
        num_nodes=num_nodes,
        leaf_size=leaf_size,
        num_textures=len(scene.textures),
        tex_wmax=wmax,
        tex_hmax=hmax,
        image_name=scene.state.image_name,
        mxu_padded_tris=_padded_tris(t) if t > 0 else 0,
        mesh_bounds=bounds,
        prim_textured=any(
            ms[g.material_id].has_texture or ms[g.material_id].has_bump_map
            for g in scene.geoms
        ),
        tex_dims=tuple((int(w), int(h)) for w, h in wh),
    )
    return DeviceScene(materials, triangles, bvh, tables, textures), static


def from_jax_scene(dev_np, static, device="cpu") -> tuple[DeviceScene, SceneStatic]:
    """Carry a scene built by the JAX package across, unchanged.

    ``dev_np`` is the JAX package's ``DeviceScene`` with its leaves as numpy
    arrays (``jax.tree.map(np.asarray, dev)``); ``static`` is its
    ``SceneStatic``.  Only the fields of the ported slices are read (the
    materials and, for a mesh, the triangle, BVH and MXU tables), so this
    module needs no JAX.  Returns the port's ``(DeviceScene, SceneStatic)``
    with identical constants and tables, which lets a test run both
    packages on bit-identical scene data."""
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
    textures = None
    if static.num_textures > 0:
        t = dev_np.textures
        textures = _texture_table(t.rgba, t.grad, t.width, t.height, t.packed, device)
    if static.num_triangles == 0:
        return DeviceScene(materials, textures=textures), SceneStatic(**fields)
    from ..ops import intersect_mxu as mxu

    f = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    tr = dev_np.triangles
    v3 = lambda v: Vec3(f(v.x), f(v.y), f(v.z))
    triangles = TriangleTable(
        v0=v3(tr.v0), v1=v3(tr.v1), v2=v3(tr.v2),
        n0=v3(tr.n0), n1=v3(tr.n1), n2=v3(tr.n2),
        uv0u=f(tr.uv0u), uv0v=f(tr.uv0v), uv1u=f(tr.uv1u), uv1v=f(tr.uv1v),
        uv2u=f(tr.uv2u), uv2v=f(tr.uv2v),
        material_id=torch.tensor(np.asarray(tr.material_id, np.int32), device=device),
        dpdu=v3(tr.dpdu), dpdv=v3(tr.dpdv),
    )
    bvh = BVHTable(nodes=f(dev_np.bvh.nodes), tris=f(dev_np.bvh.tris))
    m = dev_np.mxu_mesh
    tables = mxu.tables_from_arrays(
        m.features, m.tile_aabb, m.attrs, m.attrs_shade, m.center, device
    )
    return DeviceScene(materials, triangles, bvh, tables, textures), SceneStatic(**fields)
