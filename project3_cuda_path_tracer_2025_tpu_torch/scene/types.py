"""Host-side scene representation (NumPy; no JAX).

Mirrors the reference's POD structs (``src/sceneStructs.h``) with SoA triangle
storage instead of the reference's AoS ``Triangle { Vertex v1,v2,v3; ... }``
(``src/sceneStructs.h:77-88``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


class GeomType(enum.IntEnum):
    # src/sceneStructs.h:11-15 (enum GeomType { SPHERE, CUBE })
    SPHERE = 0
    CUBE = 1


@dataclass
class Material:
    """Parity with ``Material`` (``src/sceneStructs.h:36-57``).

    ``specular{exponent,color}`` exists in the reference but is loaded nowhere
    (dead) and is intentionally omitted.  ``has_reflective``/``has_refractive``
    are floats-used-as-bools, kept as floats for parity with the > 0.0 tests
    in ``scatterRay`` (``src/interactions.cu:455-481``).
    """

    color: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    has_reflective: float = 0.0
    has_refractive: float = 0.0
    roughness: float = -1.0
    metallic: float = -1.0
    index_of_refraction: float = 0.0
    emittance: float = 0.0
    has_texture: bool = False
    texture_id: int = -1
    has_bump_map: bool = False
    bump_id: int = -1
    bump_scale: float = 0.5


@dataclass
class Geom:
    """Analytic primitive instance (``src/sceneStructs.h:24-34``)."""

    type: GeomType
    material_id: int
    translation: np.ndarray
    rotation: np.ndarray
    scale: np.ndarray
    transform: np.ndarray  # 4x4 float64
    inverse_transform: np.ndarray
    inv_transpose: np.ndarray


@dataclass
class TextureData:
    """RGBA8 texture (``src/sceneStructs.h:59-66``; stb forces RGBA,
    ``src/scene.cpp:370-377``)."""

    width: int
    height: int
    channels: int  # always 4 after load
    data: np.ndarray  # [H, W, 4] uint8


@dataclass
class Camera:
    """``Camera`` (``src/sceneStructs.h:103-117``)."""

    resolution: np.ndarray  # int (2,) [x, y]
    position: np.ndarray
    look_at: np.ndarray
    view: np.ndarray
    up: np.ndarray
    right: np.ndarray
    fov: np.ndarray  # (fovx, fovy) degrees
    pixel_length: np.ndarray  # (2,)
    aperture: float
    focal_dist: float


@dataclass
class RenderState:
    """``RenderState`` (``src/sceneStructs.h:119-126``)."""

    camera: Camera
    iterations: int
    trace_depth: int
    image_name: str


@dataclass
class HostScene:
    """``Scene`` public members (``src/scene.h:20-27``) in SoA form."""

    state: RenderState
    materials: List[Material]
    geoms: List[Geom]
    textures: List[TextureData]

    # Triangle soup (world-space baked, one entry per triangle):
    tri_positions: np.ndarray  # [T, 3, 3] float32 (v0, v1, v2)
    tri_normals: np.ndarray  # [T, 3, 3] float32 per-vertex normals
    tri_uvs: np.ndarray  # [T, 3, 2] float32
    tri_material_ids: np.ndarray  # [T] int32
    tri_centroids: np.ndarray  # [T, 3] float32
    tri_dpdu: np.ndarray  # [T, 3] float32
    tri_dpdv: np.ndarray  # [T, 3] float32

    # BVH (built at load when triangles exist; src/scene.cpp:221-223):
    bvh: Optional["object"] = None  # scene.bvh.BVH

    material_name_to_id: Dict[str, int] = field(default_factory=dict)

    @property
    def num_triangles(self) -> int:
        return int(self.tri_positions.shape[0])


def empty_triangle_arrays() -> dict:
    return dict(
        tri_positions=np.zeros((0, 3, 3), np.float32),
        tri_normals=np.zeros((0, 3, 3), np.float32),
        tri_uvs=np.zeros((0, 3, 2), np.float32),
        tri_material_ids=np.zeros((0,), np.int32),
        tri_centroids=np.zeros((0, 3), np.float32),
        tri_dpdu=np.zeros((0, 3), np.float32),
        tri_dpdv=np.zeros((0, 3), np.float32),
    )
