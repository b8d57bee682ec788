"""JSON scene loader.

Parity with ``Scene::loadFromJSON`` (``src/scene.cpp:47-224``), same schema so
every ``scenes/*.json`` of the reference loads unmodified.  Quirks kept or
deliberately handled:

* Unknown material ``TYPE`` silently becomes a black diffuse (reference falls
  through every branch leaving the zero-initialized ``Material``).
* ``Diffuse`` ignores a ``ROUGHNESS`` key (``cornell.json``'s
  "specular_white" is genuinely diffuse in the reference).
* Unknown object ``TYPE`` (not "cube"/"obj") becomes a SPHERE (reference
  ``else`` branch, ``src/scene.cpp:165-168``).
* A missing ``APERTURE`` key is undefined behavior in the reference (const
  ``operator[]`` on a missing key, e.g. ``scenes/sphere.json``); here it
  defaults to 0.0 (pinhole) with a warning.
* ``camera.right`` in the reference is computed from the not-yet-assigned
  ``view`` (``src/scene.cpp:209`` before ``:213``) -- garbage that is benign
  because the render camera is re-derived on the first frame
  (``src/main.cpp:423-444``).  We store the *correct* right vector at load
  and reproduce the re-derivation in ``scene.camera``.
"""

from __future__ import annotations

import json
import math
import os
import warnings
from typing import Optional

import numpy as np

from ..utils import mathutil
from .bvh import build_bvh
from .obj_loader import load_obj_triangles
from .textures import load_texture
from .types import (
    Camera,
    Geom,
    GeomType,
    HostScene,
    Material,
    RenderState,
    TextureData,
    empty_triangle_arrays,
)


def _vec3(x) -> np.ndarray:
    return np.asarray([float(x[0]), float(x[1]), float(x[2])], np.float64)


def load_scene(
    path: str,
    leaf_size: int = 4,
    native_bvh: bool = False,
    build_acceleration: bool = True,
) -> HostScene:
    """Load a reference-format JSON scene file."""
    if not path.endswith(".json"):
        raise ValueError(f"Couldn't read from {path} (expected .json)")
    with open(path, "r") as f:
        data = json.load(f)
    return scene_from_dict(data, os.path.dirname(path), leaf_size, native_bvh,
                           build_acceleration)


def scene_from_dict(
    data: dict,
    base_dir: str = ".",
    leaf_size: int = 4,
    native_bvh: bool = False,
    build_acceleration: bool = True,
) -> HostScene:
    """Build the scene from a reference-format document already in memory
    (what ``load_scene`` reads from a file); ``base_dir`` resolves the
    relative paths of its textures and OBJ files."""

    materials: list[Material] = []
    textures: list[TextureData] = []
    name_to_id: dict[str, int] = {}

    def _load_tex(rel: str) -> int:
        tex_path = os.path.join(base_dir, rel)
        tex = load_texture(tex_path)
        textures.append(tex)
        return len(textures) - 1

    for name, p in data["Materials"].items():
        m = Material()
        t = p["TYPE"]
        if t == "Diffuse":
            m.color = _vec3(p["RGB"])
        elif t == "Emitting":
            m.color = _vec3(p["RGB"])
            m.emittance = float(p["EMITTANCE"])
        elif t == "Glass":
            m.color = _vec3(p["RGB"])
            m.has_reflective = 1.0
            m.has_refractive = 1.0
            m.index_of_refraction = float(p["IOR"])
        elif t == "Reflective":
            m.color = _vec3(p["RGB"])
            m.has_reflective = 1.0
        elif t == "Transmissive":
            m.color = _vec3(p["RGB"])
            m.has_refractive = 1.0
            m.index_of_refraction = float(p["IOR"])
        elif t == "Microfacet":
            m.color = _vec3(p["RGB"])
            m.roughness = float(p["ROUGHNESS"])
            m.metallic = float(p["METALLIC"])
            m.index_of_refraction = float(p["IOR"])
        # else: unknown TYPE -> black diffuse (reference behavior)

        if "TEXTURE" in p:
            m.texture_id = _load_tex(p["TEXTURE"])
            m.has_texture = True
        if "BUMP_MAP" in p:
            m.bump_id = _load_tex(p["BUMP_MAP"])
            m.has_bump_map = True
            m.bump_scale = float(p["BUMP_SCALE"])

        name_to_id[name] = len(materials)
        materials.append(m)

    geoms: list[Geom] = []
    tri_arrays = empty_triangle_arrays()
    tri_parts = [tri_arrays]

    for p in data["Objects"]:
        t = p["TYPE"]
        if t == "obj":
            obj_path = os.path.join(base_dir, p["PATH"])
            mat = name_to_id.get(p["MATERIAL"], 0)
            trans = _vec3(p["TRANS"])
            rot = _vec3(p["ROTAT"])
            scl = _vec3(p["SCALE"])
            xform = mathutil.build_transformation_matrix(trans, rot, scl)
            inv_t = mathutil.inverse_transpose(xform)
            tri_parts.append(load_obj_triangles(obj_path, mat, xform, inv_t))
        else:
            gtype = GeomType.CUBE if t == "cube" else GeomType.SPHERE
            trans = _vec3(p["TRANS"])
            rot = _vec3(p["ROTAT"])
            scl = _vec3(p["SCALE"])
            xform = mathutil.build_transformation_matrix(trans, rot, scl)
            geoms.append(
                Geom(
                    type=gtype,
                    material_id=name_to_id.get(p["MATERIAL"], 0),
                    translation=trans,
                    rotation=rot,
                    scale=scl,
                    transform=xform,
                    inverse_transform=np.linalg.inv(xform),
                    inv_transpose=mathutil.inverse_transpose(xform),
                )
            )

    cam_data = data["Camera"]
    camera, state = _load_camera(cam_data)

    merged = {
        k: np.concatenate([part[k] for part in tri_parts], axis=0)
        for k in tri_arrays
    }

    scene = HostScene(
        state=state,
        materials=materials,
        geoms=geoms,
        textures=textures,
        material_name_to_id=name_to_id,
        **merged,
    )

    if build_acceleration and scene.num_triangles > 0:
        scene.bvh = build_bvh(
            scene.tri_positions,
            scene.tri_centroids,
            leaf_size=leaf_size,
            use_native=native_bvh,
        )
    return scene


def set_resolution(scene: HostScene, width: int, height: int) -> HostScene:
    """Override the render resolution, re-deriving fovx/pixelLength exactly
    as the loader does (``src/scene.cpp:203-211``)."""
    cam = scene.state.camera
    fovy = float(cam.fov[1])
    yscaled = math.tan(fovy * (mathutil.PI / 180.0))
    xscaled = (yscaled * width) / height
    fovx = (math.atan(xscaled) * 180.0) / mathutil.PI
    cam.resolution = np.asarray([width, height], np.int64)
    cam.fov = np.asarray([fovx, fovy], np.float64)
    cam.pixel_length = np.asarray(
        [2.0 * xscaled / float(width), 2.0 * yscaled / float(height)], np.float64
    )
    return scene


def _load_camera(cam_data: dict) -> tuple[Camera, RenderState]:
    """Camera derivation parity (``src/scene.cpp:184-218``)."""
    res = np.asarray(
        [int(cam_data["RES"][0]), int(cam_data["RES"][1])], np.int64
    )
    fovy = float(cam_data["FOVY"])
    position = _vec3(cam_data["EYE"])
    look_at = _vec3(cam_data["LOOKAT"])
    up = _vec3(cam_data["UP"])

    focal_dist = float(np.linalg.norm(look_at - position))
    if "APERTURE" in cam_data:
        aperture = float(cam_data["APERTURE"])
    else:
        warnings.warn(
            "Camera has no APERTURE key (undefined behavior in the reference"
            " loader); defaulting to 0.0 (pinhole)."
        )
        aperture = 0.0

    # Reference quirk: yscaled = tan(fovy_in_degrees -> radians) with NO /2,
    # i.e. FOVY acts as the half-angle (src/scene.cpp:204-207).
    yscaled = math.tan(fovy * (mathutil.PI / 180.0))
    xscaled = (yscaled * res[0]) / res[1]
    fovx = (math.atan(xscaled) * 180.0) / mathutil.PI
    pixel_length = np.asarray(
        [2.0 * xscaled / float(res[0]), 2.0 * yscaled / float(res[1])], np.float64
    )

    view = mathutil.normalize(look_at - position)
    right = mathutil.normalize(np.cross(view, up))

    camera = Camera(
        resolution=res,
        position=position,
        look_at=look_at,
        view=view,
        up=up,
        right=right,
        fov=np.asarray([fovx, fovy], np.float64),
        pixel_length=pixel_length,
        aperture=aperture,
        focal_dist=focal_dist,
    )
    state = RenderState(
        camera=camera,
        iterations=int(cam_data["ITERATIONS"]),
        trace_depth=int(cam_data["DEPTH"]),
        image_name=str(cam_data["FILE"]),
    )
    return camera, state
