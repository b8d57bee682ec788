from .types import (
    Camera,
    Geom,
    GeomType,
    HostScene,
    Material,
    RenderState,
    TextureData,
)
from .loader import load_scene, scene_from_dict, set_resolution
from .procedural import many_prims_scene
from .device import DeviceScene, build_device_scene, from_jax_scene
from .camera import derive_render_camera, camera_state

__all__ = [
    "Camera",
    "Geom",
    "GeomType",
    "HostScene",
    "Material",
    "RenderState",
    "TextureData",
    "load_scene",
    "scene_from_dict",
    "many_prims_scene",
    "set_resolution",
    "DeviceScene",
    "build_device_scene",
    "from_jax_scene",
    "derive_render_camera",
    "camera_state",
]
