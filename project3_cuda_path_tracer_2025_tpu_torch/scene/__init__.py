from .types import (
    Camera,
    Geom,
    GeomType,
    HostScene,
    Material,
    RenderState,
    TextureData,
)
from .loader import load_scene, set_resolution
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
    "set_resolution",
    "DeviceScene",
    "build_device_scene",
    "from_jax_scene",
    "derive_render_camera",
    "camera_state",
]
