"""Camera ray generation: stochastic-AA jitter + thin-lens depth of field.

Parity with ``generateRayFromCamera`` (``src/pathtrace.cu:247-292``) and
``sampleAperture`` (``:231-237``), including the reference quirk that the
aperture offset is applied in *world* axes (x, y, 0), not the lens plane.
The same arithmetic, in the same order, is ``raygen`` in
``csrc/prim_path.cuh``.
"""

from __future__ import annotations

import torch

from ..scene.camera import CameraState
from ..utils import vec
from ..utils.mathutil import TWO_PI
from ..utils.vec import Vec3
from .rays import PathState


def camera_floats(cam: CameraState) -> dict:
    """The camera as Python floats holding float32 values."""
    v = lambda t: [float(x) for x in t.reshape(-1)]
    return dict(
        position=v(cam.position), view=v(cam.view), up=v(cam.up),
        right=v(cam.right), pixel_length=v(cam.pixel_length),
        aperture=float(cam.aperture), focal_dist=float(cam.focal_dist),
    )


def generate_camera_rays(
    cam: CameraState,
    width: int,
    height: int,
    trace_depth: int,
    uniforms: torch.Tensor,  # [4, N] U[0,1)
    idx: torch.Tensor | None = None,  # global pixel ids (default: all W*H)
) -> PathState:
    device = uniforms.device
    if idx is None:
        idx = torch.arange(width * height, dtype=torch.int32, device=device)
    n = idx.shape[0]
    x = (idx % width).to(torch.float32)
    y = torch.div(idx, width, rounding_mode="floor").to(torch.float32)
    c = camera_floats(cam)
    view, right, up, position = (
        Vec3(*c["view"]), Vec3(*c["right"]), Vec3(*c["up"]), Vec3(*c["position"])
    )

    sx = c["pixel_length"][0] * (x + uniforms[0] - width * 0.5)
    sy = c["pixel_length"][1] * (y + uniforms[1] - height * 0.5)
    pixel_point = Vec3(
        view.x - right.x * sx - up.x * sy,
        view.y - right.y * sx - up.y * sy,
        view.z - right.z * sx - up.z * sy,
    )
    ray_dir = vec.normalize(pixel_point)

    focal_point = Vec3(
        position.x + ray_dir.x * c["focal_dist"],
        position.y + ray_dir.y * c["focal_dist"],
        position.z + ray_dir.z * c["focal_dist"],
    )

    # Thin-lens aperture sample: uniform disk via sqrt(r), offset applied in
    # world x/y (reference quirk, src/pathtrace.cu:231-237,282-285); the z
    # offset is +0, so origin.z is position.z exactly.
    r = c["aperture"] * torch.sqrt(uniforms[2])
    theta = TWO_PI * uniforms[3]
    origin = Vec3(
        position.x + r * torch.cos(theta),
        position.y + r * torch.sin(theta),
        torch.full((n,), position.z, dtype=torch.float32, device=device),
    )
    direction = vec.normalize(focal_point - origin)

    one = torch.ones((n,), dtype=torch.float32, device=device)
    return PathState(
        origin=origin,
        direction=direction,
        color=Vec3(one, one.clone(), one.clone()),
        pixel=idx,
        bounces=torch.full((n,), trace_depth, dtype=torch.int32, device=device),
    )
