"""Render-camera derivation and the camera parameters a step reads.

The reference never renders with the camera exactly as loaded: ``camchanged``
starts true, so the first ``runCuda`` re-derives position/view/up/right from
spherical coordinates (phi, theta, zoom) around LOOKAT
(``src/main.cpp:36,366-380,423-444``).  All shipped renders therefore use the
*reconstructed* camera.  ``derive_render_camera`` reproduces that math
exactly, including its quirks:

* phi/theta come from ``acos`` of axis-projected view directions, which drops
  the sign of ``view.x`` (off-axis eyes mirror) -- kept verbatim;
* the re-derived ``right``/``up`` are **not normalized** (``r = cross(v, u)``
  with u = (0,1,0) hardcoded, ``src/main.cpp:432-435``);
* ``focalDist`` is reset to |lookAt - position| = zoom (``src/main.cpp:444``).

The orbit-camera controls (mouse drag -> dphi/dtheta/zoom,
``src/main.cpp:516-555``) are exposed via ``orbit``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..utils import mathutil
from .types import Camera


@dataclass
class OrbitState:
    """Spherical-coordinate camera rig state (``src/main.cpp:40-42``)."""

    phi: float
    theta: float
    zoom: float
    look_at: np.ndarray
    og_look_at: np.ndarray

    @staticmethod
    def from_camera(cam: Camera) -> "OrbitState":
        # src/main.cpp:366-380
        view = mathutil.normalize(cam.look_at - cam.position)
        view_xz = np.array([view[0], 0.0, view[2]])
        view_zy = np.array([0.0, view[1], view[2]])
        phi = math.acos(
            float(np.clip(np.dot(mathutil.normalize(view_xz), [0, 0, -1]), -1, 1))
        )
        theta = math.acos(
            float(np.clip(np.dot(mathutil.normalize(view_zy), [0, 1, 0]), -1, 1))
        )
        zoom = float(np.linalg.norm(cam.position - cam.look_at))
        return OrbitState(
            phi=phi,
            theta=theta,
            zoom=zoom,
            look_at=cam.look_at.copy(),
            og_look_at=cam.look_at.copy(),
        )

    def orbit(self, dphi: float = 0.0, dtheta: float = 0.0, dzoom: float = 0.0):
        """Mouse-drag orbit/zoom parity (``src/main.cpp:526-534``)."""
        self.phi -= dphi
        self.theta = min(max(0.001, self.theta - dtheta), mathutil.PI)
        self.zoom = max(0.1, self.zoom + dzoom)


def derive_render_camera(cam: Camera, orbit: OrbitState | None = None) -> Camera:
    """The camera actually used for rendering (``src/main.cpp:423-444``)."""
    o = orbit if orbit is not None else OrbitState.from_camera(cam)
    pos_rel = np.array(
        [
            o.zoom * math.sin(o.phi) * math.sin(o.theta),
            o.zoom * math.cos(o.theta),
            o.zoom * math.cos(o.phi) * math.sin(o.theta),
        ]
    )
    view = -mathutil.normalize(pos_rel)
    u = np.array([0.0, 1.0, 0.0])
    r = np.cross(view, u)  # NOT normalized (reference quirk)
    up = np.cross(r, view)
    position = pos_rel + o.look_at
    focal_dist = float(np.linalg.norm(o.look_at - position))
    return Camera(
        resolution=cam.resolution,
        position=position,
        look_at=o.look_at.copy(),
        view=view,
        up=up,
        right=r,
        fov=cam.fov,
        pixel_length=cam.pixel_length,
        aperture=cam.aperture,
        focal_dist=focal_dist,
    )


class CameraState(NamedTuple):
    """Camera parameters as float32 tensors, read at every step: an orbit or
    a DoF edit changes them and rebuilds nothing.  They stay on the CPU:
    the unfused path uses them as scalars and the kernels take them by
    value, so the card never has to send them back."""

    position: torch.Tensor  # [3]
    view: torch.Tensor  # [3]
    up: torch.Tensor  # [3]
    right: torch.Tensor  # [3]
    pixel_length: torch.Tensor  # [2]
    aperture: torch.Tensor  # scalar
    focal_dist: torch.Tensor  # scalar


def camera_state(cam: Camera) -> CameraState:
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    return CameraState(
        position=f32(cam.position),
        view=f32(cam.view),
        up=f32(cam.up),
        right=f32(cam.right),
        pixel_length=f32(cam.pixel_length),
        aperture=f32(cam.aperture),
        focal_dist=f32(cam.focal_dist),
    )
