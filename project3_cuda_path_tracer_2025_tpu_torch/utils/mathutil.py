"""Host-side (NumPy) transform math with exact reference parity.

These run at scene-load time only; device math lives in ``utils.vec``.
"""

from __future__ import annotations

import math

import numpy as np

PI = 3.1415926535897932384626422832795028841971
TWO_PI = 6.2831853071795864769252867665590057683943
PI_OVER_FOUR = 0.78539816339744831
PI_OVER_TWO = 1.57079632679489662
INV_PI = 0.31830988618379067154
SQRT_OF_ONE_THIRD = 0.5773502691896257645091487805019574556476
BABY_EPSILON = 1e-5
LARGER_EPSILON = 1e-3


def translate(t) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    m[:3, 3] = t
    return m


def rotate_axis(angle_rad: float, axis) -> np.ndarray:
    """glm::rotate(mat4(1), angle, axis): Rodrigues rotation, 4x4."""
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    x, y, z = axis
    c = math.cos(angle_rad)
    s = math.sin(angle_rad)
    t = 1.0 - c
    r = np.array(
        [
            [t * x * x + c, t * x * y - s * z, t * x * z + s * y],
            [t * x * y + s * z, t * y * y + c, t * y * z - s * x],
            [t * x * z - s * y, t * y * z + s * x, t * z * z + c],
        ],
        dtype=np.float64,
    )
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = r
    return m


def scale(s) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def build_transformation_matrix(translation, rotation_deg, scale_vec) -> np.ndarray:
    """Parity with ``utilityCore::buildTransformationMatrix``
    (``src/utilities.cpp:85-93``): T * Rx * Ry * Rz * S with degree Euler
    angles applied in X, Y, Z order."""
    t = translate(translation)
    rx = rotate_axis(rotation_deg[0] * PI / 180.0, (1, 0, 0))
    ry = rotate_axis(rotation_deg[1] * PI / 180.0, (0, 1, 0))
    rz = rotate_axis(rotation_deg[2] * PI / 180.0, (0, 0, 1))
    s = scale(scale_vec)
    return t @ rx @ ry @ rz @ s


def inverse_transpose(m: np.ndarray) -> np.ndarray:
    """glm::inverseTranspose of a 4x4 (full 4x4 inverse-transpose)."""
    return np.linalg.inv(m).T


def normalize(v):
    v = np.asarray(v, dtype=np.float64)
    return v / np.linalg.norm(v)
