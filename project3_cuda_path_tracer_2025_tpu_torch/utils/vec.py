"""SoA 3-vector math over torch tensors.

A 3-vector field over N rays is three flat ``[N]`` tensors rather than one
``[N, 3]`` tensor, the layout of the JAX package's ``utils/vec.py``: every
operation below is elementwise over the component tensors, so the same code
serves single vectors (0-dim tensors or Python floats) and ray batches.

Rounding rules that keep this module value-identical to the CUDA kernels in
``csrc/prim_path.cuh``:

* ``1.0 / t`` is ``reciprocal(t)``, correctly rounded on the CPU and on the
  card; a numerator other than 1.0 is never written as ``c / t``.
* ``normalize`` multiplies by ``1 / sqrt(.)`` and never calls ``rsqrt``
  (approximate on the card).
* Nothing here fuses a multiply into an add: no ``torch.lerp``,
  ``addcmul`` or ``addmm``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def f32(c: float) -> float:
    """Round a Python float to the nearest float32, as JAX does to a weakly
    typed constant that meets a float32 array."""
    return float(np.float32(c))


class Vec3(NamedTuple):
    """Structure-of-arrays 3-vector: three same-shape tensors (or scalars)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    # -- construction -----------------------------------------------------
    @staticmethod
    def zeros(shape, device="cpu", dtype=torch.float32) -> "Vec3":
        return Vec3(
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device),
        )

    # -- arithmetic --------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return Vec3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)


def dot(a: Vec3, b: Vec3) -> torch.Tensor:
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def length(a: Vec3) -> torch.Tensor:
    return torch.sqrt(dot(a, a))


def normalize(a: Vec3) -> Vec3:
    """glm::normalize semantics: no epsilon guard (0-vector -> nan/inf)."""
    inv = 1.0 / torch.sqrt(dot(a, a))
    return Vec3(a.x * inv, a.y * inv, a.z * inv)


def reflect(i: Vec3, n: Vec3) -> Vec3:
    """glm::reflect: I - 2*dot(N, I)*N."""
    d = dot(n, i)
    return i - n * (2.0 * d)


def refract(i: Vec3, n: Vec3, eta) -> Vec3:
    """glm::refract semantics: returns the zero vector on total internal
    reflection (k < 0), the TIR sentinel the reference relies on
    (``src/interactions.cu:159-165``)."""
    cosi = dot(n, i)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tir = k < 0.0
    kc = torch.sqrt(torch.clamp_min(k, 0.0))
    out = i * eta - n * (eta * cosi + kc)
    return Vec3(
        torch.where(tir, 0.0, out.x),
        torch.where(tir, 0.0, out.y),
        torch.where(tir, 0.0, out.z),
    )


def where(mask, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        torch.where(mask, a.x, b.x),
        torch.where(mask, a.y, b.y),
        torch.where(mask, a.z, b.z),
    )


def select_gather(v: Vec3, idx) -> Vec3:
    """Gather lanes: v[idx] per component."""
    return Vec3(v.x[idx], v.y[idx], v.z[idx])


def lerp(a: Vec3, b: Vec3, t) -> Vec3:
    """glm::mix(a, b, t) as a + (b - a) * t (two roundings, no fused op)."""
    return a + (b - a) * t


def max_component(v: Vec3) -> torch.Tensor:
    return torch.maximum(v.x, torch.maximum(v.y, v.z))


def _row_dot(coeffs, terms, bias=None):
    """sum(c * t) over Python-float constants ``c``, with the JAX package's
    trace-time folding (``utils/vec.py:169-194`` there), kept term for term:

    * a term whose coefficient is 0.0 is dropped;
    * a coefficient of +-1.0 passes the term through as +-t;
    * a 0.0 bias is dropped;
    * terms add left to right, starting from the first kept term;
    * every other constant is rounded to float32 before it multiplies.

    The folding is part of the result, not only a saving: ``0 * x`` adds a
    signed zero that can flip an exact-zero component's sign, and so the
    sign of ``1 / d`` in ``box_intersection``.
    """
    acc = None
    for c, t in zip(coeffs, terms):
        if c == 0.0:
            continue
        term = t if c == 1.0 else (-t if c == -1.0 else t * f32(c))
        acc = term if acc is None else acc + term
    if bias is not None and bias != 0.0:
        acc = f32(bias) if acc is None else acc + f32(bias)
    if acc is None:
        acc = torch.zeros_like(terms[0])
    return acc


def transform_point(m, p: Vec3) -> Vec3:
    """Apply a 4x4 row-major matrix of Python-float constants to a point:
    ``multiplyMV(m, vec4(p, 1))`` (``src/intersections.h:37-40``)."""
    xyz = (p.x, p.y, p.z)
    return Vec3(
        _row_dot(m[0][:3], xyz, m[0][3]),
        _row_dot(m[1][:3], xyz, m[1][3]),
        _row_dot(m[2][:3], xyz, m[2][3]),
    )


def transform_vector(m, v: Vec3) -> Vec3:
    """Apply a 4x4 matrix to a direction (w = 0): multiplyMV(m, vec4(v, 0))."""
    xyz = (v.x, v.y, v.z)
    return Vec3(
        _row_dot(m[0][:3], xyz),
        _row_dot(m[1][:3], xyz),
        _row_dot(m[2][:3], xyz),
    )
