"""Comparison helpers shared by the port's tests against the JAX package.

Tolerance: floats agree to ``rtol=1e-5, atol=1e-6``.  sqrt and division are
correctly rounded in torch, but not everything in JAX on the CPU is: XLA's
``rsqrt`` (inside ``normalize``) differs from a correctly rounded ``1/sqrt``
by an ulp on about a third of float32 inputs (measured), XLA contracts
multiply-adds, and cos/sin come from XLA's approximations there and from
SLEEF in torch.  So the last bit or two can differ, and on the few lanes
where a stage is ill-conditioned (cancellation in a transformed point, a
grazing refraction) those bits grow: at most 0.1% of the elements may fall
outside the tolerance, and those must still agree to ``rtol=1e-4,
atol=1e-5``.  A world-space point (a hit point, a new ray origin) is a sum
of terms of the scene's size (~10 units) that may cancel, so its ``atol`` is
scaled by that size.  Integer and boolean outputs must be equal.
"""

import jax.numpy as jnp
import numpy as np
import torch

from project3_cuda_path_tracer_2025_tpu.utils.vec import Vec3 as JVec3
from project3_cuda_path_tracer_2025_tpu_torch.utils.vec import Vec3

# The suite runs several worker processes on a few cores.  The port's tests
# use tensors of at most a few thousand lanes, where one intra-op thread is
# fastest, while a full pool per worker oversubscribes the cores and its
# spin-waits slow every small op by orders of magnitude.
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
ATOL_WORLD = ATOL * 10.0  # world-space points: terms of the scene's size
ILL_SHARE = 1e-3  # share of elements allowed outside (RTOL, ATOL)...
ILL_RTOL = 1e-4  # ...which must still agree to (ILL_RTOL, 10 * atol)


def close(got, want, mask=None, atol=ATOL, share=ILL_SHARE, ill_rtol=ILL_RTOL):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    g, w = np.broadcast_to(g, w.shape), w
    lanes = w.size  # the allowance counts every lane, masked or not
    if mask is not None:
        g, w = g[mask], w[mask]
    if g.dtype == np.bool_ or np.issubdtype(g.dtype, np.integer):
        np.testing.assert_array_equal(g, w)
        return
    outside = ~np.isclose(g, w, rtol=RTOL, atol=atol, equal_nan=True)
    assert outside.sum() <= max(1, share * lanes), (
        f"{outside.sum()} of {g.size} elements outside rtol={RTOL} atol={atol}"
    )
    # Outliers: both tolerances scaled by ill_rtol / RTOL.
    np.testing.assert_allclose(g, w, rtol=ill_rtol, atol=atol * ill_rtol / RTOL)


def close3(got, want, mask=None, atol=ATOL, share=ILL_SHARE, ill_rtol=ILL_RTOL):
    for a, b in zip(got, want):
        close(a, b, mask, atol, share, ill_rtol)


def pair(a):
    """numpy [3, n] -> (port Vec3, JAX Vec3)."""
    a = np.ascontiguousarray(a, np.float32)
    return (Vec3(*[torch.from_numpy(a[i].copy()) for i in range(3)]),
            JVec3(*[jnp.asarray(a[i]) for i in range(3)]))


def pair1(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.copy()), jnp.asarray(a)


def unit(rng, n):
    v = rng.normal(size=(3, n))
    return (v / np.linalg.norm(v, axis=0)).astype(np.float32)


# Films: the goldens' tolerance (tests/test_goldens.py) on every pixel, and
# film sums within 1e-4 relative.  A last-bit difference in one stage could
# fork a path (a hit at a silhouette, a lobe choice) and move one pixel far;
# none does on the scenes and sizes the tests use.
FILM_RTOL, FILM_ATOL = 2e-4, 2e-5
FILM_SUM_RTOL = 1e-4


def assert_films_close(got, want):
    """``got``/``want``: [N, 3] float32 films (numpy)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=FILM_RTOL, atol=FILM_ATOL)
    np.testing.assert_allclose(got.sum(), want.sum(), rtol=FILM_SUM_RTOL)
