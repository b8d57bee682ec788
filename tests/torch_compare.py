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
from torch_fixtures import TIE_TRIS, tie_mesh  # noqa: F401  (numpy only: the card's tests use them)

# The suite runs several worker processes on a few cores.  The port's tests
# use tensors of at most a few thousand lanes, where one intra-op thread is
# fastest, while a full pool per worker oversubscribes the cores and its
# spin-waits slow every small op by orders of magnitude.
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
ATOL_WORLD = ATOL * 10.0  # world-space points: terms of the scene's size
ILL_SHARE = 1e-3  # share of elements allowed outside (RTOL, ATOL)...
ILL_RTOL = 1e-4  # ...which must still agree to (ILL_RTOL, 10 * atol)


def build_host(tmp_path_factory, src, name, defines=()):
    """A test harness of ``tests/`` built with the host C++ compiler against
    the kernels' ``csrc/`` headers (no contraction, as nvcc's
    ``--fmad=false``; ``defines``: extra ``-D`` flags), loaded with ctypes;
    the test skips without a compiler."""
    import ctypes
    import shutil
    import subprocess

    import pytest

    from project3_cuda_path_tracer_2025_tpu_torch.ops import kernels

    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the kernel body for the host")
    out = tmp_path_factory.mktemp("host") / name
    subprocess.run(
        [cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC", *defines,
         "-I", str(kernels.CSRC), "-o", str(out), str(src)],
        check=True, capture_output=True, text=True,
    )
    return ctypes.CDLL(str(out))


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


# ---------------------------------------------------------------------------
# Mesh traversal cases shared by the tests of the larger-mesh walks
# ---------------------------------------------------------------------------

def sphere_rays(rng, n, center=(0.0, 0.0, 0.0)):
    """Rays from a sphere of radius 3 around ``center`` toward a box of
    half-size 0.8 around it (the JAX package's ``tests/test_intersect_mxu.py``
    rays): (origins, directions) float32 [n, 3]."""
    o = rng.normal(size=(n, 3))
    o = 3.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = rng.uniform(-0.8, 0.8, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (o + np.asarray(center)).astype(np.float32), d.astype(np.float32)


def mesh_tables_pair(pos):
    """The JAX package's MXU tables of ``pos`` (in this order, no BVH) and
    the port's copy of them: (jax tables, port tables)."""
    from project3_cuda_path_tracer_2025_tpu.ops.intersect_mxu import build_mxu_tables
    from project3_cuda_path_tracer_2025_tpu_torch.ops.intersect_mxu import tables_from_arrays

    t = pos.shape[0]
    nrm = np.zeros_like(pos)
    nrm[:] = [0.0, 0.0, 1.0]
    jt = build_mxu_tables(pos, nrm, np.zeros((t, 3, 2), np.float32),
                          np.zeros((t, 3), np.float32), np.zeros((t, 3), np.float32),
                          np.zeros((t,), np.int32))
    return jt, tables_from_arrays(*(np.asarray(getattr(jt, f)) for f in (
        "features", "tile_aabb", "attrs", "attrs_shade", "center")))


# ---------------------------------------------------------------------------
# Procedural texture fixtures (scenes/textures/*.bmp)
# ---------------------------------------------------------------------------

TEXTURE_SIZE = 256
TEXTURES = ("checker_albedo.bmp", "height_bumps.bmp")


def procedural_textures(seed: int = 0) -> dict:
    """The in-repo stand-ins for the reference's textures, made from
    ``seed``: file name -> [256, 256, 3] uint8 RGB (row 0 at the top).

    * ``checker_albedo.bmp``: a soft-edged 8 x 8 checker whose light
      squares carry a colour ramp (red across, green down) and whose dark
      squares are the ramp at a third, with a little seeded noise;
    * ``height_bumps.bmp``: a grey height map, a wrapped sum of seeded
      Gaussian bumps (height is the red channel; all three are equal)."""
    rng = np.random.default_rng(seed)
    s = TEXTURE_SIZE
    y, x = np.mgrid[0:s, 0:s].astype(np.float64) / (s - 1)
    ramp = np.stack([0.25 + 0.75 * x, 0.25 + 0.75 * y, 0.9 - 0.6 * x * y], axis=-1)
    # Soft-edged squares (the edge spans a few texels), so that the checker
    # used as its own bump map tilts normals smoothly.
    light = 0.5 + 0.5 * np.clip(2.0 * np.sin(4 * np.pi * x) * np.sin(4 * np.pi * y), -1, 1)
    albedo = ramp * (1.0 + 2.0 * light[..., None]) / 3.0 + rng.normal(0.0, 0.005, (s, s, 3))
    height = np.zeros((s, s))
    for cx, cy, r, a in zip(rng.random(24), rng.random(24), rng.uniform(0.06, 0.16, 24),
                            rng.uniform(0.3, 1.0, 24)):
        dx = np.minimum(np.abs(x - cx), 1.0 - np.abs(x - cx))  # wrapped distance
        dy = np.minimum(np.abs(y - cy), 1.0 - np.abs(y - cy))
        height += a * np.exp(-(dx * dx + dy * dy) / (2.0 * r * r))
    height /= height.max()
    u8 = lambda a: np.clip(np.round(a * 255.0), 0, 255).astype(np.uint8)
    return {
        "checker_albedo.bmp": u8(albedo),
        "height_bumps.bmp": u8(np.repeat(height[..., None], 3, axis=-1)),
    }


def bmp_bytes(rgb: np.ndarray) -> bytes:
    """An uncompressed 24-bit BMP of ``rgb`` [H, W, 3] uint8 (row 0 at the
    top; stored bottom-up, BGR, rows padded to 4 bytes), the form the
    loaders' own BMP reader takes."""
    import struct

    h, w, _ = rgb.shape
    stride = (w * 3 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : w * 3] = rgb[::-1, :, ::-1].reshape(h, w * 3)
    header = struct.pack("<2sIHHI", b"BM", 54 + rows.size, 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size, 2835, 2835, 0, 0)
    return header + info + rows.tobytes()


def never_hit_padded(jt, total_tiles: int, far: bool = False):
    """``jt`` (the JAX package's tables) grown to ``total_tiles`` tiles by
    all-zero feature columns (det == 0: no hit) under the inverted boxes of
    the JAX package's padding tiles, the synthetic tables of
    ``tests/test_intersect_mxu.py:126-135``.  An inverted box passes every
    slab test (its zero features are what never hit), so every ray
    evaluates it; ``far`` gives unit boxes 10,000 units away instead, which
    no ray of the tests enters.  Returns (the arrays ``_run`` of the JAX
    package takes first: features, tile_aabb, group_aabb, center; the
    port's tables of the same numpy arrays)."""
    from project3_cuda_path_tracer_2025_tpu_torch.ops.intersect_mxu import tables_from_arrays

    feat, aabb = np.asarray(jt.features), np.asarray(jt.tile_aabb)
    extra = total_tiles - aabb.shape[0]
    never = np.full((extra, 8), 1e30, np.float32)
    never[:, 3:6] = -1e30
    if far:
        never[:, 0:3], never[:, 3:6] = 1e4, 1e4 + 1.0
    feat = np.concatenate([feat, np.zeros((feat.shape[0], extra * 4 * 1024), np.float32)], 1)
    aabb = np.concatenate([aabb, never], 0)
    center = np.asarray(jt.center)
    return ((jnp.asarray(feat), jnp.asarray(aabb), jnp.asarray(aabb), jnp.asarray(center)),
            tables_from_arrays(feat, aabb, center=center))


def run_tables_both(jarrs, pt, num_tris, padded_tris, rays_j, rays_t, eps=1e-5, sort=False,
                    bounds=(0.0, 0.0, 0.0, 1.0, 1.0, 1.0), **flags):
    """The same traversal of the same table arrays in both packages: the JAX
    package's ``_run`` in interpret mode (``jarrs`` from ``never_hit_padded``
    or a tables' own arrays) -> (t, tri) numpy, and the port's
    ``mesh_intersect_mxu`` on its plain versions -> (t, tri) numpy."""
    from project3_cuda_path_tracer_2025_tpu.ops import intersect_mxu as jm
    from project3_cuda_path_tracer_2025_tpu_torch.ops import intersect_mxu as mxu

    ro, rd, active, lim = rays_j
    want = jm._run(*jarrs, ro.x, ro.y, ro.z, rd.x, rd.y, rd.z, active, lim,
                   num_tris=num_tris, padded_tris=padded_tris, baby_eps=eps, interpret=True,
                   sort_rays=sort, mesh_bounds=bounds, **flags)
    got = mxu.mesh_intersect_mxu(pt, num_tris, padded_tris, *rays_t, eps, sort_rays=sort,
                                 mesh_bounds=bounds, compute_uv=False, **flags)
    return (got.t.numpy(), got.tri.numpy()), tuple(np.asarray(a) for a in want)
