"""The port's mesh tables, culls and sort keys against the JAX package's.

``build_device_scene`` must upload a mesh exactly as the JAX package does:
the MXU tables (features, tile boxes, attribute rows, recentring offset),
the leaf-ordered triangle arrays with the flat-normal fallback resolved,
the packed octant BVH, and the static ``mxu_padded_tris`` / ``mesh_bounds``.
Both sides build the scene's BVH with NumPy (the JAX package's
default is its C++ code, whose leaf order may differ).  The root cull
and every coherence key are integer or boolean results of the same float32
slab arithmetic, so they must be equal too.  No JAX kernel is compiled
here.
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_2025_tpu.ops import intersect_mxu as jmxu
from project3_cuda_path_tracer_2025_tpu.scene import build_device_scene as j_build
from project3_cuda_path_tracer_2025_tpu.scene import load_scene as j_load
from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer
from project3_cuda_path_tracer_2025_tpu_torch.ops import intersect_mxu as mxu
from project3_cuda_path_tracer_2025_tpu_torch.scene import (
    build_device_scene, from_jax_scene, load_scene,
)
from project3_cuda_path_tracer_2025_tpu_torch.utils.vec import Vec3
from tests.test_intersect import _random_mesh_scene

REPO = pathlib.Path(__file__).resolve().parent.parent
MESH5K = str(REPO / "scenes" / "cornell_mesh_5k.json")


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_tables_equal(dev, jdev):
    for f in ("features", "tile_aabb", "attrs", "attrs_shade", "center"):
        a, b = _np(getattr(dev.mxu_mesh, f)), np.asarray(getattr(jdev.mxu_mesh, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in dev.triangles._fields:
        a, b = getattr(dev.triangles, f), getattr(jdev.triangles, f)
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            np.testing.assert_array_equal(_np(x), np.asarray(y), err_msg=f)
    np.testing.assert_array_equal(_np(dev.bvh.nodes), np.asarray(jdev.bvh.nodes))
    np.testing.assert_array_equal(_np(dev.bvh.tris), np.asarray(jdev.bvh.tris))


@pytest.fixture(scope="module")
def mesh5k():
    # Both packages' NumPy BVH build (the port's default is the native one).
    jdev, jstatic = j_build(j_load(MESH5K, native_bvh=False))
    dev, static = build_device_scene(load_scene(MESH5K, native_bvh=False), "cpu")
    return dev, static, jdev, jstatic


@pytest.fixture(scope="module")
def mesh5k_native():
    """Both packages' native C++ BVH build: the same source, the same tree,
    so the same leaf order and tables."""
    jdev, jstatic = j_build(j_load(MESH5K, native_bvh=True))
    dev, static = build_device_scene(load_scene(MESH5K, native_bvh=True), "cpu")
    return dev, static, jdev, jstatic


@pytest.mark.parametrize("built", ["mesh5k", "mesh5k_native"])
def test_mesh_device_scene_matches_jax(built, request):
    dev, static, jdev, jstatic = request.getfixturevalue(built)
    fields = lambda st: {f.name: getattr(st, f.name) for f in dataclasses.fields(st)}
    assert fields(static) == fields(jstatic)
    assert (static.num_triangles, static.mxu_padded_tris) == (5120, 5120)
    assert static.mesh_bounds == jstatic.mesh_bounds
    _assert_tables_equal(dev, jdev)


def test_from_jax_scene_carries_the_mesh(mesh5k):
    dev, static, jdev, jstatic = mesh5k
    dev_a, static_a = from_jax_scene(jax.tree_util.tree_map(np.asarray, jdev), jstatic)
    assert static_a == static
    _assert_tables_equal(dev_a, jdev)
    assert torch.equal(dev_a.mxu_mesh.coef, dev.mxu_mesh.coef)


def test_from_jax_scene_carries_a_20k_mesh():
    """A mesh beyond the mono band (cornell_mesh_20k.json, 20 tiles) carries
    across too: the tables equal JAX's and the port's own build, and the
    tile plan over the carried tables equals the JAX package's plan."""
    path = str(REPO / "scenes" / "cornell_mesh_20k.json")
    jdev, jstatic = j_build(j_load(path, native_bvh=False))
    dev_a, static_a = from_jax_scene(jax.tree_util.tree_map(np.asarray, jdev), jstatic)
    dev, static = build_device_scene(load_scene(path, native_bvh=False), "cpu")
    assert static_a == static and static.mxu_padded_tris == 20 * 1024
    _assert_tables_equal(dev_a, jdev)
    assert torch.equal(dev_a.mxu_mesh.coef, dev.mxu_mesh.coef)
    rng = np.random.default_rng(8)
    tab, n = dev_a.mxu_mesh, 768
    o, d = _random_rays(rng, n, tab.center.numpy())
    live = rng.random(n) > 0.2
    lim = np.full(n, 3.4e38, np.float32)
    os_ = (o - tab.center.numpy()).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    plan = mxu.build_tile_plan(tab.tile_aabb, mxu.Vec3(*(t(os_[:, i]) for i in range(3))),
                               mxu.Vec3(*(t(d[:, i]) for i in range(3))), t(live), t(lim))
    one = live.astype(np.float32)
    want = jmxu._build_tile_plan(jdev.mxu_mesh.tile_aabb, jnp.asarray(os_ * one[:, None]),
                                 jnp.asarray(d * one[:, None]), jnp.asarray(one),
                                 jnp.asarray(lim))
    for a, b in zip(plan, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(plan.cnt.sum()) > 20


def test_random_mesh_tables_with_padding_and_flat_normals():
    """2,300 triangles (3 tiles, the last one part padding) with all-zero
    vertex normals, so every triangle takes the flat-normal fallback."""
    scene = _random_mesh_scene(np.random.default_rng(51), n_tris=2300)
    jdev, jstatic = j_build(scene)
    dev, static = build_device_scene(scene, "cpu")  # same fields as a port scene
    assert static.mxu_padded_tris == jstatic.mxu_padded_tris == 3072
    _assert_tables_equal(dev, jdev)
    # The kernel's coefficient rows are the feature columns, re-laid out.
    feat, coef = dev.mxu_mesh.features.numpy(), dev.mxu_mesh.coef.numpy()
    for tri in (0, 1023, 1024, 2299, 3071):
        c, j = divmod(tri, mxu.TRI_TILE)
        col = lambda q: c * 4 * mxu.TRI_TILE + q * mxu.TRI_TILE + j
        want = np.concatenate([feat[0:3, col(0)], feat[0:6, col(1)],
                               feat[0:6, col(2)], feat[6:10, col(3)], [0.0]])
        np.testing.assert_array_equal(coef[tri], want)


def _random_rays(rng, n, center):
    o = rng.normal(size=(n, 3))
    o = np.asarray(center, np.float64) + 3.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = rng.uniform(-0.8, 0.8, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::17, 0] = 0.0  # exact zero components take the 1e-20 guard
    return o.astype(np.float32), d.astype(np.float32)


def test_root_cull_and_sort_keys_match_jax():
    rng = np.random.default_rng(7)
    scene = _random_mesh_scene(rng, n_tris=2300)
    jdev, jstatic = j_build(scene)
    dev, static = build_device_scene(scene, "cpu")
    n = 900
    o, d = _random_rays(rng, n, [0.0, 0.0, 0.0])
    alive = rng.random(n) > 0.3
    lim = np.where(rng.random(n) > 0.5, 3.4e38, rng.uniform(1.0, 4.0, n)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    j = lambda a: jnp.asarray(np.ascontiguousarray(a))
    cols = lambda a, f: [f(a[:, i]) for i in range(3)]
    tab, jtab = dev.mxu_mesh, jdev.mxu_mesh

    root = mxu.root_hit_mask(tab.tile_aabb, tab.center, *cols(o, t), *cols(d, t), t(lim))
    jroot = jmxu.root_hit_mask(jtab.tile_aabb, jtab.center, *cols(o, j), *cols(d, j), j(lim))
    np.testing.assert_array_equal(root.numpy(), np.asarray(jroot))
    assert 0 < root.sum() < n

    c = tab.center.numpy()
    os_ = o - c
    live = (alive & root.numpy()).astype(np.float32)
    sig = mxu._signature_keys(tab.tile_aabb, *cols(os_, t), *cols(d, t), t(live), t(lim))
    jsig = jmxu._signature_keys(jtab.tile_aabb, *cols(os_, j), *cols(d, j), j(live), j(lim))
    np.testing.assert_array_equal(sig.numpy(), np.asarray(jsig))

    lo, hi = tab.tile_aabb[:, 0:3].min(0).values, tab.tile_aabb[:, 3:6].max(0).values
    mor = mxu._coherence_keys(*cols(os_, t), *cols(d, t), t(live), lo, hi, 2, 4)
    jmor = jmxu._coherence_keys(*cols(os_, j), *cols(d, j), j(live), j(lo.numpy()),
                                j(hi.numpy()), 2, 4)
    np.testing.assert_array_equal(mor.numpy(), np.asarray(jmor))

    planes = mxu.coherence_key_planes(tab.tile_aabb, *tab.center, *cols(o, t),
                                      *cols(d, t), t(alive), t(lim))
    jplanes = jmxu.coherence_key_planes(jtab.tile_aabb, *jtab.center, *cols(o, j),
                                        *cols(d, j), j(alive), j(lim))
    np.testing.assert_array_equal(planes.numpy(), np.asarray(jplanes))
    assert len(np.unique(planes.numpy())) > 10

    for mode in ("signature", "morton"):
        perm = mxu.coherence_perm(tab, mxu.Vec3(*cols(o, t)), mxu.Vec3(*cols(d, t)),
                                  t(alive), t(lim), 2, 4, mode=mode)
        jperm = jmxu.coherence_perm(jtab, jmxu.Vec3(*cols(o, j)), jmxu.Vec3(*cols(d, j)),
                                    j(alive), j(lim), 2, 4, mode=mode)
        np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))


def test_traversal_resolution():
    assert mxu.resolve_traversal_mode("auto", 5120) == "mono"
    assert mxu.traversal_flags("auto", 8192) == dict(planned=True, streamed=False, mono=True)
    for padded, mode in ((20480, "planned"), (81920, "streamed"), (204800, "binned")):
        assert mxu.resolve_traversal_mode("auto", padded) == mode
        assert mxu.traversal_flags("auto", padded) == jmxu.traversal_flags("auto", padded)
    for mode in ("planned", "streamed", "binned", "sweep"):
        assert RenderConfig(mxu_traversal=mode).mxu_traversal == mode
    assert mxu.traversal_flags("sweep", 20480) == jmxu.traversal_flags("sweep", 20480) \
        == dict(planned=False, streamed=False)
    with pytest.raises(ValueError):
        RenderConfig(mxu_traversal="bogus")
    # Prefix tiers are ported: any tuple builds, and "auto" resolves by the
    # JAX package's rule for the device.
    assert RenderConfig(bounce_prefix_tiers=[4, 2]).bounce_prefix_tiers == (4, 2)
    assert RenderConfig(bounce_prefix_tiers=(4, 2)).resolved_prefix_tiers("cpu") == (4, 2)
    with pytest.raises(NotImplementedError, match="do-not-port"):
        RenderConfig(mesh_state_order="pixel")
    with pytest.raises(NotImplementedError, match="do-not-port"):
        RenderConfig(mxu_plan="frustum")
    assert RenderConfig(bounce_prefix_tiers=()).resolved_prefix_tiers("cuda") == ()
    assert RenderConfig().resolved_prefix_tiers("cpu") == ()
    # "auto" runs none on the card either, unlike the JAX package's TPU rule
    assert RenderConfig().resolved_prefix_tiers(torch.device("cuda", 0)) == ()


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_mesh_beyond_the_mono_band_raises(device):
    """A mesh of more than 1,024 tiles (the streamed plan's capacity) was
    refused by a scene gate while the chunked chain was missing.  The gate
    is gone: the only thing a Renderer raises for before it builds anything
    is a CUDA device that is not there, and a table of 1,025 tiles goes
    through the traversal (the chain, ``tests/test_torch_mesh_chain.py``)."""
    import project3_cuda_path_tracer_2025_tpu_torch.scene as scene_pkg

    assert not hasattr(scene_pkg, "check_scene")
    scene = load_scene(str(REPO / "scenes" / "cornell_mesh_5k.json"))
    if device == "cuda" and not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            Renderer(scene, device=device)
        return
    dev, static = build_device_scene(scene, device)
    t = dev.mxu_mesh
    ct, big = t.tile_aabb.shape[0], 1025
    far = t.tile_aabb.new_tensor([1e4] * 3 + [1e4 + 1.0] * 3 + [0.0] * 2).expand(big - ct, 8)
    grown = mxu.tables_from_arrays(
        np.concatenate([t.features.cpu().numpy(),
                        np.zeros((mxu.NUM_F, (big - ct) * 4 * mxu.TRI_TILE), np.float32)], 1),
        torch.cat([t.tile_aabb, far]).cpu().numpy(), center=t.center.cpu().numpy(),
        device=device)
    rng, c = np.random.default_rng(5), t.center.cpu().numpy().astype(np.float64)
    o = rng.normal(size=(300, 3))
    o = c + 3.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = c + rng.uniform(-0.5, 0.5, (300, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    ro, rd = (Vec3(*(torch.tensor(a[:, i], device=device) for i in range(3))) for a in (o, d))
    args = (ro, rd, torch.ones(300, dtype=torch.bool, device=device),
            torch.full((300,), 3.4e38, device=device), 1e-5)
    got = mxu.mesh_intersect_mxu(grown, static.num_triangles, big * mxu.TRI_TILE, *args,
                                 compute_uv=False, planned=True, streamed=True)
    want = mxu.mesh_intersect_mxu(t, static.num_triangles, static.mxu_padded_tris, *args,
                                  compute_uv=False, planned=True)
    assert torch.equal(got.tri, want.tri) and torch.equal(got.t, want.t)
    assert (got.tri >= 0).sum() > 20
