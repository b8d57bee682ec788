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
    jdev, jstatic = j_build(j_load(MESH5K, native_bvh=False))
    dev, static = build_device_scene(load_scene(MESH5K), "cpu")
    return dev, static, jdev, jstatic


def test_mesh_device_scene_matches_jax(mesh5k):
    dev, static, jdev, jstatic = mesh5k
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
    assert mxu.traversal_flags("auto", 8192) == dict(mono=True)
    for padded, mode in ((20480, "planned"), (81920, "streamed"), (204800, "binned")):
        assert mxu.resolve_traversal_mode("auto", padded) == mode
        with pytest.raises(NotImplementedError, match="Queue 2 #5-#10"):
            mxu.traversal_flags("auto", padded)
    with pytest.raises(NotImplementedError, match="Queue 2 #5-#10"):
        RenderConfig(mxu_traversal="planned")
    with pytest.raises(NotImplementedError, match="Queue 1: prefix tiers"):
        RenderConfig(bounce_prefix_tiers=(4, 2))
    with pytest.raises(NotImplementedError, match="do-not-port"):
        RenderConfig(mesh_state_order="pixel")
    assert RenderConfig(bounce_prefix_tiers=()).resolved_prefix_tiers() == ()


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_mesh_beyond_the_mono_band_raises(device):
    """cornell_mesh_20k.json: 20,480 triangles resolve to the planned walk,
    which is not ported; the Renderer refuses the scene before it builds
    anything, on any device."""
    scene = load_scene(str(REPO / "scenes" / "cornell_mesh_20k.json"))
    with pytest.raises(NotImplementedError, match="Queue 2 #5-#10"):
        Renderer(scene, device=device)
