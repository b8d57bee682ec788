"""The port's native C++ BVH builder (``native/bvh_native.py`` over
``csrc/bvh_builder.cpp``) against the JAX package's.

* The same source and C ABI give the same tree: the port's arrays equal the
  JAX package's native arrays (``project3_cuda_path_tracer_2025_tpu.native
  .bvh_native.build``) exactly, on random triangles and on the 5k and 20k
  meshes.
* The tree's invariants (after the JAX package's
  ``tests/test_native_bvh.py``): pre-order numbering, leaves of at most
  ``leaf_size`` triangles, every triangle in exactly one leaf, node boxes
  holding their triangles; and the same closest hits through the threaded
  BVH walk as the NumPy tree.
* The loader, ``RenderConfig`` and ``Renderer`` default to the native build.
* No fallback: with the compiler unavailable or refusing the source,
  ``native_bvh=True`` raises and names the failure; the library is built
  into a build directory, never into the package.
"""

import pathlib

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_2025_tpu.native import bvh_native as j_native
from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer
from project3_cuda_path_tracer_2025_tpu_torch.native import bvh_native
from project3_cuda_path_tracer_2025_tpu_torch.ops.intersect import mesh_intersect_bvh
from project3_cuda_path_tracer_2025_tpu_torch.scene import (
    build_device_scene, load_scene, set_resolution,
)
from project3_cuda_path_tracer_2025_tpu_torch.scene import bvh as bvh_mod
from project3_cuda_path_tracer_2025_tpu_torch.utils.vec import Vec3

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "project3_cuda_path_tracer_2025_tpu_torch"
ARRAYS = ("aabb_min", "aabb_max", "left", "right", "start", "count", "tri_count",
          "tri_indices")


def _random_tris(rng, n):
    centers = rng.uniform(-1, 1, (n, 3))
    offs = rng.uniform(-0.2, 0.2, (n, 2, 3))
    pos = np.stack([centers, centers + offs[:, 0], centers + offs[:, 1]], axis=1)
    return pos.astype(np.float32), pos.mean(axis=1).astype(np.float32)


def _mesh_tris(name):
    s = load_scene(str(REPO / "scenes" / name), build_acceleration=False)
    return s.tri_positions, s.tri_centroids


CASES = {
    "random_500": lambda: _random_tris(np.random.default_rng(11), 500),
    "random_3001_clustered": lambda: tuple(
        a.round(1) for a in _random_tris(np.random.default_rng(3), 3001)),
    "cornell_mesh_5k": lambda: _mesh_tris("cornell_mesh_5k.json"),
    "cornell_mesh_20k": lambda: _mesh_tris("cornell_mesh_20k.json"),
}


@pytest.fixture(scope="module")
def jax_native():
    assert j_native.available(), "the JAX package's native builder did not build"
    return j_native


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("leaf", [4, 1])
def test_native_arrays_equal_jax(jax_native, case, leaf):
    verts, cents = CASES[case]()
    got = bvh_native.build(verts, cents, leaf)
    want = jax_native.build(verts, cents, leaf)
    assert set(got) == set(want) == set(ARRAYS)
    for k in ARRAYS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("leaf", [1, 4, 8])
def test_native_build_invariants(leaf):
    rng = np.random.default_rng(11)
    verts, cents = _random_tris(rng, 500)
    out = bvh_native.build(verts, cents, leaf)
    internal = out["left"] >= 0
    # pre-order: left child is parent + 1
    np.testing.assert_array_equal(out["left"][internal], np.nonzero(internal)[0] + 1)
    leaf_nodes = out["tri_count"] > 0
    assert out["tri_count"].max() <= leaf
    assert (internal ^ leaf_nodes).all()  # every node is exactly one of the two
    assert (out["right"][internal] > out["left"][internal]).all()
    assert (out["right"][~internal] == -1).all() and (out["start"][internal] == -1).all()
    assert sorted(out["tri_indices"].tolist()) == list(range(500))
    covered = np.zeros(500, np.int32)
    for i in np.nonzero(leaf_nodes)[0]:
        s, c = out["start"][i], out["tri_count"][i]
        covered[out["tri_indices"][s:s + c]] += 1
        tv = verts[out["tri_indices"][s:s + c]].reshape(-1, 3)
        assert (tv >= out["aabb_min"][i]).all() and (tv <= out["aabb_max"][i]).all()
    assert (covered == 1).all()
    # an internal node's box is the union of its children's
    for i in np.nonzero(internal)[0]:
        l, r = out["left"][i], out["right"][i]
        np.testing.assert_array_equal(
            out["aabb_min"][i], np.minimum(out["aabb_min"][l], out["aabb_min"][r]))
        np.testing.assert_array_equal(
            out["aabb_max"][i], np.maximum(out["aabb_max"][l], out["aabb_max"][r]))
    tree = bvh_mod._finish(out, leaf)
    assert tree.miss_link[0] == tree.num_nodes


def test_native_matches_numpy_closest_hits():
    """The native and the NumPy trees of the 5k mesh give every ray the same
    closest hit through the threaded BVH walk (triangle ids mapped back to
    the scene's order)."""
    path = str(REPO / "scenes" / "cornell_mesh_5k.json")
    rng = np.random.default_rng(12)
    n = 400
    scenes = [load_scene(path, native_bvh=native) for native in (True, False)]
    c = scenes[0].tri_centroids.mean(axis=0)
    o = rng.normal(size=(n, 3))
    o = c + 3.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = c + rng.uniform(-0.5, 0.5, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ro, rd = (Vec3(*(torch.tensor(a[:, i], dtype=torch.float32) for i in range(3)))
              for a in (o, d))
    hits = []
    for scene in scenes:
        dev, static = build_device_scene(scene, "cpu")
        mh = mesh_intersect_bvh(dev, static, ro, rd, torch.ones(n, dtype=torch.bool),
                                torch.full((n,), 3.4e38), 1e-5)
        tri = mh.tri.numpy()
        ids = np.where(tri >= 0, scene.bvh.tri_indices[np.clip(tri, 0, None)], -1)
        hits.append((mh.t.numpy(), ids, scene.bvh.tri_indices))
    (t_a, id_a, order_a), (t_b, id_b, order_b) = hits
    assert not np.array_equal(order_a, order_b)  # two different layouts
    assert (id_a >= 0).sum() > 100
    np.testing.assert_array_equal(id_a, id_b)
    np.testing.assert_array_equal(t_a, t_b)


def test_loader_defaults_to_native():
    path = str(REPO / "scenes" / "cornell_mesh_5k.json")
    assert RenderConfig().native_bvh is True
    scene = load_scene(path)
    native = bvh_native.build(scene.tri_positions, scene.tri_centroids, 4)
    np.testing.assert_array_equal(scene.bvh.tri_indices, native["tri_indices"])
    np.testing.assert_array_equal(scene.bvh.left, native["left"])
    numpy_tree = load_scene(path, native_bvh=False).bvh
    assert not np.array_equal(numpy_tree.tri_indices, scene.bvh.tri_indices)
    r = Renderer(path, RenderConfig(), device="cpu")
    np.testing.assert_array_equal(r.scene.bvh.tri_indices, native["tri_indices"])
    r = Renderer(path, RenderConfig(native_bvh=False), device="cpu")
    np.testing.assert_array_equal(r.scene.bvh.tri_indices, numpy_tree.tri_indices)


def test_library_builds_outside_the_package():
    lib = bvh_native.library_path()
    bvh_native.load()
    assert lib.is_file()
    assert REPO / "build" / "native" in lib.parents
    assert PKG not in lib.parents
    assert not list(PKG.rglob("*.so"))


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """A build directory of its own and no library loaded yet."""
    monkeypatch.setattr(bvh_native, "BUILD_ROOT", tmp_path / "native")
    bvh_native.load.cache_clear()
    yield tmp_path
    bvh_native.load.cache_clear()


def test_native_raises_without_a_compiler(fresh_build, monkeypatch):
    missing = str(fresh_build / "no-such-compiler")
    monkeypatch.setattr(bvh_native, "CXX", missing)
    path = str(REPO / "scenes" / "cornell_mesh_5k.json")
    with pytest.raises(bvh_native.NativeBuildError, match="could not be built") as e:
        load_scene(path, native_bvh=True)
    assert missing in str(e.value)
    # nothing half-built is left, and the NumPy build is what asks for it
    assert not list(fresh_build.rglob("*.so"))
    assert load_scene(path, native_bvh=False).bvh.num_nodes > 0


def test_native_raises_with_the_compilers_output(fresh_build, monkeypatch):
    monkeypatch.setattr(bvh_native, "CXX_FLAGS",
                        (*bvh_native.CXX_FLAGS, "-DPTT_BROKEN", "-include", "no_such_header.h"))
    with pytest.raises(bvh_native.NativeBuildError, match="no_such_header.h"):
        bvh_native.build(*_random_tris(np.random.default_rng(0), 10), 4)
    assert not list(fresh_build.rglob("*.so"))


def test_native_build_rejects_bad_input():
    verts, cents = _random_tris(np.random.default_rng(1), 10)
    with pytest.raises(ValueError):
        bvh_native.build(verts[:, :2], cents, 4)
    with pytest.raises(ValueError):
        bvh_native.build(verts, cents, 0)
    with pytest.raises(ValueError):
        bvh_native.build(verts[:0], cents[:0], 4)


def test_render_is_the_same_with_either_tree():
    """The 5k mesh at 16x16 on the CPU's threaded walk: the native and the
    NumPy trees give the same film bit for bit (closest hit is order
    independent)."""
    path = str(REPO / "scenes" / "cornell_mesh_5k.json")
    films = []
    for native in (True, False):
        scene = set_resolution(load_scene(path, native_bvh=native), 16, 16)
        scene.state.trace_depth = 3
        r = Renderer(scene, RenderConfig(native_bvh=native), device="cpu")
        r.step_many(2)
        films.append(torch.stack(list(r.film), 1).numpy())
    assert films[0].sum() > 0
    np.testing.assert_array_equal(films[0], films[1])
