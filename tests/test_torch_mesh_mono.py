"""The port's mesh intersectors against the JAX package's.

The mono traversal's plain version (what ``mono_intersect`` runs on CPU
tensors) is held against ``mesh_intersect_mxu(mono=True,
planned_epilogue="mono_force", interpret=True)``, the Pallas ``_mono_kernel``
in interpret mode (without ``mono_force`` the JAX package falls back to the
planned walk on the CPU).  Cases: a random 2,300-triangle mesh (3 tiles, the
last part padding) with finite t_limits and dead rays, and the camera rays
of ``scenes/cornell_mesh_5k.json`` at 16x16 with the prim t as t_limit,
each with ray sorting off and on.  The scene is built by the JAX package
(NumPy BVH construction) and carried across with ``from_jax_scene``, so both
sides see the same triangle ids.

Tolerance: ``tri`` equal on at least 99.9% of rays, ``t`` within 2 ulp
where ``tri`` agrees.  A last-ulp difference in a numerator could flip an
edge test; in practice none does: the port chains its numerators as fused
multiply-adds in ascending feature order, the order in which XLA's CPU
``jnp.dot`` accumulates, so ``t`` and ``tri`` come out bit-equal (first
diverging input: none).  The port's threaded walk and brute-force oracle
must find the same triangles as the JAX package's and as the port's mono
traversal.  Their ``t`` agree to ``rtol=1e-5`` and ``u`` to ``rtol=1e-4``:
XLA contracts multiply-adds in its elementwise Moller-Trumbore and the port
does not, and ``u`` is a dot product with ``o - v0``, whose terms are of the
scene's size (~10 units) and cancel.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_2025_tpu.config import RenderConfig as JConfig
from project3_cuda_path_tracer_2025_tpu.ops import camera as jcamera
from project3_cuda_path_tracer_2025_tpu.ops.intersect import mesh_intersect_brute as j_brute
from project3_cuda_path_tracer_2025_tpu.ops.intersect import mesh_intersect_bvh as j_bvh
from project3_cuda_path_tracer_2025_tpu.ops.intersect import prim_t_min as j_prim_t_min
from project3_cuda_path_tracer_2025_tpu.ops.intersect_mxu import mesh_intersect_mxu as j_mxu
from project3_cuda_path_tracer_2025_tpu.scene import build_device_scene as j_build
from project3_cuda_path_tracer_2025_tpu.scene import camera_state as j_camera_state
from project3_cuda_path_tracer_2025_tpu.scene import derive_render_camera as j_derive
from project3_cuda_path_tracer_2025_tpu.scene import load_scene as j_load
from project3_cuda_path_tracer_2025_tpu.scene import set_resolution as j_set_res
from project3_cuda_path_tracer_2025_tpu.utils import prng as jprng
from project3_cuda_path_tracer_2025_tpu.utils.vec import Vec3 as JVec3
from project3_cuda_path_tracer_2025_tpu_torch.ops import intersect_mxu as mxu
from project3_cuda_path_tracer_2025_tpu_torch.ops.intersect import (
    mesh_intersect_brute, mesh_intersect_bvh,
)
from project3_cuda_path_tracer_2025_tpu_torch.scene import from_jax_scene
from project3_cuda_path_tracer_2025_tpu_torch.utils.vec import Vec3
from tests.test_intersect import _random_mesh_scene

REPO = pathlib.Path(__file__).resolve().parent.parent
EPS = JConfig().baby_epsilon
TRI_SHARE = 0.999
MAX_ULP = 2


def _random_case():
    rng = np.random.default_rng(51)
    scene = _random_mesh_scene(rng, n_tris=2300)
    n = 700
    o = rng.normal(size=(n, 3))
    o = 3.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = rng.uniform(-0.8, 0.8, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    active = rng.random(n) > 0.3
    lim = np.where(rng.random(n) > 0.5, 3.4e38, 2.0).astype(np.float32)
    return j_build(scene), o.astype(np.float32), d.astype(np.float32), active, lim


def _camera_case():
    scene = j_set_res(j_load(str(REPO / "scenes" / "cornell_mesh_5k.json"),
                             native_bvh=False), 16, 16)
    jdev, jstatic = j_build(scene)
    cam = j_camera_state(j_derive(scene.state.camera))
    ik = jprng.iteration_key(jax.random.PRNGKey(0), jnp.int32(1))
    n = jstatic.pixel_count
    paths = jcamera.generate_camera_rays(
        cam, 16, 16, jstatic.trace_depth, jprng.uniforms(jprng.stage_key(ik, 0, 0), n, 4))
    lim = np.asarray(j_prim_t_min(jstatic, JConfig(), paths.origin, paths.direction))
    o = np.stack([np.asarray(c) for c in paths.origin], 1)
    d = np.stack([np.asarray(c) for c in paths.direction], 1)
    return (jdev, jstatic), o, d, np.ones(n, bool), lim


@pytest.fixture(scope="module", params=["random_2300", "cornell_mesh_5k_camera"])
def case(request):
    (jdev, jstatic), o, d, active, lim = (
        _random_case() if request.param == "random_2300" else _camera_case()
    )
    dev, static = from_jax_scene(jax.tree_util.tree_map(np.asarray, jdev), jstatic)
    j3 = lambda a: JVec3(*[jnp.asarray(a[:, i]) for i in range(3)])
    t3 = lambda a: Vec3(*[torch.from_numpy(a[:, i].copy()) for i in range(3)])
    return dict(
        jdev=jdev, jstatic=jstatic, dev=dev, static=static,
        j=(j3(o), j3(d), jnp.asarray(active), jnp.asarray(lim)),
        t=(t3(o), t3(d), torch.from_numpy(active.copy()), torch.from_numpy(lim.copy())),
    )


@pytest.fixture(scope="module")
def jax_mono(case):
    js = case["jstatic"]
    return j_mxu(
        case["jdev"].mxu_mesh, js.num_triangles, js.mxu_padded_tris, *case["j"], EPS,
        interpret=True, mesh_bounds=js.mesh_bounds, planned=True, mono=True,
        planned_epilogue="mono_force",
    )


def _assert_close_hits(got_t, got_tri, want_t, want_tri):
    want_t, want_tri = np.asarray(want_t), np.asarray(want_tri)
    got_t, got_tri = np.asarray(got_t), np.asarray(got_tri)
    same = got_tri == want_tri
    assert same.mean() >= TRI_SHARE, f"tri differs on {(~same).sum()} rays"
    ulp = np.abs(got_t.view(np.int32).astype(np.int64) - want_t.view(np.int32).astype(np.int64))
    assert ulp[same].max() <= MAX_ULP


@pytest.mark.parametrize("sort_mode", [None, "morton", "signature"])
def test_mono_plain_matches_jax(case, jax_mono, sort_mode):
    s = case["static"]
    got = mxu.mesh_intersect_mxu(
        case["dev"].mxu_mesh, s.num_triangles, s.mxu_padded_tris, *case["t"], EPS,
        sort_rays=sort_mode is not None, sort_mode=sort_mode or "morton",
        mesh_bounds=s.mesh_bounds, mono=True,
    )
    assert (np.asarray(jax_mono.tri) >= 0).sum() >= 10
    _assert_close_hits(got.t, got.tri, jax_mono.t, jax_mono.tri)
    hit = got.tri.numpy() >= 0
    np.testing.assert_allclose(got.u.numpy()[hit], np.asarray(jax_mono.u)[hit], atol=2e-5)
    np.testing.assert_allclose(got.v.numpy()[hit], np.asarray(jax_mono.v)[hit], atol=2e-5)
    inactive = ~case["t"][2].numpy()
    assert (got.tri.numpy()[inactive] == -1).all()


def test_threaded_and_brute_match_jax(case, jax_mono):
    args = (*case["t"], EPS)
    jargs = (*case["j"], EPS)
    mono_tri = np.asarray(jax_mono.tri)
    for port_fn, jax_fn in ((mesh_intersect_bvh, j_bvh), (mesh_intersect_brute, j_brute)):
        got = port_fn(case["dev"], case["static"], *args)
        want = jax_fn(case["jdev"], case["jstatic"], *jargs)
        np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
        np.testing.assert_array_equal(got.tri.numpy(), mono_tri)
        np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-5)
        hit = got.tri.numpy() >= 0
        np.testing.assert_allclose(got.u.numpy()[hit], np.asarray(want.u)[hit],
                                   rtol=1e-4, atol=1e-5)
