"""The prim kernels beyond their old capacity: a scene of 40 primitives and
40 materials at depth 80 (``scene.many_prims_scene``: the Cornell box of
``scenes/cornell_dof.json`` filled with a grid of spheres and cubes), where
the kernels once refused more than 32 primitives, 32 materials or depth 64.

The same JSON document goes to both packages' loaders.  The port's plain
bounce (what the kernels' wrappers run on CPU tensors) is held to the JAX
package's unfused bounce (``intersect_scene`` + ``shade``, what its
``megakernel_iteration`` runs on the CPU) stage by stage, from identical
inputs, over the first 16 bounces at 32x32, to the stage bars of
``tests/test_torch_fused.py`` (``rtol=1e-5, atol=1e-6``; integers equal)
with wider allowances, 2% of the lanes outside and those held to
``rtol=1e-2, atol=1e-3``: a third of this scene's 34 small objects are glass
or microfacet, so more lanes are ill-conditioned than in that file's scene
(measured over 16 bounces: 12 of 1,024 lanes outside at one bounce, the
farthest a grazing refraction whose direction differs by 5.7e-4 of its unit
length).  The whole iteration is
compared more loosely, and says why: a path's last-bit differences (XLA's
rsqrt, cos/sin) grow bounce by bounce among the mirrors until the path takes
another object, so a few paths end elsewhere (measured at 32x32: alive counts
differ by 2 at most, one pixel of 1,024 outside the film tolerance, film sums
4e-5 apart): alive counts within 2 at every depth, at most 3 pixels outside
the film tolerance, film sums within 1e-3.  The host-built per-ray body of the kernels is held to the
plain version (``rtol=1e-5, atol=1e-6``, one lane in a thousand to ``rtol=1e-4,
atol=1e-5``; films to the film bars), and
``from_jax_scene`` carries the JAX scene across unchanged.
"""

import ctypes
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_2025_tpu.config import RenderConfig as JConfig
from project3_cuda_path_tracer_2025_tpu.models.megakernel import megakernel_iteration as j_iter
from project3_cuda_path_tracer_2025_tpu.ops import camera as jcamera
from project3_cuda_path_tracer_2025_tpu.ops import shade as jshade
from project3_cuda_path_tracer_2025_tpu.ops.intersect import intersect_scene as j_intersect
from project3_cuda_path_tracer_2025_tpu.scene import build_device_scene as j_build
from project3_cuda_path_tracer_2025_tpu.scene import camera_state as j_camera_state
from project3_cuda_path_tracer_2025_tpu.scene import derive_render_camera as j_derive
from project3_cuda_path_tracer_2025_tpu.scene import load_scene as j_load
from project3_cuda_path_tracer_2025_tpu.scene import set_resolution as j_set_res
from project3_cuda_path_tracer_2025_tpu.utils import prng as jprng
from project3_cuda_path_tracer_2025_tpu.utils.vec import Vec3 as JVec3
from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer
from project3_cuda_path_tracer_2025_tpu_torch.ops import camera as camera_ops
from project3_cuda_path_tracer_2025_tpu_torch.ops import film as film_ops
from project3_cuda_path_tracer_2025_tpu_torch.ops import fused, kernels
from project3_cuda_path_tracer_2025_tpu_torch.ops.intersect import intersect_scene as p_intersect
from project3_cuda_path_tracer_2025_tpu_torch.scene import (
    build_device_scene, camera_state, derive_render_camera, from_jax_scene, many_prims_scene,
    scene_from_dict, set_resolution,
)
from project3_cuda_path_tracer_2025_tpu_torch.utils import prng
from test_torch_kernel_body import _ptrs, host_lib  # noqa: F401  (the fixture)
from test_torch_fused import BOUNCE_ILL_RTOL, BOUNCE_SHARE, _to_port
from torch_compare import ATOL_WORLD, FILM_ATOL, FILM_RTOL, assert_films_close, close, close3

REPO = pathlib.Path(__file__).resolve().parent.parent
BASE = str(REPO / "scenes" / "cornell_dof.json")
PRIMS, MATERIALS, DEPTH, RES = 40, 40, 80, 32


@pytest.fixture(scope="module")
def doc():
    return many_prims_scene(BASE, PRIMS, MATERIALS, depth=DEPTH)


@pytest.fixture(scope="module")
def port(doc):
    scene = set_resolution(scene_from_dict(doc), RES, RES)
    _, static = build_device_scene(scene, "cpu")
    return scene, static, camera_state(derive_render_camera(scene.state.camera))


def test_generated_scene_is_beyond_the_old_capacity(port, doc):
    _, static, _ = port
    assert (len(static.geoms), static.num_materials, static.trace_depth) == (40, 40, 80)
    assert len(doc["Objects"]) > 32 and len(doc["Materials"]) > 32
    kinds = {m["TYPE"] for m in doc["Materials"].values()}
    assert {"Diffuse", "Emitting", "Reflective", "Glass", "Microfacet"} <= kinds
    # Deterministic: the same document every time.
    assert many_prims_scene(BASE, PRIMS, MATERIALS, depth=DEPTH) == doc


def test_old_capacity_gates_are_gone(port):
    """No MAX_GEOMS / MAX_MATERIALS / MAX_DEPTH is left, the scene struct
    holds counts and two pointers, and building it for 40 primitives and 40
    materials raises nothing."""
    _, static, _ = port
    for name in ("MAX_GEOMS", "MAX_MATERIALS", "MAX_DEPTH"):
        assert not hasattr(kernels, name)
    assert ctypes.sizeof(kernels.PttScene) == 10 * 4 + 2 * ctypes.sizeof(ctypes.c_void_p)
    s = fused.scene_struct(static, RenderConfig())
    assert (s.num_geoms, s.num_materials) == (40, 40)
    geoms = ctypes.cast(s.geoms, ctypes.POINTER(kernels.PttGeom))
    mats = ctypes.cast(s.materials, ctypes.POINTER(kernels.PttMaterial))
    assert geoms[39].material_id == static.geoms[39].material_id
    assert mats[39].color[0] == pytest.approx(static.material_consts[39].color[0])
    for src in ("prim_path.cuh", "fused_prim.cu", "fused_mesh.cu"):
        text = (kernels.CSRC / src).read_text()
        assert "PTT_MAX_GEOMS" not in text and "PTT_MAX_DEPTH" not in text


def _assert_iterations_agree(got, alive, want, want_alive):
    """Whole iterations of this scene: alive counts within 2 at every depth,
    at most 3 pixels outside the film tolerance, film sums within 1e-3."""
    assert np.abs(alive.astype(np.int64) - want_alive.astype(np.int64)).max() <= 2
    assert np.isfinite(got).all()
    outside = ~np.isclose(got, want, rtol=FILM_RTOL, atol=FILM_ATOL)
    assert outside.any(axis=1).sum() <= 3
    np.testing.assert_allclose(got.sum(), want.sum(), rtol=1e-3)


@pytest.fixture(scope="module")
def jax_side(doc, tmp_path_factory):
    path = tmp_path_factory.mktemp("scene") / "many_prims.json"
    path.write_text(json.dumps(doc))
    jscene = j_set_res(j_load(str(path)), RES, RES)
    jdev, jstatic = j_build(jscene)
    return jdev, jstatic, j_camera_state(j_derive(jscene.state.camera))


def test_plain_bounce_matches_jax_stage_by_stage(port, jax_side):
    _, static, _ = port
    jdev, jstatic, jcam = jax_side
    n, jcfg = RES * RES, JConfig(fused_bounce="off")
    ik = jprng.iteration_key(jax.random.PRNGKey(0), jnp.int32(1))
    jpaths = jcamera.generate_camera_rays(
        jcam, RES, RES, DEPTH, jprng.uniforms(jprng.stage_key(ik, 0, 0), n, 4))
    loose = dict(share=2 * BOUNCE_SHARE, ill_rtol=10 * BOUNCE_ILL_RTOL)
    materials = set()
    for d in range(16):
        u = jprng.uniforms(jprng.stage_key(ik, d, 1), n, 3)
        jisect = j_intersect(jdev, jstatic, jpaths, jcfg)
        want = jshade.shade(jdev, jstatic, jpaths, jisect, u, jcfg)
        got = fused.fused_prim_bounce(static, RenderConfig(), _to_port(jpaths),
                                      torch.from_numpy(np.array(u)))
        close(got.bounces, want.bounces)
        close3(got.origin, want.origin, atol=ATOL_WORLD, **loose)
        close3(got.direction, want.direction, **loose)
        close3(got.color, want.color, **loose)
        hit = np.asarray(jisect.t) > 0
        materials |= set(np.asarray(jisect.material_id)[hit & (np.asarray(jpaths.bounces) > 0)])
        jpaths = want  # identical inputs for the next bounce
    assert max(materials) >= 32 and len(materials) >= 20  # the tables' far end is read


def test_plain_iteration_matches_jax_megakernel(port, jax_side):
    _, static, cam = port
    jdev, jstatic, jcam = jax_side
    n = RES * RES
    z = jnp.zeros(n, jnp.float32)
    jfilm, jalive = j_iter(jdev, jstatic, JConfig(fused_bounce="off"), jcam, JVec3(z, z, z),
                           jnp.int32(1), jax.random.PRNGKey(0))
    before = fused.fused_prim_iteration.launches
    film, alive = fused.fused_prim_iteration(static, RenderConfig(), cam, film_ops.new_film(n), 1,
                                             prng.prng_key(0))
    assert fused.fused_prim_iteration.launches == before  # CPU tensors: the plain version
    assert alive.shape == (DEPTH,)
    assert int((alive > 0).sum()) > 8  # paths live on among the mirrors and glass
    _assert_iterations_agree(torch.stack(list(film), 1).numpy(), alive.numpy(),
                             np.stack(jfilm, 1), np.asarray(jalive))

    # from_jax_scene carries the JAX scene across: the same statics, the same film.
    _, carried = from_jax_scene(jax.tree_util.tree_map(np.asarray, jdev), jstatic)
    assert len(carried.geoms) == 40 and carried.num_materials == 40
    film_c, alive_c = fused.fused_prim_iteration(carried, RenderConfig(), cam,
                                                 film_ops.new_film(n), 1, prng.prng_key(0))
    assert torch.equal(alive_c, alive)
    for a, b in zip(film_c, film):
        assert torch.equal(a, b)


def test_host_body_matches_plain_at_40_prims_depth_80(host_lib, port):  # noqa: F811
    """The kernels' per-ray body, built for the host, reads the primitive
    and material tables through the scene's pointers and derives the shade
    key of any depth from the iteration key: bounce and iteration against the
    plain versions."""
    _, static, cam = port
    cfg = RenderConfig()
    n = static.pixel_count
    scene = fused.scene_struct(static, cfg)
    idx = torch.arange(n, dtype=torch.int32)
    ik = prng.iteration_key(prng.prng_key(0), 1)
    paths = camera_ops.generate_camera_rays(
        cam, static.width, static.height, static.trace_depth,
        prng.uniforms_at(prng.stage_key(ik, 0, 0), idx, 4, n), idx=idx)
    for d in range(3):
        su = prng.uniforms_at(prng.stage_key(ik, d, 1), idx, 3, n)
        want = fused.fused_prim_bounce_plain(static, cfg, paths, su)
        f_out = [torch.empty(n) for _ in range(9)]
        b_out = torch.empty(n, dtype=torch.int32)
        host_lib.ptt_host_bounce(
            ctypes.byref(scene), _ptrs([*paths.origin, *paths.direction, *paths.color]),
            paths.bounces.data_ptr(), su.contiguous().data_ptr(), _ptrs(f_out),
            b_out.data_ptr(), n)
        np.testing.assert_array_equal(b_out.numpy(), want.bounces.numpy())
        # rtol=1e-5, atol=1e-6, one lane in a thousand to rtol=1e-4, atol=1e-5
        # (torch_compare.close): libm's cos/sin against torch's, a last bit
        # that one ill-conditioned lane of 1,024 amplifies (measured 2.4e-6).
        for got, exp in zip(f_out, [*want.origin, *want.direction, *want.color]):
            close(got, exp.numpy())
        paths = want

    base_key = prng.prng_key(0)
    film_p, alive_p = fused.fused_prim_iteration_plain(static, cfg, cam, film_ops.new_film(n), 1,
                                                       base_key)
    cam_key, iter_key = fused.kernel_key_words(1, base_key)
    keys = np.asarray([*cam_key, *iter_key], np.uint32)
    film_h = film_ops.new_film(n)
    alive_h = np.zeros(DEPTH, np.int32)
    camera = fused.camera_struct(cam)
    host_lib.ptt_host_iteration(
        ctypes.byref(scene), ctypes.byref(camera), static.width, static.height, n, DEPTH,
        keys.ctypes.data, film_h.x.data_ptr(), film_h.y.data_ptr(), film_h.z.data_ptr(),
        alive_h.ctypes.data)
    # Over 80 bounces a last bit of libm's cos/sin forks a path or two, as
    # between the packages: the whole iteration's bars of the test above.
    _assert_iterations_agree(torch.stack(list(film_h), 1).numpy(), alive_h,
                             torch.stack(list(film_p), 1).numpy(), alive_p.numpy())


def test_renderer_takes_the_iteration_path_at_40_prims(port):
    scene, _, _ = port
    fused_r = Renderer(scene, RenderConfig(fused_bounce="on"), device="cpu")
    plain_r = Renderer(scene, RenderConfig(fused_bounce="off"), device="cpu")
    assert fused_r._use_fused_iter and not plain_r._use_fused_iter
    fused_r.step_many(2)
    plain_r.step_many(2)
    assert_films_close(torch.stack(list(fused_r.film), 1).numpy(),
                       torch.stack(list(plain_r.film), 1).numpy())
    assert np.isfinite(fused_r.image()).all() and fused_r.image().sum() > 0


def test_host_body_matches_plain_at_1600_prims(host_lib):  # noqa: F811
    """Tables longer than a block's shared memory on the card (1,600
    primitives, 200 materials; the generator lays further objects over the
    same grid, so the tables' far end is hit): the per-ray body against the
    plain bounce at 16x16, to ``rtol=1e-5, atol=1e-6`` with one lane in a
    thousand to ``rtol=1e-4, atol=1e-5`` (``torch_compare.close``)."""
    scene = set_resolution(scene_from_dict(many_prims_scene(BASE, 1600, 200, depth=8)), 16, 16)
    _, static = build_device_scene(scene, "cpu")
    cam = camera_state(derive_render_camera(scene.state.camera))
    assert len(static.geoms) == 1600 and static.num_materials == 200
    assert len(static.geoms) * ctypes.sizeof(kernels.PttGeom) > 227 * 1024
    cfg, n = RenderConfig(), static.pixel_count
    struct = fused.scene_struct(static, cfg)
    idx = torch.arange(n, dtype=torch.int32)
    ik = prng.iteration_key(prng.prng_key(0), 1)
    paths = camera_ops.generate_camera_rays(
        cam, static.width, static.height, static.trace_depth,
        prng.uniforms_at(prng.stage_key(ik, 0, 0), idx, 4, n), idx=idx)
    far = 0
    for d in range(2):
        su = prng.uniforms_at(prng.stage_key(ik, d, 1), idx, 3, n)
        isect = p_intersect(None, static, paths, cfg)
        far += int(((isect.material_id >= 40) & (isect.t > 0) & paths.alive).sum())
        want = fused.fused_prim_bounce_plain(static, cfg, paths, su)
        f_out = [torch.empty(n) for _ in range(9)]
        b_out = torch.empty(n, dtype=torch.int32)
        host_lib.ptt_host_bounce(
            ctypes.byref(struct), _ptrs([*paths.origin, *paths.direction, *paths.color]),
            paths.bounces.data_ptr(), su.contiguous().data_ptr(), _ptrs(f_out),
            b_out.data_ptr(), n)
        np.testing.assert_array_equal(b_out.numpy(), want.bounces.numpy())
        for got, exp in zip(f_out, [*want.origin, *want.direction, *want.color]):
            close(got, exp.numpy())
        paths = want
    assert far > 40  # hits on materials beyond the first 40: the far end of both tables
