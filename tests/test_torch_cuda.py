"""The CUDA kernels on the card against their plain PyTorch versions.

These need an NVIDIA GPU with ``nvcc`` (sm_90a) and skip without one.  The
machine with the card has no JAX, so run them without the suite's
``conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py

On the CPU the same arithmetic is checked by ``test_torch_kernel_body.py``
(the kernels' per-ray body built for the host).  Kernel and plain version
run the same float32 operations in the same order (``--fmad=false``), so
stages are compared exactly and films at the goldens' tolerance.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer, megakernel_iteration
from project3_cuda_path_tracer_2025_tpu_torch.ops import camera as camera_ops
from project3_cuda_path_tracer_2025_tpu_torch.ops import film as film_ops
from project3_cuda_path_tracer_2025_tpu_torch.ops import fused, intersect_mxu
from project3_cuda_path_tracer_2025_tpu_torch.ops.intersect import prim_t_min
from project3_cuda_path_tracer_2025_tpu_torch.scene import (
    build_device_scene, camera_state, derive_render_camera, load_scene,
    set_resolution,
)
from project3_cuda_path_tracer_2025_tpu_torch.utils import prng

REPO = pathlib.Path(__file__).resolve().parent.parent
SCENES = ["cornell_dof.json", "cornell_all_lobes.json"]

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda:0")


def _setup(name, res, device):
    scene = set_resolution(load_scene(str(REPO / "scenes" / name)), res, res)
    dev, static = build_device_scene(scene, device)
    cam = camera_state(derive_render_camera(scene.state.camera))
    return dev, static, cam


def test_kernel_uniforms_bit_exact(cuda):
    key = prng.stage_key(prng.iteration_key(prng.prng_key(0), 9), 4, 1)
    n = 100_003
    got = fused.kernel_uniforms(key, n, 3, cuda)
    want = prng.uniforms_at(key, torch.arange(n, device=cuda), 3, n)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", SCENES)
def test_bounce_kernel_matches_plain(cuda, name):
    _, static, cam = _setup(name, 96, cuda)
    cfg = RenderConfig()
    n = static.pixel_count
    idx = torch.arange(n, device=cuda)
    ik = prng.iteration_key(prng.prng_key(0), 1)
    paths = camera_ops.generate_camera_rays(
        cam, static.width, static.height, static.trace_depth,
        prng.uniforms_at(prng.stage_key(ik, 0, 0), idx, 4, n),
    )
    before = fused.fused_prim_bounce.launches
    for d in range(4):
        su = prng.uniforms_at(prng.stage_key(ik, d, 1), idx, 3, n)
        got = fused.fused_prim_bounce(static, cfg, paths, su)
        want = fused.fused_prim_bounce_plain(static, cfg, paths, su)
        assert torch.equal(got.bounces, want.bounces)
        for a, b in zip([*got.origin, *got.direction, *got.color],
                        [*want.origin, *want.direction, *want.color]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
        paths = want
    assert fused.fused_prim_bounce.launches == before + 4


@pytest.mark.parametrize("name", SCENES)
def test_iteration_kernel_matches_plain(cuda, name):
    dev, static, cam = _setup(name, 128, cuda)
    n = static.pixel_count
    key = prng.prng_key(0)
    film_k, alive_k = fused.fused_prim_iteration(
        static, RenderConfig(), cam, film_ops.new_film(n, cuda), 1, key)
    film_p, alive_p = megakernel_iteration(
        dev, static, RenderConfig(fused_bounce="off"), cam,
        film_ops.new_film(n, cuda), 1, key)
    assert torch.equal(alive_k, alive_p)
    got = torch.stack(list(film_k), 1).cpu().numpy()
    want = torch.stack(list(film_p), 1).cpu().numpy()
    outside = ~np.isclose(got, want, rtol=2e-4, atol=2e-5)
    assert outside.any(axis=1).mean() <= 0.005
    np.testing.assert_allclose(got.sum(), want.sum(), rtol=1e-4)


def test_renderer_takes_the_kernels(cuda):
    r = Renderer(str(REPO / "scenes" / "cornell_dof.json"), device=cuda)
    it0, b0 = fused.fused_prim_iteration.launches, fused.fused_prim_bounce.launches
    r.step_many(3)
    assert fused.fused_prim_iteration.launches == it0 + 3
    film, _ = megakernel_iteration(r.dev, r.static, r.cfg, r._cam_state,
                                   film_ops.new_film(r.static.pixel_count, cuda), 1,
                                   r._base_key)
    assert fused.fused_prim_bounce.launches == b0 + r.static.trace_depth
    assert np.isfinite(r.image()).all() and r.image().sum() > 0


def test_wrappers_raise_on_bad_input(cuda):
    _, static, cam = _setup("cornell_dof.json", 8, cuda)
    film = film_ops.new_film(static.pixel_count + 1, cuda)
    with pytest.raises(ValueError, match="film"):
        fused.fused_prim_iteration(static, RenderConfig(), cam, film, 1, prng.prng_key(0))


# ---------------------------------------------------------------------------
# The mesh kernels (csrc/fused_mesh.cu) on scenes/cornell_mesh_5k.json
# ---------------------------------------------------------------------------

MESH = "cornell_mesh_5k.json"


def _camera_paths(static, cam, device):
    n = static.pixel_count
    idx = torch.arange(n, device=device)
    ik = prng.iteration_key(prng.prng_key(0), 1)
    return ik, camera_ops.generate_camera_rays(
        cam, static.width, static.height, static.trace_depth,
        prng.uniforms_at(prng.stage_key(ik, 0, 0), idx, 4, n),
    )


def test_mono_kernel_matches_plain(cuda):
    """Camera rays and two bounces: t and tri bit-equal to the plain version."""
    dev, static, cam = _setup(MESH, 128, cuda)
    cfg = RenderConfig()
    ik, paths = _camera_paths(static, cam, cuda)
    prim_static = dataclasses.replace(static, num_triangles=0)
    before = intersect_mxu.mono_intersect.launches
    hits = 0
    for d in range(3):
        tl = prim_t_min(static, cfg, paths.origin, paths.direction)
        args = (dev.mxu_mesh, static.num_triangles, paths.origin, paths.direction,
                paths.alive, tl, cfg.baby_epsilon)
        t_k, tri_k = intersect_mxu.mono_intersect(*args)
        t_p, tri_p = intersect_mxu.mono_intersect_plain(*args)
        assert torch.equal(tri_k, tri_p)
        assert torch.equal(t_k, t_p)
        hits += int((tri_k >= 0).sum())
        mt, mn, mm = fused.mesh_surface(dev.mxu_mesh, static, cfg, paths, tl, plain=True)
        paths = fused.fused_mesh_shade_plain(
            prim_static, cfg, paths, mt, mn, mm, prng.stage_key(ik, d, 1),
            static.pixel_count)
    assert hits > 100
    assert intersect_mxu.mono_intersect.launches == before + 3


@pytest.mark.parametrize("emit", fused.EMIT_MODES)
def test_mesh_shade_kernel_matches_plain(cuda, emit):
    dev, static, cam = _setup(MESH, 128, cuda)
    cfg = RenderConfig()
    tables = dev.mxu_mesh
    ik, paths = _camera_paths(static, cam, cuda)
    prim_static = dataclasses.replace(static, num_triangles=0)
    before = fused.fused_mesh_shade.launches
    for d in range(3):
        tl = prim_t_min(static, cfg, paths.origin, paths.direction)
        mt, mn, mm = fused.mesh_surface(tables, static, cfg, paths, tl)
        args = (prim_static, cfg, paths, mt, mn, mm, prng.stage_key(ik, d, 1),
                static.pixel_count, emit, tables.tile_aabb, tables.center)
        got = fused.fused_mesh_shade(*args)
        want = fused.fused_mesh_shade_plain(*args)
        got_p, got_c = got if emit else (got, (None, None))
        want_p, want_c = want if emit else (want, (None, None))
        assert torch.equal(got_p.bounces, want_p.bounces)
        for a, b in zip([*got_p.origin, *got_p.direction, *got_p.color],
                        [*want_p.origin, *want_p.direction, *want_p.color]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
        if emit:
            torch.testing.assert_close(got_c[0], want_c[0], rtol=1e-6, atol=0.0)
        if emit == "tlim+key":
            assert torch.equal(got_c[1], want_c[1])
        paths = want_p
    assert fused.fused_mesh_shade.launches == before + 3


def test_mesh_renderer_takes_the_kernels(cuda):
    """Each bounce of a mesh frame launches the traversal and the shade
    kernel once, the iteration kernel never; sorted and unsorted films are
    bit-identical, and both agree with the plain path."""
    scene = set_resolution(load_scene(str(REPO / "scenes" / MESH)), 64, 64)
    counts = lambda: (intersect_mxu.mono_intersect.launches,
                      fused.fused_mesh_shade.launches,
                      fused.fused_prim_iteration.launches)
    films = {}
    for sorting in ("on", "off"):
        r = Renderer(scene, RenderConfig(ray_sorting=sorting), device=cuda)
        c0 = counts()
        r.step_many(2)
        c1 = counts()
        depth = r.static.trace_depth
        assert (c1[0] - c0[0], c1[1] - c0[1], c1[2] - c0[2]) == (2 * depth, 2 * depth, 0)
        films[sorting] = torch.stack(list(r.film), 1)
    assert torch.equal(films["on"], films["off"])
    film_p, _ = megakernel_iteration(r.dev, r.static, r.cfg, r._cam_state,
                                     film_ops.new_film(r.static.pixel_count, cuda), 1,
                                     r._base_key, plain=True)
    film_k, _ = megakernel_iteration(r.dev, r.static, r.cfg, r._cam_state,
                                     film_ops.new_film(r.static.pixel_count, cuda), 1,
                                     r._base_key)
    got = torch.stack(list(film_k), 1).cpu().numpy()
    want = torch.stack(list(film_p), 1).cpu().numpy()
    outside = ~np.isclose(got, want, rtol=2e-4, atol=2e-5)
    assert outside.any(axis=1).mean() <= 0.005
    np.testing.assert_allclose(got.sum(), want.sum(), rtol=1e-4)
    assert np.isfinite(r.image()).all() and r.image().sum() > 0
