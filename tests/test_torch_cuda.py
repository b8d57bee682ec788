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

import pathlib

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer, megakernel_iteration
from project3_cuda_path_tracer_2025_tpu_torch.ops import camera as camera_ops
from project3_cuda_path_tracer_2025_tpu_torch.ops import film as film_ops
from project3_cuda_path_tracer_2025_tpu_torch.ops import fused
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
