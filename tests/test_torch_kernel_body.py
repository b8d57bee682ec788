"""The CUDA kernels' per-ray body, built for the host, against the port's
plain torch path.

``csrc/prim_path.cuh`` compiles for the host as well as for the card, and
``tests/prim_path_host.cpp`` loops it over rays exactly as the kernels in
``csrc/fused_prim.cu`` do one ray per thread.  So the arithmetic the card
runs is checked here, on the CPU, against ``fused_prim_bounce_plain`` /
``fused_prim_iteration_plain`` on identical inputs.  (The kernels
themselves run only on the card: ``tests/test_torch_cuda.py``.)

Tolerances: the RNG is compared bit for bit.  Stage outputs agree to
``rtol=1e-5, atol=1e-6``: sqrt and division are correctly rounded on both
sides, cos/sin are libm's here and SLEEF's in torch (an ulp or so apart).
Films use the goldens' tolerance (``test_goldens.py``) on every pixel
(``tests/torch_compare.py``).
"""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu_torch.ops import camera as camera_ops
from project3_cuda_path_tracer_2025_tpu_torch.ops import film as film_ops
from project3_cuda_path_tracer_2025_tpu_torch.ops import fused, kernels
from project3_cuda_path_tracer_2025_tpu_torch.scene import (
    build_device_scene, camera_state, derive_render_camera, load_scene,
    set_resolution,
)
from project3_cuda_path_tracer_2025_tpu_torch.utils import prng
from torch_compare import assert_films_close

REPO = pathlib.Path(__file__).resolve().parent.parent
HARNESS = REPO / "tests" / "prim_path_host.cpp"

P = ctypes.c_void_p


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the kernel body for the host")
    out = tmp_path_factory.mktemp("host") / "libprim_path_host.so"
    subprocess.run(
        [cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", str(kernels.CSRC), "-o", str(out), str(HARNESS)],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(out))
    lib.ptt_host_sizes.argtypes = [ctypes.POINTER(ctypes.c_int32)]
    lib.ptt_host_uniforms.argtypes = [ctypes.c_uint32] * 3 + [P]
    lib.ptt_host_bounce.argtypes = [P, P, P, P, P, P, ctypes.c_int32]
    lib.ptt_host_iteration.argtypes = [P, P] + [ctypes.c_int32] * 4 + [P] * 5
    sizes = (ctypes.c_int32 * 2)()
    lib.ptt_host_sizes(sizes)
    assert list(sizes) == [ctypes.sizeof(kernels.PttScene), ctypes.sizeof(kernels.PttCamera)]
    return lib


def _scene(name, w, h):
    scene = set_resolution(load_scene(str(REPO / "scenes" / name)), w, h)
    _, static = build_device_scene(scene, "cpu")
    cam = camera_state(derive_render_camera(scene.state.camera))
    return static, cam


def _ptrs(tensors):
    return (P * len(tensors))(*[t.data_ptr() for t in tensors])


def test_host_uniforms_bit_exact(host_lib):
    key = prng.stage_key(prng.iteration_key(prng.prng_key(7), 3), 2, 1)
    n, k = 1000, 3
    out = torch.empty((k, n), dtype=torch.float32)
    host_lib.ptt_host_uniforms(key[0], key[1], n * k, out.data_ptr())
    want = prng.uniforms_at(key, torch.arange(n), k, n)
    assert torch.equal(out, want)


@pytest.mark.parametrize("name", ["cornell_dof.json", "cornell_all_lobes.json"])
def test_host_bounce_matches_plain(host_lib, name):
    static, cam = _scene(name, 32, 24)
    cfg = RenderConfig()
    n = static.pixel_count
    idx = torch.arange(n, dtype=torch.int32)
    ik = prng.iteration_key(prng.prng_key(0), 1)
    paths = camera_ops.generate_camera_rays(
        cam, static.width, static.height, static.trace_depth,
        prng.uniforms_at(prng.stage_key(ik, 0, 0), idx, 4, n), idx=idx,
    )
    scene = fused.scene_struct(static, cfg)
    for d in range(3):
        su = prng.uniforms_at(prng.stage_key(ik, d, 1), idx, 3, n)
        want = fused.fused_prim_bounce_plain(static, cfg, paths, su)
        f_in = [*paths.origin, *paths.direction, *paths.color]
        f_out = [torch.empty(n) for _ in range(9)]
        b_out = torch.empty(n, dtype=torch.int32)
        host_lib.ptt_host_bounce(
            ctypes.byref(scene), _ptrs(f_in), paths.bounces.data_ptr(),
            su.contiguous().data_ptr(), _ptrs(f_out), b_out.data_ptr(), n,
        )
        np.testing.assert_array_equal(b_out.numpy(), want.bounces.numpy())
        for got, exp in zip(f_out, [*want.origin, *want.direction, *want.color]):
            np.testing.assert_allclose(got.numpy(), exp.numpy(), rtol=1e-5, atol=1e-6)
        paths = want


@pytest.mark.parametrize("name", ["cornell_dof.json", "cornell_all_lobes.json"])
def test_host_iteration_matches_plain(host_lib, name):
    static, cam = _scene(name, 24, 24)
    cfg = RenderConfig()
    n, depth = static.pixel_count, static.trace_depth
    base_key = prng.prng_key(0)
    film_p, alive_p = fused.fused_prim_iteration_plain(
        static, cfg, cam, film_ops.new_film(n), 1, base_key)

    cam_key, shade_keys = fused.iteration_keys(static, 1, base_key)
    keys = np.asarray([*cam_key] + [k for sk in shade_keys for k in sk], np.uint32)
    film_h = film_ops.new_film(n)
    alive_h = np.zeros(depth, np.int32)
    scene = fused.scene_struct(static, cfg)
    camera = fused.camera_struct(cam)
    host_lib.ptt_host_iteration(
        ctypes.byref(scene), ctypes.byref(camera), static.width, static.height,
        n, depth, keys.ctypes.data, film_h.x.data_ptr(), film_h.y.data_ptr(),
        film_h.z.data_ptr(), alive_h.ctypes.data,
    )
    got = torch.stack(list(film_h), 1).numpy()
    want = torch.stack(list(film_p), 1).numpy()
    assert_films_close(got, want)
    np.testing.assert_array_equal(alive_h, alive_p.numpy())


def test_kernel_wrappers_refuse_non_cuda_devices():
    """A wrapper runs its plain version only for CPU tensors; anything else
    that is not CUDA is refused, never silently computed elsewhere."""
    with pytest.raises(ValueError, match="CUDA"):
        fused.kernel_uniforms(prng.prng_key(0), 8, 3, "cpu")
    static, cam = _scene("cornell_dof.json", 4, 4)
    film = film_ops.new_film(16, "meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused.fused_prim_iteration(static, RenderConfig(), cam, film, 1, prng.prng_key(0))
