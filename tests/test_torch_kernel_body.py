"""The CUDA kernels' per-ray bodies, built for the host, against the port's
plain torch versions.

``csrc/prim_path.cuh`` and ``csrc/mesh_path.cuh`` compile for the host as
well as for the card, and ``tests/prim_path_host.cpp`` /
``tests/mesh_path_host.cpp`` loop them over rays exactly as the kernels in
``csrc/fused_prim.cu`` / ``csrc/fused_mesh.cu`` do one ray per thread.  So
the arithmetic the card runs is checked here, on the CPU, against
``fused_prim_bounce_plain`` / ``fused_prim_iteration_plain`` /
``mono_intersect_plain`` / ``fused_mesh_shade_plain`` on identical inputs.
(The kernels themselves run only on the card: ``tests/test_torch_cuda.py``.)

Tolerances: the RNG is compared bit for bit, and so is the mono traversal
(the same float32 operations in the same order, its fused multiply-adds
emulated exactly by ``fma32``).  Shade outputs agree to ``rtol=1e-5,
atol=1e-6``: sqrt and division are correctly rounded on both sides,
cos/sin are libm's here and SLEEF's in torch (an ulp or so apart); the
sort key, a function of the scattered ray, may differ only on lanes whose
ray differs.  Films use the goldens' tolerance (``test_goldens.py``) on
every pixel (``tests/torch_compare.py``).
"""

import ctypes
import dataclasses
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu_torch.ops import camera as camera_ops
from project3_cuda_path_tracer_2025_tpu_torch.ops import film as film_ops
from project3_cuda_path_tracer_2025_tpu_torch.ops import fused, intersect_mxu, kernels
from project3_cuda_path_tracer_2025_tpu_torch.ops.intersect import prim_t_min
from project3_cuda_path_tracer_2025_tpu_torch.scene import (
    build_device_scene, camera_state, derive_render_camera, load_scene,
    set_resolution,
)
from project3_cuda_path_tracer_2025_tpu_torch.utils import prng
from project3_cuda_path_tracer_2025_tpu_torch.utils.vec import Vec3
from torch_compare import assert_films_close

REPO = pathlib.Path(__file__).resolve().parent.parent
HARNESS = REPO / "tests" / "prim_path_host.cpp"
MESH_HARNESS = REPO / "tests" / "mesh_path_host.cpp"
MESH = REPO / "scenes" / "cornell_mesh_5k.json"

P = ctypes.c_void_p


def _build_host(tmp_path_factory, src, name):
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the kernel body for the host")
    out = tmp_path_factory.mktemp("host") / name
    subprocess.run(
        [cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", str(kernels.CSRC), "-o", str(out), str(src)],
        check=True, capture_output=True, text=True,
    )
    return ctypes.CDLL(str(out))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = _build_host(tmp_path_factory, HARNESS, "libprim_path_host.so")
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


# ---------------------------------------------------------------------------
# The mesh kernels' bodies (csrc/mesh_path.cuh)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_lib(tmp_path_factory):
    lib = _build_host(tmp_path_factory, MESH_HARNESS, "libmesh_path_host.so")
    lib.ptt_host_mesh_sizes.argtypes = [ctypes.POINTER(ctypes.c_int32)]
    lib.ptt_host_mono.argtypes = (
        [P, P, ctypes.c_int32, P, P, P, P, ctypes.c_int32, ctypes.c_float,
         ctypes.c_float, ctypes.c_int32, P, P]
    )
    lib.ptt_host_mesh_shade.argtypes = (
        [P] * 13 + [ctypes.c_uint32] * 3 + [ctypes.c_int32] * 3
    )
    sizes = (ctypes.c_int32 * 2)()
    lib.ptt_host_mesh_sizes(sizes)
    assert list(sizes) == [ctypes.sizeof(kernels.PttScene), intersect_mxu.COEF_W]
    return lib


@pytest.fixture(scope="module")
def mesh_scene():
    scene = set_resolution(load_scene(str(MESH)), 32, 24)
    dev, static = build_device_scene(scene, "cpu")
    cam = camera_state(derive_render_camera(scene.state.camera))
    return dev, static, cam


def _host_mono(lib, tables, num_tris, ro, rd, active, tlim, eps=1e-5):
    n = ro.x.shape[0]
    out_t = torch.empty(n)
    out_tri = torch.empty(n, dtype=torch.int32)
    rays = [p.contiguous() for p in (*ro, *rd)]
    act = active.to(torch.uint8).contiguous()
    eps_succ = float(np.nextafter(np.float32(eps), np.float32(np.inf)))
    lib.ptt_host_mono(
        tables.coef.data_ptr(), tables.tile_aabb.data_ptr(), tables.tile_aabb.shape[0],
        tables.center.data_ptr(), _ptrs(rays), act.data_ptr(), tlim.data_ptr(),
        num_tris, eps, eps_succ, n, out_t.data_ptr(), out_tri.data_ptr(),
    )
    return out_t, out_tri


def test_host_mono_matches_plain(mesh_lib, mesh_scene):
    """Camera rays of the 5k mesh scene, and rays shot at the mesh from a
    sphere around it with random t_limits and dead rays: t and tri equal."""
    dev, static, cam = mesh_scene
    n = static.pixel_count
    idx = torch.arange(n, dtype=torch.int32)
    ik = prng.iteration_key(prng.prng_key(0), 1)
    paths = camera_ops.generate_camera_rays(
        cam, static.width, static.height, static.trace_depth,
        prng.uniforms_at(prng.stage_key(ik, 0, 0), idx, 4, n), idx=idx,
    )
    rng = np.random.default_rng(3)
    m = 3000
    c = dev.mxu_mesh.center.numpy().astype(np.float64)
    o = rng.normal(size=(m, 3))
    o = c + 4.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = c + rng.uniform(-1.5, 1.5, (m, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    cases = [
        (paths.origin, paths.direction, torch.ones(n, dtype=torch.bool),
         prim_t_min(static, RenderConfig(), paths.origin, paths.direction)),
        (Vec3(*(t(o[:, i]) for i in range(3))), Vec3(*(t(d[:, i]) for i in range(3))),
         torch.from_numpy(rng.random(m) > 0.2),
         t(np.where(rng.random(m) > 0.5, 3.4e38, rng.uniform(2.0, 6.0, m)))),
    ]
    for ro, rd, active, tlim in cases:
        want_t, want_tri = intersect_mxu.mono_intersect_plain(
            dev.mxu_mesh, static.num_triangles, ro, rd, active, tlim, 1e-5)
        got_t, got_tri = _host_mono(mesh_lib, dev.mxu_mesh, static.num_triangles,
                                    ro, rd, active, tlim)
        assert (want_tri >= 0).sum() > 20
        assert torch.equal(got_tri, want_tri)
        assert torch.equal(got_t, want_t)


@pytest.mark.parametrize("emit", fused.EMIT_MODES)
def test_host_mesh_shade_matches_plain(mesh_lib, mesh_scene, emit):
    """Three chained bounces of the 5k mesh scene from camera rays, with the
    mesh surface of the plain traversal, through both shade bodies."""
    dev, static, cam = mesh_scene
    cfg = RenderConfig()
    n = static.pixel_count
    idx = torch.arange(n, dtype=torch.int32)
    ik = prng.iteration_key(prng.prng_key(0), 1)
    paths = camera_ops.generate_camera_rays(
        cam, static.width, static.height, static.trace_depth,
        prng.uniforms_at(prng.stage_key(ik, 0, 0), idx, 4, n), idx=idx,
    )
    prim_static = dataclasses.replace(static, num_triangles=0)
    scene = fused.scene_struct(prim_static, cfg)
    tables = dev.mxu_mesh
    for d in range(3):
        tl = prim_t_min(static, cfg, paths.origin, paths.direction)
        mt, mn, mm = fused.mesh_surface(tables, static, cfg, paths, tl)
        skey = prng.stage_key(ik, d, 1)
        want = fused.fused_mesh_shade_plain(
            prim_static, cfg, paths, mt, mn, mm, skey, n, emit,
            tables.tile_aabb, tables.center)
        want_p, (want_tl, want_key) = want if emit else (want, (None, None))
        f_in = [*paths.origin, *paths.direction, *paths.color]
        f_out = [torch.empty(n) for _ in range(9)]
        b_out = torch.empty(n, dtype=torch.int32)
        tl_out = torch.empty(n)
        key_out = torch.empty(n, dtype=torch.int32)
        mesh_lib.ptt_host_mesh_shade(
            ctypes.byref(scene), _ptrs(f_in), paths.bounces.data_ptr(),
            paths.pixel.data_ptr(), mt.contiguous().data_ptr(),
            _ptrs([x.contiguous() for x in mn]), mm.contiguous().data_ptr(),
            tables.tile_aabb.data_ptr(), tables.center.data_ptr(), _ptrs(f_out),
            b_out.data_ptr(), tl_out.data_ptr(), key_out.data_ptr(),
            skey[0], skey[1], n, n, tables.tile_aabb.shape[0],
            fused.EMIT_MODES.index(emit),
        )
        np.testing.assert_array_equal(b_out.numpy(), want_p.bounces.numpy())
        outs = [*want_p.origin, *want_p.direction, *want_p.color]
        same = torch.ones(n, dtype=torch.bool)
        for got, exp in zip(f_out, outs):
            np.testing.assert_allclose(got.numpy(), exp.numpy(), rtol=1e-5, atol=1e-6)
            same &= got == exp
        if emit:
            np.testing.assert_allclose(tl_out.numpy(), want_tl.numpy(), rtol=1e-5)
        if emit == "tlim+key":
            assert torch.equal(key_out[same], want_key[same])
        paths = want_p
