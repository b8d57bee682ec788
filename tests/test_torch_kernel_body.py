"""The CUDA kernels' per-ray bodies, built for the host, against the port's
plain torch versions.

``csrc/prim_path.cuh``, ``csrc/mesh_path.cuh`` and ``csrc/scan.cuh`` compile
for the host as well as for the card, and ``tests/prim_path_host.cpp`` /
``tests/mesh_path_host.cpp`` loop them over rays exactly as the kernels in
``csrc/fused_prim.cu`` / ``csrc/fused_mesh.cu`` do one ray per thread
(``tests/scan_host.cpp`` runs a block's 256 threads of ``csrc/scan.cu`` in
lockstep).  So the arithmetic the card runs is checked here, on the CPU,
against ``fused_prim_bounce_plain`` / ``fused_prim_iteration_plain`` /
``mono_intersect_plain`` / ``fused_mesh_shade_plain`` (all three modes) /
``walk_plain`` / ``binned_intersect_plain`` / ``sweep_intersect_plain`` /
``streamed_super_plain`` / ``plan_prepass_plain`` / ``packet_bins_plain`` /
``scan_flat_plain`` on identical inputs.  (The kernels themselves run only
on the card: ``tests/test_torch_cuda.py``.)

Tolerances: the RNG is compared bit for bit, and so is the mono traversal
(the same float32 operations in the same order, its fused multiply-adds
emulated exactly by ``fma32``).  Shade outputs agree to ``rtol=1e-5,
atol=1e-6``: sqrt and division are correctly rounded on both sides,
cos/sin are libm's here and SLEEF's in torch (an ulp or so apart); the
sort key, a function of the scattered ray, may differ only on lanes whose
ray differs.  Films use the goldens' tolerance (``test_goldens.py``) on
every pixel (``tests/torch_compare.py``).  The scan body equals
``torch.cumsum`` exactly on integer values and agrees to ``rtol=1e-6`` on
floats (another summation order).
"""

import ctypes
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu_torch.ops import camera as camera_ops
from project3_cuda_path_tracer_2025_tpu_torch.ops import film as film_ops
from project3_cuda_path_tracer_2025_tpu_torch.ops import fused, intersect_mxu, kernels
from project3_cuda_path_tracer_2025_tpu_torch.ops import shade as shade_ops
from project3_cuda_path_tracer_2025_tpu_torch.ops.intersect import intersect_scene, prim_t_min
from project3_cuda_path_tracer_2025_tpu_torch.scene import (
    build_device_scene, camera_state, derive_render_camera, load_scene, many_prims_scene,
    scene_from_dict, set_resolution,
)
from project3_cuda_path_tracer_2025_tpu_torch.utils import prng, vec
from project3_cuda_path_tracer_2025_tpu_torch.utils.vec import Vec3
from torch_compare import (
    ATOL_WORLD, FILM_ATOL, FILM_RTOL, assert_films_close, build_host, close3,
)
from torch_fixtures import assert_bins_equal, key_case, prepass_case, winner_case

REPO = pathlib.Path(__file__).resolve().parent.parent
HARNESS = REPO / "tests" / "prim_path_host.cpp"
MESH_HARNESS = REPO / "tests" / "mesh_path_host.cpp"
SCAN_HARNESS = REPO / "tests" / "scan_host.cpp"
MESH = REPO / "scenes" / "cornell_mesh_5k.json"

P = ctypes.c_void_p


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build_host(tmp_path_factory, HARNESS, "libprim_path_host.so")
    lib.ptt_host_sizes.argtypes = [ctypes.POINTER(ctypes.c_int32)]
    lib.ptt_host_uniforms.argtypes = [ctypes.c_uint32] * 6 + [P]
    lib.ptt_host_bounce.argtypes = [P, P, P, P, P, P, ctypes.c_int32]
    lib.ptt_host_iteration.argtypes = [P, P] + [ctypes.c_int32] * 4 + [P] * 5
    lib.ptt_host_iteration_regen.argtypes = (
        [P, P] + [ctypes.c_int32] * 4 + [P] * 5 + [ctypes.c_int32] * 2 + [P, P])
    lib.ptt_host_bounce_packed.argtypes = (
        [P] * 6 + [ctypes.c_int32, P] + [ctypes.c_uint32] * 3 + [ctypes.c_int32, P])
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
    host_lib.ptt_host_uniforms(key[0], key[1], n, k, 0, n, out.data_ptr())
    want = prng.uniforms_at(key, torch.arange(n), k, n)
    assert torch.equal(out, want)


@pytest.mark.parametrize("ln,base,rng_n", [(1000, 0, 4000), (1000, 3000, 4000),
                                           (333, 1234, 100_003)])
def test_host_uniforms_block_bit_exact(host_lib, ln, base, rng_n):
    """The kernel's draw of a block of pixels (a shard or chunk of a frame):
    ``prng.uniforms_at`` at the block's pixels in the whole frame's stream."""
    key = prng.stage_key(prng.iteration_key(prng.prng_key(7), 3), 0, 0)
    out = torch.empty((4, ln), dtype=torch.float32)
    host_lib.ptt_host_uniforms(key[0], key[1], ln, 4, base, rng_n, out.data_ptr())
    assert torch.equal(out, prng.uniforms_at(key, base + torch.arange(ln), 4, rng_n))


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

    cam_key, iter_key = fused.kernel_key_words(1, base_key)
    keys = np.asarray([*cam_key, *iter_key], np.uint32)
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


# The iteration kernel's regenerating schedule (ptt_host_iteration_regen):
# name -> (scene, width, height, warps).  "odd": 391 pixels, not a multiple
# of 32; "few": 256 lanes for 64 pixels; "depth80": 40 primitives and 40
# materials at depth 80 (scene.many_prims_scene, as
# tests/test_torch_prim_capacity.py).
REGEN_CASES = {
    "dof": ("cornell_dof.json", 24, 24, 4),
    "lobes": ("cornell_all_lobes.json", 24, 24, 4),
    "odd": ("cornell_dof.json", 23, 17, 3),
    "few": ("cornell_dof.json", 8, 8, 8),
    "depth80": ("depth80", 12, 12, 4),
}


@pytest.fixture(scope="module")
def regen_refs(host_lib):
    """name -> (static, cam, keys, the per-pixel schedule's film and alive
    counts, the plain version's film, alive counts and lobe tally), each
    made once."""
    cache = {}

    def get(name):
        if name in cache:
            return cache[name]
        what, w, h, _ = REGEN_CASES[name]
        if what == "depth80":
            doc = many_prims_scene(str(REPO / "scenes" / "cornell_dof.json"), 40, 40, depth=80)
            scene = set_resolution(scene_from_dict(doc), w, h)
            _, static = build_device_scene(scene, "cpu")
            cam = camera_state(derive_render_camera(scene.state.camera))
        else:
            static, cam = _scene(what, w, h)
        n, depth = static.pixel_count, static.trace_depth
        base_key = prng.prng_key(0)
        lobes_p = torch.zeros((depth, len(shade_ops.LOBES)), dtype=torch.int32)
        film_p, alive_p = fused.fused_prim_iteration_plain(
            static, RenderConfig(), cam, film_ops.new_film(n), 1, base_key, lobes_p)
        cam_key, iter_key = fused.kernel_key_words(1, base_key)
        keys = np.asarray([*cam_key, *iter_key], np.uint32)
        film_h = film_ops.new_film(n)
        alive_h = np.zeros(depth, np.int32)
        host_lib.ptt_host_iteration(
            ctypes.byref(fused.scene_struct(static, RenderConfig())),
            ctypes.byref(fused.camera_struct(cam)), static.width, static.height, n, depth,
            keys.ctypes.data, *(c.data_ptr() for c in film_h), alive_h.ctypes.data)
        cache[name] = (static, cam, keys, film_h, alive_h, film_p, alive_p.numpy(),
                       lobes_p.numpy())
        return cache[name]

    return get


@pytest.mark.parametrize("refill_min", [1, 16])
@pytest.mark.parametrize("name", list(REGEN_CASES))
def test_host_iteration_regen_matches_per_pixel(host_lib, regen_refs, name, refill_min):
    """The regenerating schedule (warps of 32 lanes in lock step, one pixel
    counter, a warp refilling once 1 or 16 of its lanes are free) traces
    every pixel's path as the per-pixel schedule does: film and alive counts
    bit for bit, and so the plain version's to its tolerance.  Its lane
    counts: every live lane-bounce once (the camera rays and the rays alive
    after each depth but the last).  Its lobe tally (the counting variant's,
    traced once more): the same film, the plain version's tally, and at each
    depth but the last as many scatters as paths alive after it (a path that
    scatters lives on until its last bounce)."""
    static, cam, keys, film_h, alive_h, film_p, alive_p, lobes_p = regen_refs(name)
    n, depth = static.pixel_count, static.trace_depth
    warps = REGEN_CASES[name][3]
    film_r = film_ops.new_film(n)
    alive_r = np.zeros(depth, np.int32)
    lanes = np.zeros(2, np.int64)
    args = (ctypes.byref(fused.scene_struct(static, RenderConfig())),
            ctypes.byref(fused.camera_struct(cam)), static.width, static.height, n, depth,
            keys.ctypes.data)
    host_lib.ptt_host_iteration_regen(
        *args, *(c.data_ptr() for c in film_r), alive_r.ctypes.data,
        warps, refill_min, lanes.ctypes.data, None)
    for got, want in zip(film_r, film_h):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    np.testing.assert_array_equal(alive_r, alive_h)
    assert lanes[1] == n + int(alive_h[:-1].sum())
    assert lanes[0] % 32 == 0 and lanes[1] <= lanes[0]
    film_c = film_ops.new_film(n)
    alive_c = np.zeros(depth, np.int32)
    lobes_c = np.zeros((depth, len(shade_ops.LOBES)), np.int32)
    host_lib.ptt_host_iteration_regen(
        *args, *(c.data_ptr() for c in film_c), alive_c.ctypes.data,
        warps, refill_min, np.zeros(2, np.int64).ctypes.data, lobes_c.ctypes.data)
    for got, want in zip(film_c, film_h):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    np.testing.assert_array_equal(alive_c, alive_h)
    np.testing.assert_array_equal(lobes_c[:-1].sum(axis=1), alive_h[:-1])
    got = torch.stack(list(film_r), 1).numpy()
    want = torch.stack(list(film_p), 1).numpy()
    if name != "depth80":
        assert_films_close(got, want)
        np.testing.assert_array_equal(alive_r, alive_p)
        np.testing.assert_array_equal(lobes_c, lobes_p)
    else:
        # Over 80 bounces a last bit of libm's cos/sin against torch's forks
        # a path or two: tests/test_torch_prim_capacity.py's bars.
        assert np.abs(alive_r.astype(np.int64) - alive_p).max() <= 2
        outside = ~np.isclose(got, want, rtol=FILM_RTOL, atol=FILM_ATOL)
        assert outside.any(axis=1).sum() <= 3
        np.testing.assert_allclose(got.sum(), want.sum(), rtol=1e-3)


# The bounce kernel's packed schedule (ptt_host_bounce_packed): name ->
# (scene, width, height, bounces traced before).  "all_dead": every
# ray's bounces 0; "all_live": the camera rays; "one_a_warp": lane 7 of
# every 32 rays live; "odd": 391 rays, not a multiple of 32; "offset": the
# pixels shifted by 1,000 in a stream of 2,000 + n (a shard's slice).
PACKED_CASES = {
    "dof": ("cornell_dof.json", 48, 40, 2),
    "lobes": ("cornell_all_lobes.json", 48, 40, 3),
    "depth80": ("depth80", 24, 24, 5),
    "all_dead": ("cornell_dof.json", 24, 16, 0),
    "all_live": ("cornell_dof.json", 48, 40, 0),
    "one_a_warp": ("cornell_dof.json", 48, 40, 0),
    "odd": ("cornell_dof.json", 23, 17, 2),
    "offset": ("cornell_all_lobes.json", 32, 24, 1),
}


def _packed_case(name):
    """(static, paths, skey, rng_n) of a PACKED_CASES entry: the camera
    rays of iteration 1 and the bounces traced before, by the plain
    version."""
    what, w, h, before = PACKED_CASES[name]
    if what == "depth80":
        doc = many_prims_scene(str(REPO / "scenes" / "cornell_dof.json"), 40, 40, depth=80)
        scene = set_resolution(scene_from_dict(doc), w, h)
        _, static = build_device_scene(scene, "cpu")
        cam = camera_state(derive_render_camera(scene.state.camera))
    else:
        static, cam = _scene(what, w, h)
    n = static.pixel_count
    idx = torch.arange(n, dtype=torch.int32)
    ik = prng.iteration_key(prng.prng_key(0), 1)
    paths = camera_ops.generate_camera_rays(
        cam, static.width, static.height, static.trace_depth,
        prng.uniforms_at(prng.stage_key(ik, 0, 0), idx, 4, n), idx=idx)
    for d in range(before):
        paths = fused.fused_prim_bounce_plain(static, RenderConfig(), paths,
                                              su_key=prng.stage_key(ik, d, 1))
    rng_n = n
    if name == "all_dead":
        paths = paths._replace(bounces=torch.zeros_like(paths.bounces))
    elif name == "one_a_warp":
        paths = paths._replace(bounces=torch.where(idx % 32 == 7, paths.bounces, 0))
    elif name == "offset":
        paths = paths._replace(pixel=idx + 1000)
        rng_n = n + 2000
    return static, paths, prng.stage_key(ik, before, 1), rng_n


@pytest.mark.parametrize("form", ["inline", "uniforms"])
@pytest.mark.parametrize("blocks", [1, 3])
@pytest.mark.parametrize("name", list(PACKED_CASES))
def test_host_bounce_packed_matches_per_ray(host_lib, name, blocks, form):
    """The bounce kernel's packed schedule (1 or 3 blocks of 8 warps of 32
    lanes in lock step, taking chunks of 32 rays from one counter, each
    warp's live queue, the block's leftovers dealt in order; the deferred normal;
    uniforms drawn inline at the rays' pixels or given as [3, n]) gives the
    per-ray
    schedule's outputs bit for bit, and the plain version's to the port's
    stage tolerance (``torch_compare.close``: libm's cos/sin here, SLEEF's
    in torch).  Its lane counts: every live ray once, at most 31 idle lanes
    a warp of a block's leftovers."""
    static, paths, skey, rng_n = _packed_case(name)
    cfg = RenderConfig()
    n = static.pixel_count
    su = prng.uniforms_at(skey, paths.pixel, 3, rng_n).contiguous()
    scene = fused.scene_struct(static, cfg)
    f_in = [c.contiguous() for c in (*paths.origin, *paths.direction, *paths.color)]

    def outputs():
        return [torch.full((n,), float("nan")) for _ in range(9)], torch.full((n,), -7, dtype=torch.int32)

    want_f, want_b = outputs()
    host_lib.ptt_host_bounce(ctypes.byref(scene), _ptrs(f_in), paths.bounces.data_ptr(),
                             su.data_ptr(), _ptrs(want_f), want_b.data_ptr(), n)
    got_f, got_b = outputs()
    lanes = np.zeros(2, np.int64)
    host_lib.ptt_host_bounce_packed(
        ctypes.byref(scene), _ptrs(f_in), paths.bounces.data_ptr(),
        su.data_ptr() if form == "uniforms" else None, _ptrs(got_f), got_b.data_ptr(), n,
        paths.pixel.contiguous().data_ptr(), skey[0], skey[1], rng_n, blocks,
        lanes.ctypes.data)
    assert torch.equal(got_b, want_b)
    for got, want in zip(got_f, want_f):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    live = int((paths.bounces > 0).sum())
    assert lanes[1] == live and lanes[0] % 32 == 0
    assert lanes[0] - lanes[1] <= 31 * 8 * blocks
    if name == "all_live":
        assert lanes[0] == lanes[1] == n
    if name == "all_dead":
        assert lanes[0] == 0
    plain = (fused.fused_prim_bounce_plain(static, cfg, paths, su_key=skey, rng_n=rng_n)
             if form == "inline" else fused.fused_prim_bounce_plain(static, cfg, paths, su))
    np.testing.assert_array_equal(got_b.numpy(), plain.bounces.numpy())
    close3(got_f[0:3], plain.origin, atol=ATOL_WORLD)
    close3(got_f[3:6], plain.direction)
    close3(got_f[6:9], plain.color)


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
    lib = build_host(tmp_path_factory, MESH_HARNESS, "libmesh_path_host.so")
    lib.ptt_host_mesh_sizes.argtypes = [ctypes.POINTER(ctypes.c_int32)]
    lib.ptt_host_mono.argtypes = (
        [P, P, ctypes.c_int32, P, P, P, P, P, ctypes.c_int32, ctypes.c_float,
         ctypes.c_float, ctypes.c_int32, P, P]
    )
    resolve = [P, P, ctypes.c_int32, ctypes.c_float]  # mesh_tri, attrs, rows, baby_eps
    lib.ptt_host_mesh_shade.argtypes = (
        [P] * 14 + [ctypes.c_uint32] * 3 + [ctypes.c_int32] * 4 + [P] + resolve
    )
    lib.ptt_host_mesh_shade_win.argtypes = (
        [P] * 14 + [ctypes.c_uint32] * 3 + [ctypes.c_int32] * 4 + [P] * 3 + resolve
    )
    lib.ptt_host_mesh_surface.argtypes = (
        [P, ctypes.c_int32, P, P, ctypes.c_float, ctypes.c_int32, P, P])
    lib.ptt_host_coherence_key.argtypes = [P, ctypes.c_int32, P, P, P, P, P, ctypes.c_int32, P]
    lib.ptt_host_mesh_prelude.argtypes = [P] * 9 + [ctypes.c_int32] * 3
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
        tables.root_box.data_ptr(), tables.center.data_ptr(), _ptrs(rays), act.data_ptr(),
        tlim.data_ptr(),
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


def _surface_rays(rows, num_tris, rng, m=4000):
    """Rays at random triangles of attrs_shade ``rows`` -> (tri, ro, rd,
    kind): a quarter each from the front, from behind (back-facing hits:
    det < 0), in the triangle's plane along e1 (|det| far below
    baby_epsilon, so the resolve divides by 1), and misses (tri = -1)."""
    q = m // 4
    tri = rng.integers(0, num_tris, m)
    r = rows[tri].astype(np.float64)
    v0, e1, e2 = r[:, 10:13], r[:, 13:16], r[:, 16:19]
    c = v0 + (e1 + e2) / 3.0
    fn = np.cross(e1, e2)
    fn /= np.linalg.norm(fn, axis=1, keepdims=True)
    side = np.repeat([1.0, -1.0, 0.0, 1.0], q)[:, None]
    o = c + side * fn * rng.uniform(0.05, 2.0, (m, 1))
    o[2 * q:3 * q] -= e1[2 * q:3 * q]
    aim = c + rng.uniform(-0.2, 0.2, (m, 1)) * e1 + rng.uniform(-0.2, 0.2, (m, 1)) * e2
    d = aim - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    kind = np.repeat(["front", "back", "in plane", "miss"], q)
    tri[kind == "miss"] = -1
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return (torch.from_numpy(tri.astype(np.int32)), Vec3(*(f(o[:, i]) for i in range(3))),
            Vec3(*(f(d[:, i]) for i in range(3))), kind)


@pytest.mark.parametrize("name,flat", [("cornell_mesh_5k.json", False),
                                       ("cornell_mesh_80k.json", True)], ids=["5k", "80k flat"])
def test_host_mesh_surface_matches_resolve(mesh_lib, name, flat):
    """``mesh_surface`` (mode "plain"'s resolve in the shade kernel) built
    for the host against ``fused.resolve_mesh_surface`` bit for bit: the
    normal and the material of ``_surface_rays``' front, back-facing,
    in-plane (|det| below baby_epsilon) and missing rays, on the 5k mesh's
    rows (ico4.obj's vertex normals) and the 80k knot's (an OBJ without
    normals: the flat-normal fallback, n0 = n1 = n2)."""
    scene = set_resolution(load_scene(str(REPO / "scenes" / name)), 8, 8)
    dev, static = build_device_scene(scene, "cpu")
    tables, cfg = dev.mxu_mesh, RenderConfig()
    rows = tables.attrs_shade.numpy()[:static.num_triangles]
    assert bool((rows[:, 0:3] == rows[:, 3:6]).all()) == flat
    tri, ro, rd, kind = _surface_rays(rows, static.num_triangles, np.random.default_rng(4))
    want_n, want_mat = fused.resolve_mesh_surface(tables, tri, ro, rd, cfg.baby_epsilon)
    n = tri.shape[0]
    got_n, got_mat = [torch.empty(n) for _ in range(3)], torch.empty(n, dtype=torch.int32)
    mesh_lib.ptt_host_mesh_surface(
        tables.attrs_shade.data_ptr(), tables.attrs_shade.shape[0], tri.data_ptr(),
        _ptrs([p.contiguous() for p in (*ro, *rd)]), cfg.baby_epsilon, n, _ptrs(got_n),
        got_mat.data_ptr())
    _bits_equal([*got_n, got_mat], [*want_n, want_mat])
    # Every kind is there: det's sign splits front from back, the in-plane
    # rays fall below the floor, the misses give -1 and a zero normal.
    at = intersect_mxu.resolve_shade_attributes(tables, tables.attrs_shade.shape[0], tri)
    e1, e2 = (Vec3(*(at[:, a + i] for i in range(3))) for a in (13, 16))
    det = vec.dot(e1, vec.cross(rd, e2)).numpy()
    live = kind != "miss"
    assert (det[kind == "front"] > 0).all() and (det[kind == "back"] < 0).all()
    assert (np.abs(det[kind == "in plane"]) < np.float32(cfg.baby_epsilon)).all()
    assert (want_mat.numpy()[~live] == -1).all() and (want_mat.numpy()[live] >= 0).all()
    assert not any(bool(c[torch.from_numpy(~live)].any()) for c in want_n)
    assert bool(torch.isfinite(torch.stack(list(want_n))).all())


@pytest.mark.parametrize("emit", fused.EMIT_MODES)
def test_host_mesh_shade_matches_plain(mesh_lib, mesh_scene, emit):
    """Three chained bounces of the 5k mesh scene from camera rays, with the
    walk's (t, tri) of the plain traversal, through both shade bodies (each
    resolving the winner's surface itself)."""
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
        mh = fused.mesh_walk(tables, static, cfg, paths, tl)
        skey = prng.stage_key(ik, d, 1)
        want = fused.fused_mesh_shade_plain(prim_static, cfg, paths, mh.t, None, None, skey,
                                            n, emit, tables, mesh_tri=mh.tri)
        want_p, (want_tl, want_key, _) = want if emit else (want, (None, None, None))
        f_in = [*paths.origin, *paths.direction, *paths.color]
        f_out = [torch.empty(n) for _ in range(9)]
        b_out = torch.empty(n, dtype=torch.int32)
        tl_out = torch.empty(n)
        key_out = torch.empty(n, dtype=torch.int32)
        mesh_lib.ptt_host_mesh_shade(
            ctypes.byref(scene), _ptrs(f_in), paths.bounces.data_ptr(),
            paths.pixel.data_ptr(), mh.t.contiguous().data_ptr(), None, None,
            tables.tile_aabb.data_ptr(), tables.root_box.data_ptr(), tables.center.data_ptr(),
            _ptrs(f_out), b_out.data_ptr(), tl_out.data_ptr(), key_out.data_ptr(),
            skey[0], skey[1], n, n, tables.tile_aabb.shape[0],
            fused.EMIT_MODES.index(emit), 0, None, *_resolve_args(tables, mh.tri, cfg),
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


def _tex_surfaces(mode):
    """A textured scene of 32x24 and, per bounce, its resolved surface as
    the shade kernel takes it in ``mode``: yields (prim_static, paths,
    (mesh_t, normal, mat, albedo), shade key, n) over three bounces, chained
    through the plain shade."""
    name = "cornell_mesh_textured_local.json" if mode == "textured" else \
        "cornell_prim_textured_local.json"
    scene = set_resolution(load_scene(str(REPO / "scenes" / name)), 32, 24)
    dev, static = build_device_scene(scene, "cpu")
    cam = camera_state(derive_render_camera(scene.state.camera))
    cfg = RenderConfig()
    n = static.pixel_count
    idx = torch.arange(n, dtype=torch.int32)
    ik = prng.iteration_key(prng.prng_key(0), 1)
    paths = camera_ops.generate_camera_rays(
        cam, static.width, static.height, static.trace_depth,
        prng.uniforms_at(prng.stage_key(ik, 0, 0), idx, 4, n), idx=idx,
    )
    prim_static = dataclasses.replace(static, num_triangles=0)
    for d in range(3):
        if mode == "textured":
            tl = prim_t_min(static, cfg, paths.origin, paths.direction)
            surf = fused.textured_mesh_surface(dev, static, cfg, paths, tl)
        else:
            isect = intersect_scene(dev, static, paths, cfg)
            mid = torch.clamp(isect.material_id, 0, static.num_materials - 1)
            alb, nrm = shade_ops.textured_surface(
                dev, static, isect, mid, Vec3(*(c[mid.long()] for c in dev.materials.color)),
                live=paths.alive & (isect.t > 0.0))
            surf = (isect.t, nrm, isect.material_id, alb)
        skey = prng.stage_key(ik, d, 1)
        yield prim_static, paths, surf, skey, n
        paths = fused.fused_mesh_shade_plain(prim_static, cfg, paths, *surf[:3], skey, n,
                                             mode=mode, mesh_albedo=surf[3])


@pytest.mark.parametrize("mode", ["textured", "precomputed"])
def test_host_mesh_shade_modes_match_plain(mesh_lib, mode):
    """The shade body in modes "textured" (the textured mesh scene) and
    "precomputed" (the textured-prim scene) against the plain version on
    the resolved surfaces of three chained bounces."""
    cfg = RenderConfig()
    textured_lanes = 0
    for prim_static, paths, (mt, mn, mm, alb), skey, n in _tex_surfaces(mode):
        want = fused.fused_mesh_shade_plain(prim_static, cfg, paths, mt, mn, mm, skey, n,
                                            mode=mode, mesh_albedo=alb)
        scene = fused.scene_struct(prim_static, cfg)
        f_in = [*paths.origin, *paths.direction, *paths.color]
        f_out = [torch.empty(n) for _ in range(9)]
        b_out = torch.empty(n, dtype=torch.int32)
        c = lambda x: x.contiguous()
        mesh_n, mesh_a = [c(x) for x in mn], [c(x) for x in alb]
        mt_c, mm_c = c(mt), c(mm)
        mesh_lib.ptt_host_mesh_shade(
            ctypes.byref(scene), _ptrs(f_in), paths.bounces.data_ptr(),
            paths.pixel.data_ptr(), mt_c.data_ptr(), _ptrs(mesh_n), mm_c.data_ptr(),
            None, None, None, _ptrs(f_out), b_out.data_ptr(), None, None,
            skey[0], skey[1], n, n, 0, 0, fused.SHADE_MODES.index(mode), _ptrs(mesh_a),
            None, None, 0, 0.0,
        )
        np.testing.assert_array_equal(b_out.numpy(), want.bounces.numpy())
        for got, exp in zip(f_out, [*want.origin, *want.direction, *want.color]):
            np.testing.assert_allclose(got.numpy(), exp.numpy(), rtol=1e-5, atol=1e-6)
        textured_lanes += int(((mm >= 0) & paths.alive).sum()) if mode == "textured" else \
            int((alb.y != alb.x).sum())
    assert textured_lanes > 20


def _resolve_args(tables, tri, cfg):
    """The shade body's mode "plain" arguments: the winners, the rows, their
    count and the |det| floor."""
    rows = tables.attrs_shade
    return tri.contiguous().data_ptr(), rows.data_ptr(), rows.shape[0], cfg.baby_epsilon


def _host_shade(lib, prim_static, cfg, paths, surf, skey, n, emit, tables, mode, win):
    """The shade body with the carried winner (``ptt_host_mesh_shade_win``;
    ``win`` None: every prim tested) on one state; ``surf`` the kernel's
    mesh inputs: (t, None, tri) in mode "plain", else (t, normal, material,
    albedo).  Returns the output planes (origin, direction, color), bounces,
    t_lim, key and winner."""
    c = lambda x: x.contiguous()
    plain = mode == "plain"
    mt = c(surf[0])
    mn = None if plain else _ptrs([c(x) for x in surf[1]])
    mm = None if plain else c(surf[2]).data_ptr()
    alb = None if plain else _ptrs([c(x) for x in surf[3]])
    resolve = _resolve_args(tables, surf[2], cfg) if plain else (None, None, 0, 0.0)
    f_in = [*paths.origin, *paths.direction, *paths.color]
    f_out = [torch.empty(n) for _ in range(9)]
    b_out = torch.empty(n, dtype=torch.int32)
    tl_out = torch.empty(n)
    key_out = torch.zeros(n, dtype=torch.int32)
    win_out = torch.empty(n, dtype=torch.int32)
    win_in = None if win is None else c(win)
    key = emit == "tlim+key"
    lib.ptt_host_mesh_shade_win(
        ctypes.byref(fused.scene_struct(prim_static, cfg)), _ptrs(f_in),
        paths.bounces.data_ptr(), paths.pixel.data_ptr(), mt.data_ptr(), mn,
        mm, tables.tile_aabb.data_ptr() if key else None,
        tables.root_box.data_ptr() if key else None,
        tables.center.data_ptr() if key else None, _ptrs(f_out), b_out.data_ptr(),
        tl_out.data_ptr(), key_out.data_ptr(), skey[0], skey[1], n, n,
        tables.tile_aabb.shape[0], fused.EMIT_MODES.index(emit), fused.SHADE_MODES.index(mode),
        alb, None if win_in is None else win_in.data_ptr(), win_out.data_ptr(), *resolve,
    )
    return f_out, b_out, tl_out, key_out, win_out


def _bits_equal(got, want):
    for a, b in zip(got, want):
        a = a.view(torch.int32) if a.dtype == torch.float32 else a
        b = b.view(torch.int32) if b.dtype == torch.float32 else b
        assert torch.equal(a, b)


@pytest.mark.parametrize("emit", ["tlim", "tlim+key"])
@pytest.mark.parametrize("mode", ["plain", "textured"])
def test_host_mesh_shade_carried_winner(mesh_lib, mode, emit):
    """Three chained bounces through the shade body, each fed the one
    before's emitted rays, t_lim and prim winner (the first the torch
    prepass's, ``prim_t_min(..., winner=True)``), as the main path chains
    them: with the carried winner the outputs equal those of the body that
    tests every prim bit for bit, the emitted winner is the one
    ``prim_t_min`` finds on the scattered rays (its t within the shade
    tolerance: the body built for the host and torch's CPU kernels may part
    in the last bit of a transformed point), and the plain version
    (without the winner) agrees to this file's shade tolerance."""
    name = "cornell_mesh_5k.json" if mode == "plain" else "cornell_mesh_textured_local.json"
    scene = set_resolution(load_scene(str(REPO / "scenes" / name)), 32, 24)
    dev, static = build_device_scene(scene, "cpu")
    cam = camera_state(derive_render_camera(scene.state.camera))
    cfg = RenderConfig()
    n = static.pixel_count
    idx = torch.arange(n, dtype=torch.int32)
    ik = prng.iteration_key(prng.prng_key(0), 1)
    paths = camera_ops.generate_camera_rays(
        cam, static.width, static.height, static.trace_depth,
        prng.uniforms_at(prng.stage_key(ik, 0, 0), idx, 4, n), idx=idx,
    )
    prim_static = dataclasses.replace(static, num_triangles=0)
    tables = dev.mxu_mesh
    tl, win = prim_t_min(static, cfg, paths.origin, paths.direction, winner=True)
    carried = 0
    for d in range(3):
        if mode == "plain":
            mh = fused.mesh_walk(tables, static, cfg, paths, tl)
            surf = (mh.t, None, mh.tri)
        else:
            surf = fused.textured_mesh_surface(dev, static, cfg, paths, tl)
        skey = prng.stage_key(ik, d, 1)
        args = (mesh_lib, prim_static, cfg, paths, surf, skey, n, emit, tables, mode)
        f_out, b_out, tl_out, key_out, win_out = _host_shade(*args, win)
        ref = _host_shade(*args, None)
        _bits_equal([*f_out, b_out, tl_out, key_out, win_out], [*ref[0], *ref[1:]])
        out_o, out_d = Vec3(*f_out[0:3]), Vec3(*f_out[3:6])
        tl_t, win_t = prim_t_min(prim_static, cfg, out_o, out_d, winner=True)
        assert torch.equal(win_out, win_t)
        np.testing.assert_allclose(tl_out.numpy(), tl_t.numpy(), rtol=1e-5)
        plain = mode == "plain"
        want_p, (want_tl, want_key, _) = fused.fused_mesh_shade_plain(
            prim_static, cfg, paths, surf[0], surf[1], None if plain else surf[2], skey, n,
            emit, tables, mode=mode, mesh_albedo=None if plain else surf[3],
            mesh_tri=surf[2] if plain else None)
        np.testing.assert_array_equal(b_out.numpy(), want_p.bounces.numpy())
        for got, exp in zip(f_out, [*want_p.origin, *want_p.direction, *want_p.color]):
            np.testing.assert_allclose(got.numpy(), exp.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tl_out.numpy(), want_tl.numpy(), rtol=1e-5)
        carried += int((paths.alive & (surf[2] < 0) & (win >= 0)).sum())
        paths = want_p._replace(origin=out_o, direction=out_d, color=Vec3(*f_out[6:9]),
                                bounces=b_out)
        tl, win = tl_out, win_out
    assert carried > 100


def test_host_mesh_shade_winner_crafted(mesh_lib, mesh_scene):
    """``tests/torch_fixtures.py::winner_case``: a two-sphere tie at equal
    t, origins inside a cube, origins within ray_eps of its face, rays that
    hit no prim, made-up mesh hits and dead lanes.  The winner is the lower
    sphere on a tie, the cube from inside and from within eps (t still
    positive), -1 on a miss; with it the shade body's outputs equal those of
    the body that tests every prim bit for bit, over two chained bounces."""
    _, static, _ = mesh_scene
    cfg = RenderConfig()
    prim_static, paths, mt, tri = winner_case(static, np.random.default_rng(5))
    n, q, k = paths.pixel.shape[0], paths.pixel.shape[0] // 4, len(static.geoms)
    tl, win = prim_t_min(prim_static, cfg, paths.origin, paths.direction, winner=True)
    free = paths.alive & (tri < 0)
    assert int((win[:q] == k)[free[:q]].sum()) > 100  # the lower of the tied spheres
    assert not bool((win == k + 1).any())
    assert bool((win[q:3 * q] == k + 2).all())  # the cube, from inside and within eps
    assert bool((tl[2 * q:3 * q] > 0).all()) and float(tl[2 * q:3 * q].max()) < 1e-3
    assert bool((win[3 * q:] == -1).all())
    ik = prng.iteration_key(prng.prng_key(3), 2)
    surf = (mt, None, tri)
    tables = mesh_scene[0].mxu_mesh
    for d in range(2):
        args = (mesh_lib, prim_static, cfg, paths, surf, prng.stage_key(ik, d, 1), n, "tlim",
                tables, "plain")
        got = _host_shade(*args, win)
        ref = _host_shade(*args, None)
        _bits_equal([*got[0], *got[1:]], [*ref[0], *ref[1:]])
        paths = paths._replace(origin=Vec3(*got[0][0:3]), direction=Vec3(*got[0][3:6]),
                               color=Vec3(*got[0][6:9]), bounces=got[1])
        tl, win = got[2], got[4]
        surf = (mt, None, torch.full_like(tri, -1))


def _torch_key(tables, paths, tl):
    """The key the torch glue builds (``intersect_mxu.sort_key`` in mode
    "signature": ``signature_key``)."""
    cfg = RenderConfig()
    return intersect_mxu.sort_key(tables, paths.origin, paths.direction, paths.alive, tl,
                                  cfg.ray_sort_bits, cfg.ray_sort_dir_bits, mode="signature")


@pytest.mark.parametrize("ct", [25, 196, 1000])
@pytest.mark.parametrize("body", ["host key", "host prelude", "plain prelude"])
def test_key_at_any_tile_count(mesh_lib, mesh_scene, body, ct):
    """The sort key the kernels emit at any tile count, against the torch
    glue's (``_torch_key``) bit for bit, on ``key_case``'s rays: random,
    axis-parallel, root misses, grazing tile 0's face, starting among the
    boxes, and dead.  "host key": ``coherence_key`` built for the host,
    with its early exit for the rays that are not live; "host prelude":
    the prelude kernel's body (t_lim, winner and key of the rays as they
    are) against ``prim_t_min(..., winner=True)`` and the torch key on its
    t_lim (the t within the shade tolerance: the host's and torch's
    transformed points may part in the last bit; the key equal wherever the
    t is); "plain prelude": ``mesh_prelude_plain`` against the same,
    exactly."""
    dev, static, _ = mesh_scene
    cfg = RenderConfig()
    prim_static = dataclasses.replace(static, num_triangles=0)
    tables, paths, tl = key_case(ct, dev.mxu_mesh.center.numpy(), np.random.default_rng(ct))
    n = paths.pixel.shape[0]
    rays = [p.contiguous() for p in (*paths.origin, *paths.direction)]
    if body != "host key":
        tl, win = prim_t_min(prim_static, cfg, paths.origin, paths.direction, winner=True)
    want = _torch_key(tables, paths, tl)
    boxes = (tables.tile_aabb.data_ptr(), tables.root_box.data_ptr(), tables.center.data_ptr())
    live = want < (1 << 30)
    assert int(live.sum()) > n // 4 and int((want == 1 << 30).sum()) > n // 16
    assert int((want == intersect_mxu.DEAD_KEY).sum()) == n // 8
    if body == "host key":
        got = torch.empty(n, dtype=torch.int32)
        alive = paths.alive.to(torch.uint8)
        mesh_lib.ptt_host_coherence_key(boxes[0], ct, *boxes[1:], _ptrs(rays), alive.data_ptr(),
                                        tl.data_ptr(), n, got.data_ptr())
        assert torch.equal(got, want)
    elif body == "host prelude":
        got_tl, got_win = torch.empty(n), torch.empty(n, dtype=torch.int32)
        got = torch.empty(n, dtype=torch.int32)
        mesh_lib.ptt_host_mesh_prelude(
            ctypes.byref(fused.scene_struct(prim_static, cfg)), _ptrs(rays),
            paths.bounces.data_ptr(), *boxes, got_tl.data_ptr(), got.data_ptr(),
            got_win.data_ptr(), n, ct, fused.EMIT_MODES.index("tlim+key"))
        assert torch.equal(got_win, win)
        np.testing.assert_allclose(got_tl.numpy(), tl.numpy(), rtol=1e-5)
        same = got_tl == tl
        assert int(same.sum()) > n * 9 // 10
        assert torch.equal(got[same], want[same])
    else:
        got_tl, got, got_win = fused.mesh_prelude_plain(prim_static, cfg, paths, tables)
        _bits_equal([got_tl, got, got_win], [tl, want, win])
        assert fused.mesh_prelude(prim_static, cfg, paths).key is None


@pytest.fixture(scope="module")
def scan_lib(tmp_path_factory):
    lib = build_host(tmp_path_factory, SCAN_HARNESS, "libscan_host.so")
    lib.ptt_host_scan.argtypes = [P, P, P, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32]
    return lib


def host_scan(lib, x: torch.Tensor, inclusive: bool):
    """ptt_launch_scan's two kernels on the host -> (out [N], tile totals)."""
    from project3_cuda_path_tracer_2025_tpu_torch.ops import scan

    n = x.shape[0]
    out = torch.empty_like(x)
    tot = torch.full(((n + scan.KERNEL_TILE - 1) // scan.KERNEL_TILE,), -1, dtype=x.dtype)
    lib.ptt_host_scan(x.data_ptr(), out.data_ptr(), tot.data_ptr(), n,
                      scan.KERNEL_DTYPES.index(x.dtype), int(inclusive))
    return out, tot


@pytest.mark.parametrize("kind", ["flags", "ints", "floats", "flags-int32", "ints-int32"])
def test_host_scan_body_matches_plain(scan_lib, kind):
    """The whole-array scan of csrc/scan.cu (the tile totals, each tile's
    carry from the totals below it, the threads of a block in lockstep)
    against ``scan_flat_plain`` (torch.cumsum), inclusive and exclusive, on
    six tiles and a ragged end and on a single short tile: integer values
    exact in either dtype, floats within rtol=1e-6; each tile total is the
    tile's own sum."""
    from project3_cuda_path_tracer_2025_tpu_torch.ops import scan

    rng = np.random.default_rng(5)
    values, _, dtype = kind.partition("-")
    for n in (scan.KERNEL_TILE * 5 + 777, 1000):
        x = {"flags": lambda: rng.random(n) > 0.5,
             "ints": lambda: rng.integers(0, 200, n),
             "floats": lambda: rng.random(n)}[values]()
        xt = torch.from_numpy(np.ascontiguousarray(x, dtype or "float32"))
        for inclusive in (False, True):
            got, tot = host_scan(scan_lib, xt, inclusive)
            want = scan.scan_flat_plain(xt, inclusive)
            if values == "floats":
                np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
            else:
                assert torch.equal(got, want), (n, inclusive)
        sums = [xt[i:i + scan.KERNEL_TILE].double().sum() for i in range(0, n, scan.KERNEL_TILE)]
        if len(sums) > 1:
            np.testing.assert_allclose(tot.double().numpy(), np.array(sums), rtol=1e-6)
        else:
            assert int(tot[0]) == -1  # one tile: no totals pass


# ---------------------------------------------------------------------------
# The walk and binned kernels' bodies (csrc/mesh_path.cuh, csrc/mesh_walk.cu)
# ---------------------------------------------------------------------------

def _host_walk(lib, tables, ro, rd, live, tlim, plan, exit_, eps=1e-5):
    n = ro.x.shape[0]
    out_t = torch.empty(n)
    out_tri = torch.empty(n, dtype=torch.int32)
    rays = [p.contiguous() for p in (*ro, *rd)]
    lv, tlc = live.to(torch.uint8).contiguous(), tlim.contiguous()  # held across the call
    lib.ptt_host_walk(
        tables.coef.data_ptr(), tables.tile_aabb.data_ptr(), tables.tile_aabb.shape[0],
        tables.center.data_ptr(), _ptrs(rays), lv.data_ptr(), tlc.data_ptr(),
        plan.ids.data_ptr(), plan.tlo.data_ptr(), plan.cnt.data_ptr(), exit_, eps,
        float(np.nextafter(np.float32(eps), np.float32(np.inf))), n, out_t.data_ptr(),
        out_tri.data_ptr(),
    )
    return out_t, out_tri


@pytest.fixture(scope="module")
def walk_lib(mesh_lib):
    mesh_lib.ptt_host_walk.argtypes = (
        [P, P, ctypes.c_int32, P, P, P, P, P, P, P, ctypes.c_int32, ctypes.c_float,
         ctypes.c_float, ctypes.c_int32, P, P]
    )
    mesh_lib.ptt_host_streamed_block.argtypes = mesh_lib.ptt_host_walk.argtypes
    mesh_lib.ptt_host_binned.argtypes = (
        [P] * 8 + [ctypes.c_int32] * 3 + [ctypes.c_float] * 2 + [P, P]
    )
    return mesh_lib


def _walk_cases():
    """The 20k mesh's camera rays (32x24 = 3 blocks) with the prim t as
    t_limit, and the two-tile tie mesh's rays."""
    from torch_compare import mesh_tables_pair, tie_mesh

    scene = set_resolution(load_scene(str(REPO / "scenes" / "cornell_mesh_20k.json")), 32, 24)
    dev, static = build_device_scene(scene, "cpu")
    cam = camera_state(derive_render_camera(scene.state.camera))
    n = static.pixel_count
    idx = torch.arange(n, dtype=torch.int32)
    ik = prng.iteration_key(prng.prng_key(0), 1)
    paths = camera_ops.generate_camera_rays(
        cam, static.width, static.height, static.trace_depth,
        prng.uniforms_at(prng.stage_key(ik, 0, 0), idx, 4, n), idx=idx,
    )
    tl = prim_t_min(static, RenderConfig(), paths.origin, paths.direction)
    yield "20k", dev.mxu_mesh, paths.origin, paths.direction, torch.ones(n, dtype=torch.bool), tl
    pos, o, d, lim = tie_mesh(np.random.default_rng(60), 900)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    yield ("tie", mesh_tables_pair(pos)[1], Vec3(*(t(o[:, i]) for i in range(3))),
           Vec3(*(t(d[:, i]) for i in range(3))), torch.ones(900, dtype=torch.bool), t(lim))


def _plan_for(tables, ro, rd, live, tl):
    return intersect_mxu.build_tile_plan(
        tables.tile_aabb, *intersect_mxu.plan_rays(tables, ro, rd, live, tl))


def test_host_walks_match_plain(walk_lib):
    """The walk body in the kernels' block schedule, without (#5) and with
    (#6, #7) the early exit: t and tri equal to walk_plain's; on the tie
    mesh also to the JAX package's planned walk (``mesh_intersect_mxu``
    with ``planned=True`` in interpret mode) and to the lower copy's id."""
    import jax.numpy as jnp

    from project3_cuda_path_tracer_2025_tpu.ops.intersect_mxu import mesh_intersect_mxu as j_mxu
    from project3_cuda_path_tracer_2025_tpu.utils.vec import Vec3 as JVec3
    from torch_compare import TIE_TRIS, mesh_tables_pair, tie_mesh

    for name, tables, ro, rd, active, tl in _walk_cases():
        live = active & intersect_mxu.root_hit_mask(tables, ro, rd, tl)
        plan = _plan_for(tables, ro, rd, live, tl)
        want_t, want_tri = intersect_mxu.walk_plain(tables, ro, rd, live, tl, plan, 1e-5)
        assert (want_tri >= 0).sum() > 20
        for exit_ in (0, 1):
            got_t, got_tri = _host_walk(walk_lib, tables, ro, rd, live, tl, plan, exit_)
            assert torch.equal(got_tri, want_tri), (name, exit_)
            assert torch.equal(got_t, want_t), (name, exit_)
        if name == "tie":
            pos, o, d, lim = tie_mesh(np.random.default_rng(60), 900)
            jt = mesh_tables_pair(pos)[0]
            j3 = lambda a: JVec3(*[jnp.asarray(a[:, i]) for i in range(3)])
            jr = j_mxu(jt, 2048, 2048, j3(o), j3(d), jnp.ones(900, bool), jnp.asarray(lim),
                       1e-5, interpret=True, planned=True, planned_epilogue="running")
            np.testing.assert_array_equal(got_tri.numpy(), np.asarray(jr.tri))
            np.testing.assert_array_equal(got_t.numpy(), np.asarray(jr.t))
            assert set(np.unique(got_tri.numpy()[got_tri.numpy() >= 0])) == {TIE_TRIS[0]}


def _streamed_case(name):
    """A walk case with its live mask and plan.  "limit": the tie mesh with
    every other hit ray's t_limit moved onto its own closest hit, which then
    lies at exactly t_limit on both tiles and must not replace (t_limit,
    -1)."""
    _, tables, ro, rd, active, tl = next(c for c in _walk_cases()
                                         if c[0] == ("tie" if name == "limit" else name))
    if name == "limit":
        live = active & intersect_mxu.root_hit_mask(tables, ro, rd, tl)
        t, tri = intersect_mxu.walk_plain(tables, ro, rd, live, tl,
                                          _plan_for(tables, ro, rd, live, tl), 1e-5)
        moved = (tri >= 0) & (torch.arange(tl.shape[0]) % 2 == 0)
        tl = torch.where(moved, t, tl)
    live = active & intersect_mxu.root_hit_mask(tables, ro, rd, tl)
    return tables, ro, rd, live, tl, _plan_for(tables, ro, rd, live, tl)


@pytest.fixture(scope="module")
def spread_libs(walk_lib, tmp_path_factory):
    """The harness at each block width of the streamed kernel: the default
    (512 threads, two triangles a thread), 256 and 1,024."""
    i32, f32_ = ctypes.c_int32, ctypes.c_float
    walk_lib.ptt_host_sweep_block.argtypes = [P, P, i32, P, P, P, P, f32_, f32_, i32, P, P]
    walk_lib.ptt_host_super_block.argtypes = (
        [P, P, P, i32, i32] + [P] * 7 + [f32_, f32_, i32, P, P])
    walk_lib.ptt_host_mono_block.argtypes = walk_lib.ptt_host_mono.argtypes
    walk_lib.ptt_host_binned_block.argtypes = walk_lib.ptt_host_binned.argtypes
    libs = {512: walk_lib}
    for w in (256, 1024):
        libs[w] = build_host(tmp_path_factory, MESH_HARNESS, f"libmesh_path_host_{w}.so",
                             defines=[f"-DPTT_SPREAD_THREADS={w}"])
        for f in ("ptt_host_streamed_block", "ptt_host_sweep_block", "ptt_host_super_block",
                  "ptt_host_mono_block", "ptt_host_binned_block"):
            getattr(libs[w], f).argtypes = getattr(walk_lib, f).argtypes
    return libs


@pytest.mark.parametrize("threads", [256, 512, 1024])
@pytest.mark.parametrize("name", ["20k", "tie", "limit"])
def test_host_streamed_block_schedule_matches_plain(walk_lib, spread_libs, name, threads):
    """ptt_streamed_kernel's block schedule at three block widths (takers
    listed by ballot order, each thread's 1,024 / width triangles against
    every taker, per-ray 64-bit key minimum): t and tri equal to
    walk_plain's and to the per-ray walk's, equal-t ties across the tie
    mesh's two tiles to the lower copy, and a hit at exactly t_limit left at
    (t_limit, -1)."""
    tables, ro, rd, live, tl, plan = _streamed_case(name)
    n = ro.x.shape[0]
    want_t, want_tri = intersect_mxu.walk_plain(tables, ro, rd, live, tl, plan, 1e-5)
    got_t, got_tri = torch.empty(n), torch.empty(n, dtype=torch.int32)
    rays = [p.contiguous() for p in (*ro, *rd)]
    lv, tlc = live.to(torch.uint8).contiguous(), tl.contiguous()
    spread_libs[threads].ptt_host_streamed_block(
        tables.coef.data_ptr(), tables.tile_aabb.data_ptr(), tables.tile_aabb.shape[0],
        tables.center.data_ptr(), _ptrs(rays), lv.data_ptr(), tlc.data_ptr(),
        plan.ids.data_ptr(), plan.tlo.data_ptr(), plan.cnt.data_ptr(), 1, *_eps_args(), n,
        got_t.data_ptr(), got_tri.data_ptr())
    assert torch.equal(got_tri, want_tri) and torch.equal(got_t, want_t)
    per_ray = _host_walk(walk_lib, tables, ro, rd, live, tl, plan, 1)
    assert torch.equal(got_tri, per_ray[1]) and torch.equal(got_t, per_ray[0])
    _check_limit_and_tie(name, got_t, got_tri, tl, live, want_tri)


@pytest.mark.parametrize("exit_", [0, 1])
@pytest.mark.parametrize("threads", [256, 512, 1024])
@pytest.mark.parametrize("name", ["20k", "tie", "limit"])
def test_host_planned_block_schedule_matches_plain(walk_lib, spread_libs, name, threads,
                                                   exit_):
    """The block schedule of ptt_planned_lanebest_kernel (exit 0: every plan
    entry, no vote) and ptt_planned_kernel (exit 1: #7's exit vote; the
    kernels differ from #7 only in where the tile boxes are read), at three
    block widths: t and tri equal to walk_plain's and to the per-ray walk's
    without and with the exit, ties to the lower copy, a hit at exactly
    t_limit left at (t_limit, -1)."""
    tables, ro, rd, live, tl, plan = _streamed_case(name)
    n = ro.x.shape[0]
    want_t, want_tri = intersect_mxu.walk_plain(tables, ro, rd, live, tl, plan, 1e-5)
    got_t, got_tri = torch.empty(n), torch.empty(n, dtype=torch.int32)
    rays = [p.contiguous() for p in (*ro, *rd)]
    lv, tlc = live.to(torch.uint8).contiguous(), tl.contiguous()
    spread_libs[threads].ptt_host_streamed_block(
        tables.coef.data_ptr(), tables.tile_aabb.data_ptr(), tables.tile_aabb.shape[0],
        tables.center.data_ptr(), _ptrs(rays), lv.data_ptr(), tlc.data_ptr(),
        plan.ids.data_ptr(), plan.tlo.data_ptr(), plan.cnt.data_ptr(), exit_, *_eps_args(), n,
        got_t.data_ptr(), got_tri.data_ptr())
    assert torch.equal(got_tri, want_tri) and torch.equal(got_t, want_t)
    per_ray = _host_walk(walk_lib, tables, ro, rd, live, tl, plan, exit_)
    assert torch.equal(got_tri, per_ray[1]) and torch.equal(got_t, per_ray[0])
    _check_limit_and_tie(name, got_t, got_tri, tl, live, want_tri)


def _check_limit_and_tie(name, got_t, got_tri, tl, live, want_tri):
    """The "limit" case's hits at exactly t_limit left at (t_limit, -1), the
    tie mesh's ties with the lower copy."""
    from torch_compare import TIE_TRIS

    n = got_t.shape[0]
    if name == "limit":
        moved = torch.arange(n) % 2 == 0
        at_limit = moved & live & (got_t == tl)
        assert int(at_limit.sum()) > 100 and (got_tri[at_limit] == -1).all()
        assert (got_tri[~moved] >= 0).sum() > 100
    else:
        assert (want_tri >= 0).sum() > 20
    if name == "tie":
        assert set(got_tri[got_tri >= 0].tolist()) == {TIE_TRIS[0]}


@pytest.mark.parametrize("threads", [256, 512, 1024])
@pytest.mark.parametrize("name", ["20k", "tie", "limit"])
def test_host_sweep_block_schedule_matches_plain(walk_lib, slice5_lib, spread_libs, name,
                                                 threads):
    """ptt_sweep_kernel's block schedule (every tile in ascending id through
    the shared per-entry body, no exit vote) at three block widths: t and
    tri equal to sweep_intersect_plain's and to the per-ray sweep's, ties to
    the lower copy, a hit at exactly t_limit left at (t_limit, -1)."""
    tables, ro, rd, live, tl, _ = _streamed_case(name)
    n = ro.x.shape[0]
    want_t, want_tri = intersect_mxu.sweep_intersect_plain(tables, ro, rd, live, tl, 1e-5)
    rays = [p.contiguous() for p in (*ro, *rd)]
    lv, tlc = live.to(torch.uint8).contiguous(), tl.contiguous()
    got, per_ray = [(torch.empty(n), torch.empty(n, dtype=torch.int32)) for _ in range(2)]
    for fn, (t, tri) in ((spread_libs[threads].ptt_host_sweep_block, got),
                         (slice5_lib.ptt_host_sweep, per_ray)):
        fn(tables.coef.data_ptr(), tables.tile_aabb.data_ptr(), tables.tile_aabb.shape[0],
           tables.center.data_ptr(), _ptrs(rays), lv.data_ptr(), tlc.data_ptr(), *_eps_args(),
           n, t.data_ptr(), tri.data_ptr())
    got_t, got_tri = got
    assert torch.equal(got_tri, want_tri) and torch.equal(got_t, want_t)
    assert torch.equal(got_tri, per_ray[1]) and torch.equal(got_t, per_ray[0])
    _check_limit_and_tie(name, got_t, got_tri, tl, live, want_tri)


@pytest.mark.parametrize("threads", [256, 512, 1024])
@pytest.mark.parametrize("name", ["20k", "tie", "limit"])
def test_host_super_block_schedule_matches_plain(walk_lib, slice5_lib, spread_libs, name,
                                                 threads):
    """ptt_streamed_super_kernel's block schedule (per super entry the exit
    vote and the super gate, then each member tile through the shared
    per-entry body) at three block widths, over the tables as they are and
    padded to whole super-tiles (20 tiles -> 24; 2 -> 8): t and tri equal to
    streamed_super_plain's and to the per-ray super walk's, ties to the
    lower copy, a hit at exactly t_limit left at (t_limit, -1)."""
    from torch_fixtures import pad_to_supers

    base, ro, rd, live, tl, _ = _streamed_case(name)
    n = ro.x.shape[0]
    rays = [p.contiguous() for p in (*ro, *rd)]
    lv, tlc = live.to(torch.uint8).contiguous(), tl.contiguous()
    for tables in (base, pad_to_supers(base)):
        saabb = intersect_mxu.super_aabb(tables.tile_aabb)
        ct, cs = tables.tile_aabb.shape[0], saabb.shape[0]
        splan = intersect_mxu.build_tile_plan(
            saabb, *intersect_mxu.plan_rays(tables, ro, rd, live, tl))
        want_t, want_tri = intersect_mxu.streamed_super_plain(tables, ro, rd, live, tl, splan,
                                                              1e-5)
        got, per_ray = [(torch.empty(n), torch.empty(n, dtype=torch.int32)) for _ in range(2)]
        for fn, (t, tri) in ((spread_libs[threads].ptt_host_super_block, got),
                             (slice5_lib.ptt_host_super, per_ray)):
            fn(tables.coef.data_ptr(), tables.tile_aabb.data_ptr(), saabb.data_ptr(), ct, cs,
               tables.center.data_ptr(), _ptrs(rays), lv.data_ptr(), tlc.data_ptr(),
               splan.ids.data_ptr(), splan.tlo.data_ptr(), splan.cnt.data_ptr(), *_eps_args(),
               n, t.data_ptr(), tri.data_ptr())
        got_t, got_tri = got
        assert torch.equal(got_tri, want_tri) and torch.equal(got_t, want_t), ct
        assert torch.equal(got_tri, per_ray[1]) and torch.equal(got_t, per_ray[0]), ct
        _check_limit_and_tie(name, got_t, got_tri, tl, live, want_tri)


def _mono_case(name, mesh_scene):
    """A mono case: (tables, num_tris, ro, rd, active, t_limit).  "5k": the
    5k mesh's camera rays and 3,000 rays shot at it from a sphere around it
    (3,768 rays: the last block holds 184), a fifth of them inactive, every
    fifth sphere ray turned away from the mesh (root-culled), random
    t_limits; "clamp": the same with num_tris cut to the median id of the
    hits, so that a ray's best id may lie at or past it; "tie" and "limit":
    the two-tile tie mesh as the walks take it (the kernel takes the root
    cull itself, so every ray is active)."""
    if name in ("tie", "limit"):
        tables, ro, rd, _, tl, _ = _streamed_case(name)
        return tables, 2048, ro, rd, torch.ones(tl.shape[0], dtype=torch.bool), tl
    dev, static, cam = mesh_scene
    n = static.pixel_count
    idx = torch.arange(n, dtype=torch.int32)
    ik = prng.iteration_key(prng.prng_key(0), 1)
    paths = camera_ops.generate_camera_rays(
        cam, static.width, static.height, static.trace_depth,
        prng.uniforms_at(prng.stage_key(ik, 0, 0), idx, 4, n), idx=idx)
    rng = np.random.default_rng(3)
    m = 3000
    c = dev.mxu_mesh.center.numpy().astype(np.float64)
    o = rng.normal(size=(m, 3))
    o = c + 4.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = c + rng.uniform(-1.5, 1.5, (m, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::5] *= -1.0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    ro = Vec3(*(torch.cat([a, t(o[:, i])]) for i, a in enumerate(paths.origin)))
    rd = Vec3(*(torch.cat([a, t(d[:, i])]) for i, a in enumerate(paths.direction)))
    active = torch.from_numpy(rng.random(n + m) > 0.2)
    tl = torch.cat([prim_t_min(static, RenderConfig(), paths.origin, paths.direction),
                    t(np.where(rng.random(m) > 0.5, 3.4e38, rng.uniform(2.0, 6.0, m)))])
    num_tris = static.num_triangles
    if name == "clamp":
        _, tri = intersect_mxu.mono_intersect_plain(dev.mxu_mesh, num_tris, ro, rd, active, tl,
                                                    1e-5)
        num_tris = int(tri[tri >= 0].median())
    return dev.mxu_mesh, num_tris, ro, rd, active, tl


@pytest.mark.parametrize("threads", [256, 512, 1024])
@pytest.mark.parametrize("name", ["5k", "clamp", "tie", "limit"])
def test_host_mono_block_schedule_matches_plain(mesh_lib, mesh_scene, spread_libs, name,
                                                threads):
    """ptt_mono_kernel's block schedule (the sweep's loop over at most 8
    tiles, each ray's root cull in its live flag, a dead block skipped, the
    num_tris clamp after the minimum) at three block widths: t and tri
    bit-equal to mono_intersect_plain's and to the per-ray mono walk's;
    root-culled and inactive rays at (t_limit, -1); with num_tris cut, rays
    whose best id lies past it at (t, -1); ties across the tie mesh's two
    tiles to the lower copy; a hit at exactly t_limit left at (t_limit,
    -1)."""
    tables, num_tris, ro, rd, active, tl = _mono_case(name, mesh_scene)
    n = ro.x.shape[0]
    want_t, want_tri = intersect_mxu.mono_intersect_plain(tables, num_tris, ro, rd, active, tl,
                                                          1e-5)
    rays = [p.contiguous() for p in (*ro, *rd)]
    act, tlc = active.to(torch.uint8).contiguous(), tl.contiguous()
    got, per_ray = [(torch.empty(n), torch.empty(n, dtype=torch.int32)) for _ in range(2)]
    for fn, (t, tri) in ((spread_libs[threads].ptt_host_mono_block, got),
                         (mesh_lib.ptt_host_mono, per_ray)):
        fn(tables.coef.data_ptr(), tables.tile_aabb.data_ptr(), tables.tile_aabb.shape[0],
           tables.root_box.data_ptr(), tables.center.data_ptr(), _ptrs(rays), act.data_ptr(),
           tlc.data_ptr(), num_tris, *_eps_args(), n, t.data_ptr(), tri.data_ptr())
    got_t, got_tri = got
    assert torch.equal(got_tri, want_tri) and torch.equal(got_t, want_t)
    assert torch.equal(got_tri, per_ray[1]) and torch.equal(got_t, per_ray[0])
    live = active & intersect_mxu.root_hit_mask(tables, ro, rd, tl)
    assert torch.equal(got_t[~live], tl[~live]) and (got_tri[~live] == -1).all()
    if name in ("5k", "clamp"):
        assert int((active & ~live).sum()) > 100  # root-culled rays
    if name == "clamp":
        assert int(((got_tri == -1) & (got_t < tl)).sum()) > 20  # hits past num_tris
    else:
        _check_limit_and_tie(name, got_t, got_tri, tl, live, want_tri)


@pytest.mark.parametrize("threads", [256, 512, 1024])
@pytest.mark.parametrize("name", ["20k", "tie", "limit"])
def test_host_binned_block_schedule_matches_plain(walk_lib, spread_libs, name, threads):
    """ptt_binned_kernel's block schedule (one spread_entry of the visit's
    tile against its 256 pair rows) at three block widths, over bins with
    empty visits (vt = -1) and empty slots (p = n_g): every pair row's (t,
    tri) bit-equal to binned_intersect_plain's and to the per-ray binned
    body's, the rows of empty visits and slots at (inf, -1); reduced per
    ray, ties across the tie mesh's two tiles to the lower copy, and a hit
    at exactly t_limit left at (inf, -1) in every row of its ray."""
    tables, ro, rd, live, tl, _ = _streamed_case(name)
    n = ro.x.shape[0]
    pr = intersect_mxu.plan_rays(tables, ro, rd, live, tl)
    n_pad = pr.tl.shape[0]
    n_g = n_pad // intersect_mxu.BINNED_G
    bins = intersect_mxu.packet_bins(
        tables.tile_aabb, *pr, intersect_mxu.pair_budget(n_pad, tables.tile_aabb.shape[0]), 128)
    assert not bool(bins.overflow)
    assert bool((bins.vt == -1).any()) and bool((bins.src == n_g).any())
    nv = bins.vt.shape[0]
    want_t, want_tri = intersect_mxu.binned_intersect_plain(
        tables, ro, rd, live, tl, bins.vt, bins.src, n_g, 1e-5)
    rays = [p.contiguous() for p in (*ro, *rd)]
    lv, tlc = live.to(torch.uint8).contiguous(), tl.contiguous()
    got, per_row = [(torch.empty(nv * 256), torch.empty(nv * 256, dtype=torch.int32))
                    for _ in range(2)]
    for fn, (t, tri) in ((spread_libs[threads].ptt_host_binned_block, got),
                         (walk_lib.ptt_host_binned, per_row)):
        fn(tables.coef.data_ptr(), tables.tile_aabb.data_ptr(), tables.center.data_ptr(),
           _ptrs(rays), lv.data_ptr(), tlc.data_ptr(), bins.vt.data_ptr(), bins.src.data_ptr(),
           n, n_g, nv, *_eps_args(), t.data_ptr(), tri.data_ptr())
    got_t, got_tri = got
    assert torch.equal(got_tri, want_tri) and torch.equal(got_t, want_t)
    assert torch.equal(got_tri, per_row[1]) and torch.equal(got_t, per_row[0])
    _, ray, ok = intersect_mxu._pair_rays(bins.vt, bins.src, n_g, n)
    assert torch.isinf(got_t[~ok]).all() and (got_tri[~ok] == -1).all()
    red_t, red_tri = intersect_mxu.binned_reduce(got_t, got_tri, bins, pr.tl, n_g)
    red_t, red_tri = red_t[:n], red_tri[:n]
    _check_limit_and_tie(name, red_t, red_tri, tl, live, red_tri)
    if name == "limit":
        at = (torch.arange(n) % 2 == 0) & live & (red_t == tl)
        rows = ok & at[torch.clamp(ray, max=n - 1)]
        assert int(rows.sum()) > 100
        assert torch.isinf(got_t[rows]).all() and (got_tri[rows] == -1).all()


def test_host_binned_matches_plain(walk_lib):
    """The binned pair body over bins of every packet: per pair row (t,
    tri) equal to binned_intersect_plain's."""
    for name, tables, ro, rd, active, tl in _walk_cases():
        n = ro.x.shape[0]
        live = active & intersect_mxu.root_hit_mask(tables, ro, rd, tl)
        pr = intersect_mxu.plan_rays(tables, ro, rd, live, tl)
        n_pad = pr.tl.shape[0]
        bins = intersect_mxu.packet_bins(
            tables.tile_aabb, *pr, intersect_mxu.pair_budget(n_pad, tables.tile_aabb.shape[0]),
            128)
        n_g, nv = n_pad // 8, bins.vt.shape[0]
        want_t, want_tri = intersect_mxu.binned_intersect_plain(
            tables, ro, rd, live, tl, bins.vt, bins.src, n_g, 1e-5)
        got_t = torch.empty(nv * 256)
        got_tri = torch.empty(nv * 256, dtype=torch.int32)
        eps = 1e-5
        rays = [p.contiguous() for p in (*ro, *rd)]
        lv, tlc = live.to(torch.uint8), tl.contiguous()  # held across the call
        walk_lib.ptt_host_binned(
            tables.coef.data_ptr(), tables.tile_aabb.data_ptr(), tables.center.data_ptr(),
            _ptrs(rays), lv.data_ptr(), tlc.data_ptr(), bins.vt.data_ptr(),
            bins.src.data_ptr(), n, n_g, nv, eps,
            float(np.nextafter(np.float32(eps), np.float32(np.inf))), got_t.data_ptr(),
            got_tri.data_ptr())
        assert (want_tri >= 0).sum() > 20, name
        assert torch.equal(got_tri, want_tri), name
        assert torch.equal(got_t, want_t), name


# ---------------------------------------------------------------------------
# The sweep, super-tile walk and plan prepass bodies
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def slice5_lib(walk_lib):
    i32, f32_ = ctypes.c_int32, ctypes.c_float
    walk_lib.ptt_host_sweep.argtypes = [P, P, i32, P, P, P, P, f32_, f32_, i32, P, P]
    walk_lib.ptt_host_super.argtypes = [P, P, P, i32, i32] + [P] * 7 + [f32_, f32_, i32, P, P]
    walk_lib.ptt_host_plan_prepass.argtypes = [P, i32, P, P, P, i32, P, P]
    walk_lib.ptt_host_plan_prepass_live.argtypes = [P, i32, P, P, P, i32, i32, P, P]
    return walk_lib


def _eps_args(eps=1e-5):
    return eps, float(np.nextafter(np.float32(eps), np.float32(np.inf)))


@pytest.mark.parametrize("name", ["20k", "tie"])
def test_host_sweep_matches_plain(slice5_lib, name):
    """The sweep body (every tile in order behind the per-ray gate): t and
    tri equal to sweep_intersect_plain's and to the planned walk's."""
    _, tables, ro, rd, active, tl = next(c for c in _walk_cases() if c[0] == name)
    live = active & intersect_mxu.root_hit_mask(tables, ro, rd, tl)
    want_t, want_tri = intersect_mxu.sweep_intersect_plain(tables, ro, rd, live, tl, 1e-5)
    walk_t, walk_tri = intersect_mxu.walk_plain(tables, ro, rd, live, tl,
                                                _plan_for(tables, ro, rd, live, tl), 1e-5)
    n = ro.x.shape[0]
    got_t, got_tri = torch.empty(n), torch.empty(n, dtype=torch.int32)
    rays = [p.contiguous() for p in (*ro, *rd)]
    lv, tlc = live.to(torch.uint8).contiguous(), tl.contiguous()
    slice5_lib.ptt_host_sweep(
        tables.coef.data_ptr(), tables.tile_aabb.data_ptr(), tables.tile_aabb.shape[0],
        tables.center.data_ptr(), _ptrs(rays), lv.data_ptr(), tlc.data_ptr(), *_eps_args(), n,
        got_t.data_ptr(), got_tri.data_ptr())
    assert (want_tri >= 0).sum() > 20
    assert torch.equal(got_tri, want_tri) and torch.equal(got_t, want_t)
    assert torch.equal(got_tri, walk_tri) and torch.equal(got_t, walk_t)


@pytest.mark.parametrize("name", ["20k", "tie"])
def test_host_super_walk_matches_plain(slice5_lib, name):
    """The super-tile walk body in the kernel's block schedule over the plan
    of the super boxes (20 tiles -> 3 supers, the last one short; 2 tiles ->
    1): t and tri equal to streamed_super_plain's and to walk_plain's."""
    _, tables, ro, rd, active, tl = next(c for c in _walk_cases() if c[0] == name)
    live = active & intersect_mxu.root_hit_mask(tables, ro, rd, tl)
    saabb = intersect_mxu.super_aabb(tables.tile_aabb)
    ct, cs = tables.tile_aabb.shape[0], saabb.shape[0]
    assert cs == -(-ct // 8)
    splan = intersect_mxu.build_tile_plan(
        saabb, *intersect_mxu.plan_rays(tables, ro, rd, live, tl))
    want_t, want_tri = intersect_mxu.streamed_super_plain(tables, ro, rd, live, tl, splan, 1e-5)
    walk_t, walk_tri = intersect_mxu.walk_plain(tables, ro, rd, live, tl,
                                                _plan_for(tables, ro, rd, live, tl), 1e-5)
    n = ro.x.shape[0]
    got_t, got_tri = torch.empty(n), torch.empty(n, dtype=torch.int32)
    rays = [p.contiguous() for p in (*ro, *rd)]
    lv, tlc = live.to(torch.uint8).contiguous(), tl.contiguous()
    slice5_lib.ptt_host_super(
        tables.coef.data_ptr(), tables.tile_aabb.data_ptr(), saabb.data_ptr(), ct, cs,
        tables.center.data_ptr(), _ptrs(rays), lv.data_ptr(), tlc.data_ptr(),
        splan.ids.data_ptr(), splan.tlo.data_ptr(), splan.cnt.data_ptr(), *_eps_args(), n,
        got_t.data_ptr(), got_tri.data_ptr())
    assert (want_tri >= 0).sum() > 20
    assert torch.equal(got_tri, want_tri) and torch.equal(got_t, want_t)
    assert torch.equal(got_tri, walk_tri) and torch.equal(got_t, walk_t)


@pytest.mark.parametrize("name", ["20k", "tie"])
def test_host_plan_prepass_matches_plain(slice5_lib, name):
    """The prepass body's (h, lb) per (block, tile), bit-equal to
    plan_prepass_plain's, with some rays dead and axis-aligned."""
    _, tables, ro, rd, active, tl = next(c for c in _walk_cases() if c[0] == name)
    rng = np.random.default_rng(9)
    live = active & torch.from_numpy(rng.random(active.shape[0]) > 0.2)
    rd = Vec3(torch.where(torch.from_numpy(rng.random(active.shape[0]) > 0.9),
                          torch.zeros_like(rd.x), rd.x), rd.y, rd.z)
    pr = intersect_mxu.plan_rays(tables, ro, rd, live, tl)
    want_h, want_lb = intersect_mxu.plan_prepass_plain(tables.tile_aabb, *pr)
    nb, ct = want_h.shape
    got_h = torch.empty((nb, ct), dtype=torch.uint8)
    got_lb = torch.empty((nb, ct))
    rays = [p.contiguous() for p in (*pr.os, *pr.d)]
    lv, tlc = pr.live.to(torch.uint8).contiguous(), pr.tl.contiguous()
    slice5_lib.ptt_host_plan_prepass(
        tables.tile_aabb.data_ptr(), ct, _ptrs(rays), lv.data_ptr(), tlc.data_ptr(), nb,
        got_h.data_ptr(), got_lb.data_ptr())
    assert want_h.sum() > 2
    assert torch.equal(got_h.bool(), want_h)
    assert torch.equal(got_lb.view(torch.int32), want_lb.view(torch.int32))


@pytest.mark.parametrize("split", [64, 1024])
@pytest.mark.parametrize("ct", [1, 79, 300, 1024])
def test_host_plan_prepass_live_matches_plain(slice5_lib, ct, split):
    """The prepass kernel's schedule (only the live rays of a block,
    compacted; warps over the tiles of a CTA's slice of ``split`` tiles,
    lanes over the rays, int-bits minimum): (h, lb) bit-equal to
    plan_prepass_plain's and to the per-block twin's, at 1, 79, 300 and
    1,024 tiles, with a block live only in its last lane and a ray that
    starts on a tile's face."""
    aabb, os_, d, live, tl = prepass_case(ct)
    want_h, want_lb = intersect_mxu.plan_prepass_plain(aabb, os_, d, live, tl)
    nb = want_h.shape[0]
    rays = _ptrs([p.contiguous() for p in (*os_, *d)])
    lv = live.to(torch.uint8).contiguous()
    outs = {}
    for fn, extra in (("ptt_host_plan_prepass", ()), ("ptt_host_plan_prepass_live", (split,))):
        h = torch.full((nb, ct), 7, dtype=torch.uint8)
        lb = torch.full((nb, ct), float("nan"))
        getattr(slice5_lib, fn)(aabb.data_ptr(), ct, rays, lv.data_ptr(), tl.data_ptr(), nb,
                                *extra, h.data_ptr(), lb.data_ptr())
        outs[fn] = (h, lb)
    for h, lb in outs.values():
        assert torch.equal(h.bool(), want_h)
        assert torch.equal(lb.view(torch.int32), want_lb.view(torch.int32))
    assert not want_h[1].any() and want_h[2, 0] and want_h[4, 0]
    assert float(want_lb[4, 0]) == 0.0


# ---------------------------------------------------------------------------
# The packet bins kernels (csrc/mesh_bins.cu: bins_nibble, bins_pad,
# bins_visit_tile, bins_slot, bins_listed over plan_pair)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bins_lib(mesh_lib):
    i32 = ctypes.c_int32
    mesh_lib.ptt_host_packet_bins.argtypes = [P, i32, P, P, P] + [i32] * 4 + [P] * 4
    return mesh_lib


def _host_bins(lib, aabb, os_, d, live, tl, budget, topk, seg_groups):
    """The four kernels' schedules on the host over a padded prefix ->
    ``PacketBins`` (outputs prefilled with values no kernel writes)."""
    n_pad, ct = tl.shape[0], aabb.shape[0]
    src = torch.full((budget,), -7, dtype=torch.int32)
    vt = torch.full((budget // 32,), -7, dtype=torch.int32)
    dst = torch.full((n_pad // 8, max(1, min(topk, ct))), -7, dtype=torch.int32)
    ovf = torch.full((1,), 7, dtype=torch.uint8)
    planes = [p.contiguous() for p in (*os_, *d)]
    lv, tlc = live.to(torch.uint8).contiguous(), tl.contiguous()
    lib.ptt_host_packet_bins(aabb.data_ptr(), ct, _ptrs(planes), lv.data_ptr(), tlc.data_ptr(),
                             n_pad // 256, budget, topk, seg_groups, src.data_ptr(),
                             vt.data_ptr(), dst.data_ptr(), ovf.data_ptr())
    assert int(ovf[0]) in (0, 1)
    return intersect_mxu.PacketBins(src, vt, dst if topk else None, torch.tensor(bool(ovf[0])))


def _plan_mesh_rays(n_tris, seed, n=1100, corridor=False, last_live=None):
    """The meshes and rays of ``test_torch_mesh_plan.py``: a random soup of
    ``n_tris`` triangles and sphere rays (or, with ``corridor``, +x rays
    through a band of the mesh, so packets hit a strict subset of tiles),
    padded as the plan pads them -> (tile_aabb, os, d, live, tl)."""
    from test_torch_mesh_plan import _inputs, _mesh
    from torch_compare import sphere_rays

    rng, _, pt, js = _mesh(n_tris, seed)
    if corridor:
        lo3, hi3 = np.asarray(js.mesh_bounds[:3]), np.asarray(js.mesh_bounds[3:])
        o = np.stack([np.full(n, lo3[0] - 1.0),
                      lo3[1] + (hi3[1] - lo3[1]) * rng.random(n) * 0.2,
                      lo3[2] + (hi3[2] - lo3[2]) * rng.random(n) * 0.2], 1).astype(np.float32)
        d = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (n, 1))
        live = rng.random(n) < 0.9
        lim = np.full(n, 3.4e38, np.float32)
    else:
        o, d = sphere_rays(rng, n)
        d[::13, 1] = 0.0
        live = rng.random(n) > 0.3
        lim = np.where(rng.random(n) > 0.5, 3.4e38, 2.0).astype(np.float32)
    if last_live is not None:
        live &= np.arange(n) < last_live
    _, (os_, dp, lv, tl) = _inputs(pt, o, d, live, lim)
    return pt.tile_aabb, os_, dp, lv, tl


@pytest.fixture(scope="module")
def soup_rays():
    return _plan_mesh_rays(2300, 80)


@pytest.mark.parametrize("seg", [2, 128])
@pytest.mark.parametrize("topk", [0, 1, 2, 128])
def test_host_packet_bins_match_plain(bins_lib, soup_rays, topk, seg):
    """The four kernels' schedules over the 2,300-triangle soup (3 tiles)
    and 1,100 sphere rays (5 groups of 32 packets; segments of 2 groups, as
    well as the kernel's 128): src, vt, dst and overflow bit-equal to
    packet_bins_plain's, with topk 0 (no dst), 1 and 2 (fewer than the
    tiles: overflowing packets, first slots only) and 128 (the dense
    plane)."""
    aabb, os_, d, live, tl = soup_rays
    budget = intersect_mxu.pair_budget(tl.shape[0], aabb.shape[0])
    want = intersect_mxu.packet_bins_plain(aabb, os_, d, live, tl, budget, topk)
    assert_bins_equal(_host_bins(bins_lib, aabb, os_, d, live, tl, budget, topk, seg), want)
    assert (want.vt >= 0).sum() > 3 and (want.vt == -1).any()
    assert bool(want.overflow) == (0 < topk < 3)


@pytest.mark.parametrize("seg", [2, 128])
def test_host_packet_bins_engaged_top_k(bins_lib, seg):
    """The corridor mesh (9,000 triangles, 9 tiles): for every K from Ct - 1
    down to the first that overflows, the host bins equal the plain
    version's; the largest K that holds every packet's tiles gives the
    dense scatter's src and vt."""
    aabb, os_, d, live, tl = _plan_mesh_rays(9000, 81, corridor=True)
    ct = aabb.shape[0]
    budget = intersect_mxu.pair_budget(tl.shape[0], ct)
    dense = intersect_mxu.packet_bins_plain(aabb, os_, d, live, tl, budget, 0)
    engaged = overflowed = None
    for k in range(ct - 1, 0, -1):
        want = intersect_mxu.packet_bins_plain(aabb, os_, d, live, tl, budget, k)
        got = _host_bins(bins_lib, aabb, os_, d, live, tl, budget, k, seg)
        assert_bins_equal(got, want)
        if bool(want.overflow):
            overflowed = k
            break
        engaged = got
    assert engaged is not None and overflowed is not None
    assert torch.equal(engaged.src, dense.src) and torch.equal(engaged.vt, dense.vt)


@pytest.mark.parametrize("topk", [0, 2, 128])
def test_host_packet_bins_overflowing_budget(bins_lib, soup_rays, topk):
    """A budget of 3 visits, far below the candidates: overflow set, every
    visit's tile and the slots below the budget as the plain version's."""
    aabb, os_, d, live, tl = soup_rays
    want = intersect_mxu.packet_bins_plain(aabb, os_, d, live, tl, 96, topk)
    assert bool(want.overflow) and (want.src < tl.shape[0] // 8).all()
    assert_bins_equal(_host_bins(bins_lib, aabb, os_, d, live, tl, 96, topk, 128), want)


@pytest.mark.parametrize("npre", [256, 512])
def test_host_packet_bins_tier_prefix(bins_lib, npre):
    """As a binned tier slices it: 4,096 sphere rays live only below ray
    400, bins over the first npre rays (whole blocks; warps past ray 415
    hold no live ray) with the budget ``_binning`` gives them: equal to the
    plain version's over the same prefix."""
    aabb, os_, d, live, tl = _plan_mesh_rays(2300, 80, n=4096, last_live=400)
    cut = lambda v: Vec3(*(x[:npre] for x in v))
    budget = intersect_mxu.pair_budget(max(npre, 4096 // 4), aabb.shape[0])
    want = intersect_mxu.packet_bins_plain(aabb, cut(os_), cut(d), live[:npre], tl[:npre],
                                           budget, 128)
    got = _host_bins(bins_lib, aabb, cut(os_), cut(d), live[:npre], tl[:npre], budget, 128,
                     128)
    assert_bins_equal(got, want)
    assert not bool(want.overflow) and (want.vt >= 0).sum() >= 3


# ---------------------------------------------------------------------------
# The epilogue variants' bodies (asc_visit, asc_member / asc_fold, mm_fold)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def epilogue_lib(walk_lib):
    i32, f32_ = ctypes.c_int32, ctypes.c_float
    walk_lib.ptt_host_lb_asc.argtypes = [P, P, i32] + [P] * 6 + [i32, f32_, f32_, i32, P, P]
    walk_lib.ptt_host_epilogue_mono.argtypes = [P, P, i32, P, P, P, P, i32, f32_, f32_, i32, P, P]
    return walk_lib


def _epilogue_case(name):
    """A walk case with a fifth of its rays dead and a whole block dead
    (the mono walk's block skip), its plan and its ascending plan."""
    _, tables, ro, rd, active, tl = next(c for c in _walk_cases() if c[0] == name)
    rng = np.random.default_rng(13)
    active = active & torch.from_numpy(rng.random(active.shape[0]) > 0.2)
    active[512:768] = False
    live = active & intersect_mxu.root_hit_mask(tables, ro, rd, tl)
    plan = _plan_for(tables, ro, rd, live, tl)
    return tables, ro, rd, live, tl, plan, intersect_mxu.ascending_plan(
        plan, tables.tile_aabb.shape[0])


@pytest.mark.parametrize("mm", [0, 1])
@pytest.mark.parametrize("name", ["20k", "tie"])
def test_host_lb_asc_matches_plain(epilogue_lib, name, mm):
    """ptt_lb_asc_kernel's per-ray body over the ascending plan: t and tri
    equal to lb_asc_plain's (mm: the floor flavor's definition) and, for the
    exact flavor, to the lane-best walk over the front-to-back plan."""
    tables, ro, rd, live, tl, plan, asc = _epilogue_case(name)
    want_t, want_tri = intersect_mxu.lb_asc_plain(tables, ro, rd, live, tl, asc, 1e-5,
                                                  mm_only=bool(mm))
    n = ro.x.shape[0]
    got_t, got_tri = torch.empty(n), torch.empty(n, dtype=torch.int32)
    rays = [p.contiguous() for p in (*ro, *rd)]
    lv, tlc = live.to(torch.uint8).contiguous(), tl.contiguous()
    epilogue_lib.ptt_host_lb_asc(
        tables.coef.data_ptr(), tables.tile_aabb.data_ptr(), tables.tile_aabb.shape[0],
        tables.center.data_ptr(), _ptrs(rays), lv.data_ptr(), tlc.data_ptr(),
        asc.ids.data_ptr(), asc.cnt.data_ptr(), mm, *_eps_args(), n, got_t.data_ptr(),
        got_tri.data_ptr())
    assert (want_tri >= 0).sum() > 20
    assert torch.equal(got_tri, want_tri) and torch.equal(got_t, want_t)
    if not mm:
        walk_t, walk_tri = intersect_mxu.walk_plain(tables, ro, rd, live, tl, plan, 1e-5)
        assert torch.equal(got_tri, walk_tri) and torch.equal(got_t, walk_t)


@pytest.mark.parametrize("flavor", ["full", "gate", "mm"])
@pytest.mark.parametrize("name", ["20k", "tie"])
def test_host_epilogue_mono_matches_plain(epilogue_lib, name, flavor):
    """ptt_epilogue_mono_kernel's body in the kernel's block schedule (the
    live vote, "gate"'s member vote per tile, every thread of a visiting
    block evaluating the tile): t and tri equal to epilogue_mono_plain's and,
    for the exact flavors, to the lane-best walk; a dead block returns
    (t_limit, -1)."""
    tables, ro, rd, live, tl, plan, _ = _epilogue_case(name)
    want_t, want_tri = intersect_mxu.epilogue_mono_plain(tables, ro, rd, live, tl, 1e-5, flavor)
    n = ro.x.shape[0]
    got_t, got_tri = torch.empty(n), torch.empty(n, dtype=torch.int32)
    rays = [p.contiguous() for p in (*ro, *rd)]
    lv, tlc = live.to(torch.uint8).contiguous(), tl.contiguous()
    epilogue_lib.ptt_host_epilogue_mono(
        tables.coef.data_ptr(), tables.tile_aabb.data_ptr(), tables.tile_aabb.shape[0],
        tables.center.data_ptr(), _ptrs(rays), lv.data_ptr(), tlc.data_ptr(),
        intersect_mxu.EPILOGUE_MONO_FLAVORS.index(flavor), *_eps_args(), n, got_t.data_ptr(),
        got_tri.data_ptr())
    assert (want_tri >= 0).sum() > 20
    assert torch.equal(got_tri, want_tri) and torch.equal(got_t, want_t)
    assert (got_tri[512:768] == -1).all() and torch.equal(got_t[512:768], tl[512:768])
    if flavor != "mm":
        walk_t, walk_tri = intersect_mxu.walk_plain(tables, ro, rd, live, tl, plan, 1e-5)
        assert torch.equal(got_tri, walk_tri) and torch.equal(got_t, walk_t)


EPILOGUE_FLAVORS = ("lb_asc", "lb_mm", "full", "gate", "mm")


@pytest.fixture(scope="module")
def epilogue_libs(epilogue_lib, spread_libs):
    """The harness at each block width with the epilogue variants' block
    schedules bound (the argument lists of their per-ray twins)."""
    for lib in spread_libs.values():
        lib.ptt_host_lb_asc.argtypes = epilogue_lib.ptt_host_lb_asc.argtypes
        lib.ptt_host_lb_asc_block.argtypes = epilogue_lib.ptt_host_lb_asc.argtypes
        lib.ptt_host_epilogue_mono.argtypes = epilogue_lib.ptt_host_epilogue_mono.argtypes
        lib.ptt_host_epilogue_mono_block.argtypes = epilogue_lib.ptt_host_epilogue_mono.argtypes
    return spread_libs


def _host_epilogue(lib, flavor, block, tables, ro, rd, live, tl, asc):
    """One epilogue flavor through the harness: the block schedule
    (``block``) or the per-ray twin -> (t, tri)."""
    n = ro.x.shape[0]
    got_t, got_tri = torch.empty(n), torch.empty(n, dtype=torch.int32)
    rays = [p.contiguous() for p in (*ro, *rd)]
    lv, tlc = live.to(torch.uint8).contiguous(), tl.contiguous()
    head = (tables.coef.data_ptr(), tables.tile_aabb.data_ptr(), tables.tile_aabb.shape[0],
            tables.center.data_ptr(), _ptrs(rays), lv.data_ptr(), tlc.data_ptr())
    tail = (*_eps_args(), n, got_t.data_ptr(), got_tri.data_ptr())
    suffix = "_block" if block else ""
    if flavor.startswith("lb_"):
        getattr(lib, "ptt_host_lb_asc" + suffix)(*head, asc.ids.data_ptr(), asc.cnt.data_ptr(),
                                                 int(flavor == "lb_mm"), *tail)
    else:
        getattr(lib, "ptt_host_epilogue_mono" + suffix)(
            *head, intersect_mxu.EPILOGUE_MONO_FLAVORS.index(flavor), *tail)
    return got_t, got_tri


def _epilogue_plain(flavor, tables, ro, rd, live, tl, asc):
    if flavor.startswith("lb_"):
        return intersect_mxu.lb_asc_plain(tables, ro, rd, live, tl, asc, 1e-5,
                                          mm_only=flavor == "lb_mm")
    return intersect_mxu.epilogue_mono_plain(tables, ro, rd, live, tl, 1e-5, flavor)


def _same_bits(a, b) -> bool:
    return torch.equal(a[0].view(torch.int32), b[0].view(torch.int32)) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("threads", [256, 512, 1024])
@pytest.mark.parametrize("flavor", EPILOGUE_FLAVORS)
@pytest.mark.parametrize("name", ["20k", "tie"])
def test_host_epilogue_block_schedules_match_plain(epilogue_libs, name, flavor, threads):
    """The epilogue variants' block schedules at three block widths:
    lb_asc (#5's schedule over the ascending plan), lb_mm, "full", "gate"
    and "mm" (every ray of a visiting block against every triangle; the
    windows, the member vote, wide_key's u/v tests before the division, the
    floors' (det, lane) keys): t and tri bit-equal to the plain version and
    to the per-ray twin, the exact flavors also to walk_plain (ties to the
    lower copy on the tie mesh), a dead block (rays 512-767) at (t_limit,
    -1) in the mono flavors."""
    tables, ro, rd, live, tl, plan, asc = _epilogue_case(name)
    lib = epilogue_libs[threads]
    want = _epilogue_plain(flavor, tables, ro, rd, live, tl, asc)
    got = _host_epilogue(lib, flavor, True, tables, ro, rd, live, tl, asc)
    assert (want[1] >= 0).sum() > 20
    assert _same_bits(got, want), (name, flavor)
    assert _same_bits(got, _host_epilogue(lib, flavor, False, tables, ro, rd, live, tl, asc))
    if flavor not in ("lb_mm", "mm"):
        assert _same_bits(got, intersect_mxu.walk_plain(tables, ro, rd, live, tl, plan, 1e-5))
    if flavor in ("full", "gate", "mm"):
        assert (got[1][512:768] == -1).all() and torch.equal(got[0][512:768], tl[512:768])


@pytest.mark.parametrize("threads", [256, 512, 1024])
@pytest.mark.parametrize("flavor", ["lb_mm", "mm"])
def test_host_epilogue_floors_signed_zero(epilogue_libs, flavor, threads):
    """The floors' keys where det is -0 on one lane and +0 on the others
    (``torch_fixtures.signed_zero_case``): every live ray's minimum is a
    zero at lane 0, not at the -0 lane, as in the plain version and the
    per-ray fold (equal zeros go to the lower lane); the all-dead block's
    rays (zero features, +0 everywhere) at lane 0 where a block with a
    live ray visits the tiles (lb_mm's plan visits every block; "mm" skips
    the dead block: (t_limit, -1)).  t compared by value: the sign of a
    zero minimum is the plain version's reduction's choice."""
    from torch_compare import mesh_tables_pair, tie_mesh
    from torch_fixtures import SIGNED_ZERO_LANE, signed_zero_case

    pos = tie_mesh(np.random.default_rng(60), 8)[0]
    tables, ro, rd, live, tl, asc = signed_zero_case(mesh_tables_pair(pos)[1])
    lib = epilogue_libs[threads]
    want = _epilogue_plain(flavor, tables, ro, rd, live, tl, asc)
    for block in (True, False):
        got = _host_epilogue(lib, flavor, block, tables, ro, rd, live, tl, asc)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]), block
    assert (want[1][:256] == 0).all() and (want[0][:256] == 0).all()
    assert not (want[1] == SIGNED_ZERO_LANE).any()
    dead = want[1][256:512]
    assert (dead == (0 if flavor == "lb_mm" else -1)).all()
    feat = intersect_mxu._features(tables, ro, rd).feat
    det = intersect_mxu._numerators([f[:4, None] for f in feat], tables.coef[:1024])[0]
    assert (det == 0).all() and torch.signbit(det[:, SIGNED_ZERO_LANE]).all()
    assert not torch.signbit(det[:, 0]).any()
