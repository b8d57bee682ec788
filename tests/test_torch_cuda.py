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

import ctypes
import dataclasses
import json
import pathlib
import types

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu_torch.models import (
    Renderer, megakernel_iteration, wavefront_iteration,
)
from project3_cuda_path_tracer_2025_tpu_torch.ops import camera as camera_ops
from project3_cuda_path_tracer_2025_tpu_torch.ops import film as film_ops
from project3_cuda_path_tracer_2025_tpu_torch.ops import fused, intersect_mxu, kernels
from project3_cuda_path_tracer_2025_tpu_torch.ops.compaction import permute_path_state
from project3_cuda_path_tracer_2025_tpu_torch.ops.intersect import prim_t_min
from project3_cuda_path_tracer_2025_tpu_torch.scene import (
    build_device_scene, camera_state, derive_render_camera, load_scene,
    set_resolution,
)
from project3_cuda_path_tracer_2025_tpu_torch.utils import prng
from project3_cuda_path_tracer_2025_tpu_torch.utils.vec import Vec3

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


@pytest.mark.parametrize("ln,base,rng_n", [(1000, 0, 4000), (1000, 3000, 4000),
                                           (320_000, 320_000, 640_000), (333, 1234, 100_003)])
def test_kernel_uniforms_block_bit_exact(cuda, ln, base, rng_n):
    """The camera draw of a block of pixels (a shard or chunk of a frame)."""
    key = prng.stage_key(prng.iteration_key(prng.prng_key(0), 9), 0, 0)
    got = fused.kernel_uniforms(key, ln, 4, cuda, base=base, rng_n=rng_n)
    want = prng.uniforms_at(key, base + torch.arange(ln, device=cuda), 4, rng_n)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name,cfg", [
    ("cornell_dof.json", dict(devices=2)), ("cornell_dof.json", dict(devices=4)),
    ("cornell_dof.json", dict(pixel_chunks=8)),
    ("cornell_mesh_5k.json", dict(devices=2)),
    ("cornell_dof.json", dict(devices=2, integrator="wavefront")),
])
def test_sharded_and_chunked_films_bit_equal_on_one_card(cuda, name, cfg):
    """Pixel mode (cuda:0 named nd times, each shard on a stream of its
    own) and chunks give the unsharded megakernel_iteration's film bit for
    bit on the card, through the kernels."""
    dev, static, cam = _setup(name, 64, cuda)
    n = static.pixel_count
    base_cfg = RenderConfig(**{k: v for k, v in cfg.items() if k == "integrator"})
    iteration = (wavefront_iteration if base_cfg.integrator == "wavefront"
                 else megakernel_iteration)
    want = film_ops.new_film(n, cuda)
    for it in (1, 2):
        want, alive = iteration(dev, static, base_cfg, cam, want, it, prng.prng_key(0))
    scene = set_resolution(load_scene(str(REPO / "scenes" / name)), 64, 64)
    r = Renderer(scene, RenderConfig(**cfg), shard_devices=[cuda] * cfg.get("devices", 1))
    r.step()
    r.step()
    got = r._flat_film()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(torch.as_tensor(r._alive_counts), alive.cpu())


# The bounce kernel's cases: (scene, case).  "chain": four bounces in turn;
# "dead": every ray's bounces 0; "live": the camera rays; "one a warp":
# lane 7 of every 32 rays live; "odd": 99 x 99 rays (not a multiple of 32);
# "offset": the pixels shifted by 1,000 in a stream of n + 2,000.
BOUNCE_CASES = [("cornell_dof.json", "chain"), ("cornell_all_lobes.json", "chain"),
                ("cornell_dof.json", "dead"), ("cornell_dof.json", "live"),
                ("cornell_dof.json", "one a warp"), ("cornell_dof.json", "odd"),
                ("cornell_all_lobes.json", "offset")]


def _bits_equal(got, want) -> bool:
    return all(torch.equal(a, b) for a, b in zip(
        (*got.origin, *got.direction, *got.color, got.bounces),
        (*want.origin, *want.direction, *want.color, want.bounces)))


@pytest.mark.parametrize("form", ["uniforms", "inline"])
@pytest.mark.parametrize("name,case", BOUNCE_CASES)
def test_bounce_kernel_matches_plain(cuda, name, case, form):
    """The packed bounce kernel bit-equal to its plain version in both
    uniform forms (the [3, n] plane; drawn inline at each ray's pixel), on
    chained bounces and on rays all dead, all live, one live a warp, a count
    that is not a multiple of 32 and a shard's pixel offset."""
    _, static, cam = _setup(name, 99 if case == "odd" else 96, cuda)
    cfg = RenderConfig()
    n = static.pixel_count
    idx = torch.arange(n, device=cuda, dtype=torch.int32)
    ik = prng.iteration_key(prng.prng_key(0), 1)
    paths = camera_ops.generate_camera_rays(
        cam, static.width, static.height, static.trace_depth,
        prng.uniforms_at(prng.stage_key(ik, 0, 0), idx, 4, n),
    )
    rng_n = n
    if case == "dead":
        paths = paths._replace(bounces=torch.zeros_like(paths.bounces))
    elif case == "one a warp":
        paths = paths._replace(bounces=torch.where(idx % 32 == 7, paths.bounces, 0))
    elif case == "offset":
        paths = paths._replace(pixel=idx + 1000)
        rng_n = n + 2000
    before = fused.fused_prim_bounce.launches
    bounces = 4 if case == "chain" else 2
    for d in range(bounces):
        skey = prng.stage_key(ik, d, 1)
        if form == "inline":
            got = fused.fused_prim_bounce(static, cfg, paths, su_key=skey, rng_n=rng_n)
            want = fused.fused_prim_bounce_plain(static, cfg, paths, su_key=skey, rng_n=rng_n)
        else:
            su = prng.uniforms_at(skey, paths.pixel, 3, rng_n)
            got = fused.fused_prim_bounce(static, cfg, paths, su)
            want = fused.fused_prim_bounce_plain(static, cfg, paths, su)
        assert _bits_equal(got, want)
        assert torch.equal(got.pixel, paths.pixel)
        paths = want
    assert fused.fused_prim_bounce.launches == before + bounces
    if case == "dead":
        assert int(paths.bounces.sum()) == 0


def test_bounce_kernel_on_two_streams(cuda):
    """Bounce launches on two streams at once, each stream with its own
    chunk counter: every launch bit-equal to the plain version (a shared
    counter would skip the chunks the other launch took)."""
    _, static, cam = _setup("cornell_dof.json", 256, cuda)
    cfg = RenderConfig()
    n = static.pixel_count
    idx = torch.arange(n, device=cuda, dtype=torch.int32)
    ik = prng.iteration_key(prng.prng_key(0), 1)
    paths = camera_ops.generate_camera_rays(
        cam, static.width, static.height, static.trace_depth,
        prng.uniforms_at(prng.stage_key(ik, 0, 0), idx, 4, n),
    )
    keys = [prng.stage_key(ik, d, 1) for d in range(8)]
    want = [fused.fused_prim_bounce_plain(static, cfg, paths, su_key=k) for k in keys]
    fused.fused_prim_bounce(static, cfg, paths, su_key=keys[0])  # the scene tables
    torch.cuda.synchronize(cuda)
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    got = []
    for i, k in enumerate(keys):
        with torch.cuda.stream(streams[i % 2]):
            got.append(fused.fused_prim_bounce(static, cfg, paths, su_key=k))
    torch.cuda.synchronize(cuda)
    for g, w in zip(got, want):
        assert _bits_equal(g, w)


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


def test_iteration_kernel_counts_the_lobes(cuda):
    """At 800x800, one iteration of the all-lobes scene: the iteration
    kernel's film and alive counts against the plain path's, its counting
    variant's against its own bit for bit, and the variant's lobe tally
    equal to the plain path's and to the benchmark reference's
    (``Tracer.lobe_counts``) on the card."""
    from benchmark.reference import scene as ref_scene
    from benchmark.reference import tracer as ref_tracer
    from project3_cuda_path_tracer_2025_tpu_torch.ops import shade as shade_ops

    seed = 1_234_567_891
    _, static, cam = _setup("cornell_all_lobes.json", 800, cuda)
    n, depth, key = static.pixel_count, static.trace_depth, prng.prng_key(seed)
    film_k, alive_k = fused.fused_prim_iteration(
        static, RenderConfig(), cam, film_ops.new_film(n, cuda), 1, key)
    lobes_c = torch.zeros((depth, len(shade_ops.LOBES)), dtype=torch.int32, device=cuda)
    film_c, alive_c = fused.fused_prim_iteration(
        static, RenderConfig(), cam, film_ops.new_film(n, cuda), 1, key, lobe_counts=lobes_c)
    lobes_p = torch.zeros_like(lobes_c)
    film_p, alive_p = fused.fused_prim_iteration_plain(
        static, RenderConfig(), cam, film_ops.new_film(n, cuda), 1, key, lobes_p)
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(film_c, film_k))
    assert torch.equal(alive_c, alive_k)
    assert torch.equal(alive_k, alive_p)
    assert all(torch.equal(a, b) for a, b in zip(film_k, film_p))
    assert torch.equal(lobes_c, lobes_p)
    doc = ref_scene.load(json.loads((REPO / "scenes" / "cornell_all_lobes.json").read_text()),
                         str(REPO / "scenes"))
    counts = ref_tracer.Tracer(doc, seed, cuda).lobe_counts(doc.render_camera(), 1)
    want = np.stack([counts[name] for name in ref_scene.LOBES], axis=1)
    np.testing.assert_array_equal(lobes_c.cpu().numpy(), want)
    assert (want[:, :4].sum(axis=0) > 0).all()


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
# The mesh kernels (csrc/mesh_walk.cu, csrc/fused_mesh.cu) on scenes/cornell_mesh_5k.json
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
        mh = fused.mesh_walk(dev.mxu_mesh, static, cfg, paths, tl, plain=True)
        paths = fused.fused_mesh_shade_plain(
            prim_static, cfg, paths, mh.t, None, None, prng.stage_key(ik, d, 1),
            static.pixel_count, tables=dev.mxu_mesh, mesh_tri=mh.tri)
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
        mh = fused.mesh_walk(tables, static, cfg, paths, tl)
        args = (prim_static, cfg, paths, mh.t, None, None, prng.stage_key(ik, d, 1),
                static.pixel_count, emit, tables)
        got = fused.fused_mesh_shade(*args, mesh_tri=mh.tri)
        want = fused.fused_mesh_shade_plain(*args, mesh_tri=mh.tri)
        got_p, got_c = got if emit else (got, (None, None, None))
        want_p, want_c = want if emit else (want, (None, None, None))
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


# ---------------------------------------------------------------------------
# The walk and binned kernels (csrc/mesh_walk.cu) on the larger meshes
# ---------------------------------------------------------------------------

def _bounce_states(name, res, device, bounces=3):
    """(dev, static, [(ro, rd, alive, t_lim)] per bounce) from camera rays,
    each state in coherence order as the main path sorts it."""
    dev, static, cam = _setup(name, res, device)
    cfg = RenderConfig()
    ik, paths = _camera_paths(static, cam, device)
    prim_static = dataclasses.replace(static, num_triangles=0)
    tables = dev.mxu_mesh
    states = []
    for d in range(bounces):
        tl = prim_t_min(static, cfg, paths.origin, paths.direction)
        perm = intersect_mxu.coherence_perm(tables, paths.origin, paths.direction, paths.alive,
                                            tl, cfg.ray_sort_bits, cfg.ray_sort_dir_bits,
                                            mode="signature")
        paths, (tl,) = permute_path_state(paths, perm, extra=(tl,))
        states.append((paths.origin, paths.direction, paths.alive, tl))
        mh = fused.mesh_walk(tables, static, cfg, paths, tl, plain=True)
        paths = fused.fused_mesh_shade_plain(prim_static, cfg, paths, mh.t, None, None,
                                             prng.stage_key(ik, d, 1), static.pixel_count,
                                             tables=tables, mesh_tri=mh.tri)
    return dev, static, states


def _plan(tables, ro, rd, live, tl):
    return intersect_mxu.plan_with_prefix(
        tables.tile_aabb, *intersect_mxu.plan_rays(tables, ro, rd, live, tl))


@pytest.mark.parametrize("name,kinds", [
    ("cornell_mesh_20k.json", ("planned_lanebest", "planned", "streamed")),
    ("cornell_mesh_80k.json", ("streamed",)),
])
def test_walk_kernels_match_plain(cuda, name, kinds):
    """Sorted camera rays and two bounces: each walk kernel's t and tri
    bit-equal to walk_plain on the same plan."""
    dev, static, states = _bounce_states(name, 96, cuda)
    tables = dev.mxu_mesh
    hits = 0
    for ro, rd, alive, tl in states:
        live = alive & intersect_mxu.root_hit_mask(tables, ro, rd, tl)
        plan = _plan(tables, ro, rd, live, tl)
        want_t, want_tri = intersect_mxu.walk_plain(tables, ro, rd, live, tl, plan, 1e-5)
        for kind in kinds:
            fn = intersect_mxu.WALKS[kind]
            before = fn.launches
            got_t, got_tri = fn(tables, ro, rd, live, tl, plan, 1e-5)
            assert fn.launches == before + 1
            assert torch.equal(got_tri, want_tri), kind
            assert torch.equal(got_t, want_t), kind
        hits += int((want_tri >= 0).sum())
    assert hits > 100


def test_streamed_kernel_ties_and_limit(cuda):
    """The streamed kernel's block schedule on the two-tile tie mesh (every
    hit ties across tiles; a quarter of the rays hit at exactly t = 5, some
    with t_limit 5) and again with every other hit ray's t_limit moved onto
    its hit: t and tri bit-equal to walk_plain, ties to the lower copy, a
    hit at exactly t_limit left at (t_limit, -1)."""
    from torch_fixtures import TIE_TRIS, tie_mesh

    pos, o, d, lim = tie_mesh(np.random.default_rng(60), 2000)
    nrm = np.zeros_like(pos)
    nrm[:] = [0.0, 0.0, 1.0]
    t3 = lambda a: np.zeros(a, np.float32)
    tables = intersect_mxu.build_mxu_tables(pos, nrm, t3((2048, 3, 2)), t3((2048, 3)),
                                            t3((2048, 3)), np.zeros(2048, np.int32), cuda)
    col = lambda a: Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])).to(cuda)
                           for i in range(3)))
    ro, rd = col(o), col(d)
    tl = torch.from_numpy(lim).to(cuda)
    for moved in (False, True):
        live = intersect_mxu.root_hit_mask(tables, ro, rd, tl)
        want_t, want_tri = intersect_mxu.walk_plain(tables, ro, rd, live, tl,
                                                    _plan(tables, ro, rd, live, tl), 1e-5)
        if moved:
            at = (torch.arange(2000, device=cuda) % 2 == 0) & (hit_tri >= 0)
            assert torch.equal(want_t[at], tl[at]) and (want_tri[at] == -1).all()
        got_t, got_tri = intersect_mxu.streamed_intersect(tables, ro, rd, live, tl,
                                                          _plan(tables, ro, rd, live, tl), 1e-5)
        assert torch.equal(got_tri, want_tri) and torch.equal(got_t, want_t), moved
        assert set(got_tri[got_tri >= 0].tolist()) == {TIE_TRIS[0]}
        hit_tri, hit_t = got_tri, got_t
        tl = torch.where((torch.arange(2000, device=cuda) % 2 == 0) & (hit_tri >= 0), hit_t, tl)


@pytest.mark.parametrize("kind", ["sweep", "super", "super padded"])
def test_sweep_and_super_kernels_ties_and_limit(cuda, kind):
    """The sweep's and the super-tile walk's block schedules on the two-tile
    tie mesh (the super walk also over the tables padded to a whole
    super-tile), then with every other hit ray's t_limit moved onto its
    hit: t and tri bit-equal to the plain versions, ties to the lower copy,
    a hit at exactly t_limit left at (t_limit, -1)."""
    from torch_fixtures import TIE_TRIS, pad_to_supers, tie_mesh

    pos, o, d, lim = tie_mesh(np.random.default_rng(60), 2000)
    nrm = np.zeros_like(pos)
    nrm[:] = [0.0, 0.0, 1.0]
    t3 = lambda a: np.zeros(a, np.float32)
    tables = intersect_mxu.build_mxu_tables(pos, nrm, t3((2048, 3, 2)), t3((2048, 3)),
                                            t3((2048, 3)), np.zeros(2048, np.int32), cuda)
    if kind == "super padded":
        tables = pad_to_supers(tables)
    col = lambda a: Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])).to(cuda)
                           for i in range(3)))
    ro, rd = col(o), col(d)
    tl = torch.from_numpy(lim).to(cuda)
    saabb = intersect_mxu.super_aabb(tables.tile_aabb)
    even = torch.arange(2000, device=cuda) % 2 == 0
    for moved in (False, True):
        live = intersect_mxu.root_hit_mask(tables, ro, rd, tl)
        if kind == "sweep":
            args = (tables, ro, rd, live, tl, 1e-5)
            got = intersect_mxu.sweep_intersect(*args)
            want = intersect_mxu.sweep_intersect_plain(*args)
        else:
            splan = intersect_mxu.plan_with_prefix(
                saabb, *intersect_mxu.plan_rays(tables, ro, rd, live, tl))
            args = (tables, ro, rd, live, tl, splan, 1e-5)
            got = intersect_mxu.streamed_super_intersect(*args, saabb)
            want = intersect_mxu.streamed_super_plain(*args)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]), moved
        assert set(got[1][got[1] >= 0].tolist()) == {TIE_TRIS[0]}
        if moved:
            at = even & (hit_tri >= 0)
            assert int(at.sum()) > 100
            assert torch.equal(got[0][at], tl[at]) and (got[1][at] == -1).all()
        hit_tri, hit_t = got[1], got[0]
        tl = torch.where(even & (hit_tri >= 0), hit_t, tl)


@pytest.mark.parametrize("n", [2048, 1000])
@pytest.mark.parametrize("kind", ["planned_lanebest", "planned"])
def test_planned_kernels_ties_limit_and_empty_rows(cuda, kind, n):
    """The planned walks' block schedule on the two-tile tie mesh with n
    rays (1000: the last block holds 232), then with every other hit ray's
    t_limit moved onto its hit, then with the second block's rays dead (its
    plan row empty, as a chain call leaves the rows of blocks that cannot
    improve): t and tri bit-equal to walk_plain, ties to the lower copy, a
    hit at exactly t_limit left at (t_limit, -1), an empty row's rays at
    (t_limit, -1)."""
    from torch_fixtures import TIE_TRIS, tie_mesh

    pos, o, d, lim = tie_mesh(np.random.default_rng(60), n)
    nrm = np.zeros_like(pos)
    nrm[:] = [0.0, 0.0, 1.0]
    t3 = lambda a: np.zeros(a, np.float32)
    tables = intersect_mxu.build_mxu_tables(pos, nrm, t3((2048, 3, 2)), t3((2048, 3)),
                                            t3((2048, 3)), np.zeros(2048, np.int32), cuda)
    col = lambda a: Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])).to(cuda)
                           for i in range(3)))
    ro, rd = col(o), col(d)
    tl = torch.from_numpy(lim).to(cuda)
    fn = intersect_mxu.WALKS[kind]
    ray = torch.arange(n, device=cuda)
    even, second = ray % 2 == 0, ray // intersect_mxu.RAY_TILE == 1
    for step in ("as made", "moved", "empty row"):
        live = intersect_mxu.root_hit_mask(tables, ro, rd, tl)
        if step == "empty row":
            live = live & ~second
        plan = _plan(tables, ro, rd, live, tl)
        args = (tables, ro, rd, live, tl, plan, 1e-5)
        before = fn.launches
        got = fn(*args)
        want = intersect_mxu.walk_plain(*args)
        assert fn.launches == before + 1
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]), step
        assert set(got[1][got[1] >= 0].tolist()) == {TIE_TRIS[0]}
        if step == "as made":
            hit_tri, hit_t = got[1], got[0]
            tl = torch.where(even & (hit_tri >= 0), hit_t, tl)
        elif step == "moved":
            at = even & (hit_tri >= 0)
            assert int(at.sum()) > 50
            assert torch.equal(got[0][at], tl[at]) and (got[1][at] == -1).all()
        else:
            assert int(plan.cnt[1]) == 0
            assert torch.equal(got[0][second], tl[second]) and (got[1][second] == -1).all()


@pytest.mark.parametrize("n", [2048, 1003])
@pytest.mark.parametrize("kind", ["mono", "binned"])
def test_mono_and_binned_kernels_ties_limit_and_tails(cuda, kind, n):
    """The mono walk's and the binned visits' block schedules on the
    two-tile tie mesh with n rays (1003: the last block holds 235 rays and
    the last packet 3), then with every other hit ray's t_limit moved onto
    its hit, then with the second block's rays inactive (mono: a dead
    block, skipped whole): (t, tri) bit-equal to the plain versions (binned:
    every pair row), ties to the lower copy, a hit at exactly t_limit left
    at (t_limit, -1) by mono and at (inf, -1) in each of its ray's pair rows
    by binned, whose rows of empty visits (vt = -1) and empty slots (p =
    n_g) are (inf, -1)."""
    from torch_fixtures import TIE_TRIS, tie_mesh

    pos, o, d, lim = tie_mesh(np.random.default_rng(60), n)
    nrm = np.zeros_like(pos)
    nrm[:] = [0.0, 0.0, 1.0]
    t3 = lambda a: np.zeros(a, np.float32)
    tables = intersect_mxu.build_mxu_tables(pos, nrm, t3((2048, 3, 2)), t3((2048, 3)),
                                            t3((2048, 3)), np.zeros(2048, np.int32), cuda)
    col = lambda a: Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])).to(cuda)
                           for i in range(3)))
    ro, rd = col(o), col(d)
    tl = torch.from_numpy(lim).to(cuda)
    ray = torch.arange(n, device=cuda)
    even, second = ray % 2 == 0, ray // intersect_mxu.RAY_TILE == 1
    fn = intersect_mxu.mono_intersect if kind == "mono" else intersect_mxu.binned_intersect
    for step in ("as made", "moved", "dead block"):
        active = ~second if step == "dead block" else torch.ones(n, dtype=torch.bool, device=cuda)
        before = fn.launches
        if kind == "mono":
            args = (tables, 2048, ro, rd, active, tl, 1e-5)
            got = fn(*args)
            want = intersect_mxu.mono_intersect_plain(*args)
            t, tri = got
        else:
            live = active & intersect_mxu.root_hit_mask(tables, ro, rd, tl)
            pr = intersect_mxu.plan_rays(tables, ro, rd, live, tl)
            n_g = pr.tl.shape[0] // intersect_mxu.BINNED_G
            bins = intersect_mxu.packet_bins(
                tables.tile_aabb, *pr, intersect_mxu.pair_budget(pr.tl.shape[0], 2), 128)
            assert not bool(bins.overflow)
            assert bool((bins.vt == -1).any()) and bool((bins.src == n_g).any())
            args = (tables, ro, rd, live, tl, bins.vt, bins.src, n_g, 1e-5)
            got = fn(*args)
            want = intersect_mxu.binned_intersect_plain(*args)
            _, pray, ok = intersect_mxu._pair_rays(bins.vt, bins.src, n_g, n)
            assert torch.isinf(got[0][~ok]).all() and (got[1][~ok] == -1).all()
            t, tri = intersect_mxu.binned_reduce(*got, bins, pr.tl, n_g)
            t, tri = t[:n], tri[:n]
        assert fn.launches == before + 1
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]), step
        assert set(tri[tri >= 0].tolist()) == {TIE_TRIS[0]}
        if step == "as made":
            hit_tri, hit_t = tri, t
            tl = torch.where(even & (hit_tri >= 0), hit_t, tl)
        elif step == "moved":
            at = even & (hit_tri >= 0)
            assert int(at.sum()) > 50
            assert torch.equal(t[at], tl[at]) and (tri[at] == -1).all()
            if kind == "binned":
                rows = ok & at[torch.clamp(pray, max=n - 1)]
                assert int(rows.sum()) > 50
                assert torch.isinf(got[0][rows]).all() and (got[1][rows] == -1).all()
        else:
            assert torch.equal(t[second], tl[second]) and (tri[second] == -1).all()


def test_binned_kernel_matches_plain(cuda):
    """Pair by pair on the 20k mesh's sorted camera rays, the bins built
    over the whole ray range."""
    dev, static, states = _bounce_states("cornell_mesh_20k.json", 96, cuda, bounces=2)
    tables = dev.mxu_mesh
    ct = tables.tile_aabb.shape[0]
    for ro, rd, alive, tl in states:
        live = alive & intersect_mxu.root_hit_mask(tables, ro, rd, tl)
        pr = intersect_mxu.plan_rays(tables, ro, rd, live, tl)
        n_pad = pr.tl.shape[0]
        bins = intersect_mxu.packet_bins(tables.tile_aabb, *pr,
                                         intersect_mxu.pair_budget(n_pad, ct), 128)
        assert not bool(bins.overflow)
        args = (tables, ro, rd, live, tl, bins.vt, bins.src, n_pad // 8, 1e-5)
        got = intersect_mxu.binned_intersect(*args)
        want = intersect_mxu.binned_intersect_plain(*args)
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0], want[0])
        assert int((want[1] >= 0).sum()) > 50


def test_larger_mesh_renderer_takes_the_kernels(cuda):
    """cornell_mesh_20k.json at 64x64 through each traversal: the films are
    bit-identical, and each bounce launches the kernel of its traversal
    (binned: or its streamed fallback) and never the mono kernel."""
    scene = set_resolution(load_scene(str(REPO / "scenes" / "cornell_mesh_20k.json")), 64, 64)
    films = {}
    for mode, kernel in (("auto", "planned_lanebest"), ("planned", "planned_lanebest"),
                         ("streamed", "streamed"), ("binned", None)):
        r = Renderer(scene, RenderConfig(mxu_traversal=mode), device=cuda)
        counters = [intersect_mxu.mono_intersect, intersect_mxu.binned_intersect,
                    *intersect_mxu.WALKS.values()]
        before = [c.launches for c in counters]
        r.step_many(2)
        got = {c.__name__: c.launches - b for c, b in zip(counters, before)}
        depth = r.static.trace_depth
        assert got["mono_intersect"] == 0
        if kernel is None:
            assert got["binned_intersect"] > 0
            assert got["binned_intersect"] + got["streamed_intersect"] == 2 * depth
        else:
            assert got[f"{kernel}_intersect"] == 2 * depth
        films[mode] = torch.stack(list(r.film), 1)
    for mode in ("planned", "streamed", "binned"):
        assert torch.equal(films[mode], films["auto"]), mode
    assert np.isfinite(r.image()).all() and r.image().sum() > 0


# ---------------------------------------------------------------------------
# The sweep, the super-tile walk, the plan prepass and the chunked chains
# ---------------------------------------------------------------------------

def test_sweep_kernel_matches_plain(cuda):
    """Sorted camera rays and two bounces of the 20k mesh (20 tiles, one
    call): the sweep kernel's t and tri bit-equal to its plain version and
    to the planned walk's."""
    dev, static, states = _bounce_states("cornell_mesh_20k.json", 96, cuda)
    tables = dev.mxu_mesh
    hits = 0
    for ro, rd, alive, tl in states:
        live = alive & intersect_mxu.root_hit_mask(tables, ro, rd, tl)
        before = intersect_mxu.sweep_intersect.launches
        got = intersect_mxu.sweep_intersect(tables, ro, rd, live, tl, 1e-5)
        assert intersect_mxu.sweep_intersect.launches == before + 1
        want = intersect_mxu.sweep_intersect_plain(tables, ro, rd, live, tl, 1e-5)
        walk = intersect_mxu.planned_intersect(tables, ro, rd, live, tl,
                                               _plan(tables, ro, rd, live, tl), 1e-5)
        for other in (want, walk):
            assert torch.equal(got[1], other[1]) and torch.equal(got[0], other[0])
        hits += int((want[1] >= 0).sum())
    assert hits > 100


@pytest.mark.parametrize("name", ["cornell_mesh_20k.json", "cornell_mesh_80k.json"])
def test_super_kernel_matches_plain(cuda, name):
    """20 tiles (3 super-tiles, the last short) and 79 tiles (10, the last
    short): the super walk's t and tri bit-equal to its plain version and to
    the streamed walk's."""
    dev, static, states = _bounce_states(name, 96, cuda)
    tables = dev.mxu_mesh
    saabb = intersect_mxu.super_aabb(tables.tile_aabb)
    hits = 0
    for ro, rd, alive, tl in states:
        live = alive & intersect_mxu.root_hit_mask(tables, ro, rd, tl)
        splan = intersect_mxu.plan_with_prefix(
            saabb, *intersect_mxu.plan_rays(tables, ro, rd, live, tl))
        before = intersect_mxu.streamed_super_intersect.launches
        got = intersect_mxu.streamed_super_intersect(tables, ro, rd, live, tl, splan, 1e-5)
        assert intersect_mxu.streamed_super_intersect.launches == before + 1
        want = intersect_mxu.streamed_super_plain(tables, ro, rd, live, tl, splan, 1e-5)
        walk = intersect_mxu.streamed_intersect(tables, ro, rd, live, tl,
                                                _plan(tables, ro, rd, live, tl), 1e-5)
        for other in (want, walk):
            assert torch.equal(got[1], other[1]) and torch.equal(got[0], other[0])
        hits += int((want[1] >= 0).sum())
    assert hits > 100


@pytest.mark.parametrize("name", ["cornell_mesh_5k.json", "cornell_mesh_20k.json",
                                  "cornell_mesh_500k.json"])
def test_plan_prepass_kernel_matches_plain(cuda, name):
    """5, 20 and 489 tiles (threads sharing a tile, and tiles beyond one
    block's threads): (h, lb) and the whole plan bit-equal to the torch
    plan's."""
    dev, static, states = _bounce_states(name, 64, cuda, bounces=2)
    tables = dev.mxu_mesh
    for ro, rd, alive, tl in states:
        live = alive & intersect_mxu.root_hit_mask(tables, ro, rd, tl)
        pr = intersect_mxu.plan_rays(tables, ro, rd, live, tl)
        before = intersect_mxu.plan_prepass.launches
        h, lb = intersect_mxu.plan_prepass(tables.tile_aabb, *pr)
        assert intersect_mxu.plan_prepass.launches == before + 1
        want_h, want_lb = intersect_mxu.plan_prepass_plain(tables.tile_aabb, *pr)
        assert torch.equal(h, want_h)
        assert torch.equal(lb.view(torch.int32), want_lb.view(torch.int32))
        got = intersect_mxu.plan_with_prefix(tables.tile_aabb, *pr, impl="pallas")
        want = intersect_mxu.plan_with_prefix(tables.tile_aabb, *pr)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert int(want.cnt.sum()) > 0


@pytest.mark.parametrize("ct", [1, 79, 300, 1024])
def test_plan_prepass_kernel_edge_cases(cuda, ct):
    """The prepass kernel (the live rays of a block compacted, warps over
    the tiles of a CTA's slice of 64) on synthetic boxes at 1, 79, 300 and
    1,024 tiles, with a dead block, a block live only in its last lane and
    a ray that starts on a tile's face: (h, lb) bit-equal to the plain
    version."""
    from torch_fixtures import prepass_case

    aabb, os_, d, live, tl = (x.to(cuda) if isinstance(x, torch.Tensor) else
                              type(x)(*(c.to(cuda) for c in x)) for x in prepass_case(ct))
    h, lb = intersect_mxu.plan_prepass(aabb, os_, d, live, tl)
    want_h, want_lb = intersect_mxu.plan_prepass_plain(aabb, os_, d, live, tl)
    assert torch.equal(h, want_h)
    assert torch.equal(lb.view(torch.int32), want_lb.view(torch.int32))
    assert bool(want_h[2, 0]) and bool(want_h[4, 0]) and not bool(want_h[1].any())


def test_chains_and_switches_take_the_kernels(cuda, monkeypatch):
    """cornell_mesh_80k.json (79 tiles) at 64x64: "sweep" (the sweep chain, 3
    launches a bounce), "planned" (the planned chain: 2 launches of the walk
    with the exit and one lane-best a bounce), the super walk and the plan
    kernel behind their switches; every film bit-identical to "auto"."""
    scene = set_resolution(load_scene(str(REPO / "scenes" / "cornell_mesh_80k.json")), 64, 64)
    mx = intersect_mxu
    counters = [mx.sweep_intersect, mx.planned_intersect, mx.planned_lanebest_intersect,
                mx.streamed_intersect, mx.streamed_super_intersect, mx.plan_prepass]
    films = {}
    runs = (("auto", {}, dict(streamed_intersect=1)),
            ("sweep", {}, dict(sweep_intersect=3)),
            ("planned", {}, dict(planned_intersect=2, planned_lanebest_intersect=1)),
            ("auto", {"PTT_STREAM_SUPER": "1"}, dict(streamed_super_intersect=1)),
            ("auto", {"PTT_PLAN_IMPL": "pallas"}, dict(streamed_intersect=1, plan_prepass=1)))
    for mode, env, per_bounce in runs:
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        r = Renderer(scene, RenderConfig(mxu_traversal=mode), device=cuda)
        before = [c.launches for c in counters]
        r.step_many(1)
        got = {c.__name__: c.launches - b for c, b in zip(counters, before)}
        depth = r.static.trace_depth
        want = {c.__name__: depth * per_bounce.get(c.__name__, 0) for c in counters}
        assert got == want, (mode, env)
        films[(mode, *env)] = torch.stack(list(r.film), 1)
        for k in env:
            monkeypatch.delenv(k)
    for key, film in films.items():
        assert torch.equal(film, films[("auto",)]), key


# ---------------------------------------------------------------------------
# Textures (the shade kernel's modes "textured" and "precomputed") and the
# wavefront integrator (csrc/scan.cu)
# ---------------------------------------------------------------------------

MESH_TEX = "cornell_mesh_textured_local.json"
PRIM_TEX = "cornell_prim_textured_local.json"


def _tex_surface(dev, static, cfg, paths, mode):
    """The resolved surface the shade kernel takes in ``mode``:
    (mesh_t, normal, material, albedo)."""
    from project3_cuda_path_tracer_2025_tpu_torch.ops import shade as shade_ops
    from project3_cuda_path_tracer_2025_tpu_torch.ops.intersect import intersect_scene
    from project3_cuda_path_tracer_2025_tpu_torch.utils.vec import Vec3

    if mode == "textured":
        tl = prim_t_min(static, cfg, paths.origin, paths.direction)
        return fused.textured_mesh_surface(dev, static, cfg, paths, tl)
    isect = intersect_scene(dev, static, paths, cfg)
    mid = torch.clamp(isect.material_id, 0, static.num_materials - 1)
    base = Vec3(*(c[mid.long()] for c in dev.materials.color))
    alb, nrm = shade_ops.textured_surface(dev, static, isect, mid, base,
                                          live=paths.alive & (isect.t > 0.0))
    return isect.t, nrm, isect.material_id, alb


@pytest.mark.parametrize("mode", ["textured", "precomputed"])
def test_mesh_shade_kernel_modes_bit_equal(cuda, mode):
    dev, static, cam = _setup(MESH_TEX if mode == "textured" else PRIM_TEX, 128, cuda)
    cfg = RenderConfig()
    ik, paths = _camera_paths(static, cam, cuda)
    prim_static = dataclasses.replace(static, num_triangles=0)
    before = fused.fused_mesh_shade.launches
    for d in range(3):
        mt, mn, mm, alb = _tex_surface(dev, static, cfg, paths, mode)
        args = (prim_static, cfg, paths, mt, mn, mm, prng.stage_key(ik, d, 1),
                static.pixel_count)
        got = fused.fused_mesh_shade(*args, mode=mode, mesh_albedo=alb)
        want = fused.fused_mesh_shade_plain(*args, mode=mode, mesh_albedo=alb)
        assert torch.equal(got.bounces, want.bounces)
        for a, b in zip([*got.origin, *got.direction, *got.color],
                        [*want.origin, *want.direction, *want.color]):
            assert torch.equal(a, b)
        paths = want
    assert fused.fused_mesh_shade.launches == before + 3


@pytest.mark.parametrize("n", [640_000, 16_384 * 3 + 1])
def test_scan_kernel_matches_cumsum(cuda, n):
    from project3_cuda_path_tracer_2025_tpu_torch.ops import scan

    g = torch.Generator(device=cuda).manual_seed(0)
    before = scan.scan_flat.launches
    flags = (torch.rand(n, generator=g, device=cuda) > 0.5).to(torch.int32)
    ramp = torch.arange(n, device=cuda, dtype=torch.int32) % 7
    for x in (flags, ramp):
        assert torch.equal(scan.exclusive_scan(x), torch.cumsum(x, 0, dtype=torch.int32) - x)
        assert torch.equal(scan.inclusive_scan(x), torch.cumsum(x, 0, dtype=torch.int32))
    xf = torch.rand(n, generator=g, device=cuda)
    torch.testing.assert_close(scan.inclusive_scan(xf), torch.cumsum(xf.double(), 0).float(),
                               rtol=1e-5, atol=1e-2)
    assert scan.scan_flat.launches == before + 5
    keys = torch.randint(0, 64, (n,), generator=g, device=cuda, dtype=torch.int32)
    assert torch.equal(scan.radix_sort_permutation(keys, num_bits=6).long(),
                       torch.argsort(keys, stable=True))


def test_textured_and_wavefront_renderers_take_the_kernels(cuda):
    """A textured mesh frame launches the mono traversal and the shade
    kernel once a bounce, a textured-prim frame the shade kernel once a
    bounce, a compacting wavefront frame the scan kernel twice a bounce;
    every wavefront film is bit-identical to the unfused megakernel film."""
    from project3_cuda_path_tracer_2025_tpu_torch.ops import scan

    counters = (intersect_mxu.mono_intersect, fused.fused_mesh_shade, scan.scan_flat)
    for name in (MESH_TEX, PRIM_TEX, "cornell_dof.json"):
        scene = set_resolution(load_scene(str(REPO / "scenes" / name)), 128, 128)
        r = Renderer(scene, RenderConfig(), device=cuda)
        before = [c.launches for c in counters]
        r.step_many(2)
        got = [c.launches - b for c, b in zip(counters, before)]
        depth = r.static.trace_depth
        if name != "cornell_dof.json":
            assert got[:2] == [2 * depth, 2 * depth], (name, got)
        ref = Renderer(scene, RenderConfig(fused_bounce="off"), device=cuda)
        ref.step_many(2)
        for compaction in (True, "adaptive", False):
            wf = Renderer(scene, RenderConfig(integrator="wavefront",
                                              stream_compaction=compaction), device=cuda)
            before = scan.scan_flat.launches
            wf.step_many(2)
            if compaction is True:
                assert scan.scan_flat.launches - before == 2 * 2 * depth
            for a, b in zip(wf.film, ref.film):
                assert torch.equal(a, b), (name, compaction)
        assert np.isfinite(r.image()).all() and r.image().sum() > 0


# ---------------------------------------------------------------------------
# The epilogue variants (csrc/mesh_walk.cu), the prim kernels beyond their
# old capacity, the measuring scripts on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["cornell_mesh_5k.json", "cornell_mesh_20k.json"])
def test_epilogue_kernels_match_plain_and_the_lanebest_walk(cuda, name):
    """Sorted camera rays and two bounces: ptt_lb_asc_kernel and
    ptt_epilogue_mono_kernel (every flavor) bit-equal to their plain
    versions, the exact flavors also to the lane-best planned walk."""
    dev, static, states = _bounce_states(name, 96, cuda)
    tables = dev.mxu_mesh
    ct = tables.tile_aabb.shape[0]
    hits = 0
    for ro, rd, alive, tl in states:
        live = alive & intersect_mxu.root_hit_mask(tables, ro, rd, tl)
        plan = _plan(tables, ro, rd, live, tl)
        asc = intersect_mxu.ascending_plan(plan, ct)
        ref_t, ref_tri = intersect_mxu.planned_lanebest_intersect(tables, ro, rd, live, tl, plan,
                                                                 1e-5)
        for mm in (False, True):
            before = intersect_mxu.lb_asc_intersect.launches
            got = intersect_mxu.lb_asc_intersect(tables, ro, rd, live, tl, asc, 1e-5, mm_only=mm)
            assert intersect_mxu.lb_asc_intersect.launches == before + 1
            want = intersect_mxu.lb_asc_plain(tables, ro, rd, live, tl, asc, 1e-5, mm_only=mm)
            assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]), mm
            if not mm:
                assert torch.equal(got[1], ref_tri) and torch.equal(got[0], ref_t)
        for flavor in intersect_mxu.EPILOGUE_MONO_FLAVORS:
            before = intersect_mxu.epilogue_mono_intersect.launches
            got = intersect_mxu.epilogue_mono_intersect(tables, ro, rd, live, tl, 1e-5, flavor)
            assert intersect_mxu.epilogue_mono_intersect.launches == before + 1
            want = intersect_mxu.epilogue_mono_plain(tables, ro, rd, live, tl, 1e-5, flavor)
            assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]), flavor
            if flavor != "mm":
                assert torch.equal(got[1], ref_tri) and torch.equal(got[0], ref_t), flavor
        hits += int((ref_tri >= 0).sum())
    assert hits > 100


def _tie_tables(pos, device):
    nrm = np.zeros_like(pos)
    nrm[:] = [0.0, 0.0, 1.0]
    t = pos.shape[0]
    z = lambda *shape: np.zeros(shape, np.float32)
    return intersect_mxu.build_mxu_tables(pos, nrm, z(t, 3, 2), z(t, 3), z(t, 3),
                                          np.zeros(t, np.int32), device)


# The epilogue kernels' edge cases: "odd" 1,003 rays (the last block holds
# 235); "dead block" the second block's rays dead (the mono flavors skip it,
# its ascending plan row is empty); "dead rays" the floors' signed zeros and
# an all-dead block (torch_fixtures.signed_zero_case); "tie" the two-tile
# tie mesh; "one tile" its first tile alone; "32 tiles" sixteen copies of it
# stacked along the rays, the most tiles a call takes.
EPILOGUE_EDGE_CASES = ["odd", "dead block", "dead rays", "tie", "one tile", "32 tiles"]


@pytest.mark.parametrize("case", EPILOGUE_EDGE_CASES)
def test_epilogue_kernels_edge_cases(cuda, case):
    """The five epilogue flavors (lb_asc, lb_mm, "full", "gate", "mm") on
    the edge cases above: (t, tri) equal to the plain versions, the exact
    flavors also to the lane-best planned walk (ties to the lower copy),
    rays of a dead block at (t_limit, -1) in the mono flavors, one launch a
    call."""
    from torch_fixtures import SIGNED_ZERO_LANE, TIE_TRIS, signed_zero_case, tie_mesh

    n = 1003 if case == "odd" else 2048
    pos, o, d, lim = tie_mesh(np.random.default_rng(60), n)
    if case == "one tile":
        pos = pos[:1024]
    elif case == "32 tiles":
        pos = np.concatenate([pos + np.float32([0.0, 0.0, 0.5 * k]) for k in range(16)])
    tables = _tie_tables(pos, cuda)
    col = lambda a: Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])).to(cuda)
                           for i in range(3)))
    ro, rd, tl = col(o), col(d), torch.from_numpy(lim).to(cuda)
    live = intersect_mxu.root_hit_mask(tables, ro, rd, tl)
    second = torch.arange(n, device=cuda) // intersect_mxu.RAY_TILE == 1
    if case == "dead block":
        live = live & ~second
    ct = tables.tile_aabb.shape[0]
    assert ct == {"one tile": 1, "32 tiles": 32}.get(case, 2)
    if case == "dead rays":
        tables, ro, rd, live, tl, asc = signed_zero_case(tables)
        plan = asc
        second = torch.arange(tl.shape[0], device=cuda) // intersect_mxu.RAY_TILE == 1
    else:
        plan = _plan(tables, ro, rd, live, tl)
        asc = intersect_mxu.ascending_plan(plan, ct)
    ref = intersect_mxu.planned_lanebest_intersect(tables, ro, rd, live, tl, plan, 1e-5)
    flavors = [("lb_asc", False), ("lb_mm", True)] + [
        (f, f == "mm") for f in intersect_mxu.EPILOGUE_MONO_FLAVORS]
    for flavor, floor in flavors:
        if flavor.startswith("lb_"):
            fn = intersect_mxu.lb_asc_intersect
            args = (tables, ro, rd, live, tl, asc, 1e-5, flavor == "lb_mm")
            plain = intersect_mxu.lb_asc_plain
        else:
            fn = intersect_mxu.epilogue_mono_intersect
            args = (tables, ro, rd, live, tl, 1e-5, flavor)
            plain = intersect_mxu.epilogue_mono_plain
        before = fn.launches
        got = fn(*args)
        assert fn.launches == before + 1
        want = plain(*args)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]), flavor
        if not floor:
            assert torch.equal(got[1], ref[1]) and torch.equal(got[0], ref[0]), flavor
        if case in ("dead block", "dead rays") and flavor in intersect_mxu.EPILOGUE_MONO_FLAVORS:
            assert torch.equal(got[0][second], tl[second]) and (got[1][second] == -1).all()
        if case == "dead rays" and floor:
            assert (got[1][:256] == 0).all() and not (got[1] == SIGNED_ZERO_LANE).any()
    if case in ("tie", "odd", "dead block"):
        assert set(ref[1][ref[1] >= 0].tolist()) == {TIE_TRIS[0]}
    if case == "dead block":
        assert int(plan.cnt[1]) == 0


def test_prim_kernels_beyond_the_old_capacity(cuda):
    """40 primitives, 40 materials, depth 80: the bounce kernel bit-equal
    in its integers and close in its floats to the plain version (and its
    inline draw bit-equal to its [3, n] form), the
    iteration kernel's film at the goldens' tolerance, the Renderer through
    the iteration kernel."""
    from project3_cuda_path_tracer_2025_tpu_torch.scene import many_prims_scene, scene_from_dict

    base = str(REPO / "scenes" / "cornell_dof.json")
    make = lambda: set_resolution(scene_from_dict(many_prims_scene(base, 40, 40, depth=80)), 96, 96)
    scene = make()
    _, static = build_device_scene(scene, cuda)
    cam = camera_state(derive_render_camera(scene.state.camera))
    assert (len(static.geoms), static.num_materials, static.trace_depth) == (40, 40, 80)
    cfg, n = RenderConfig(), static.pixel_count
    ik, paths = _camera_paths(static, cam, cuda)
    idx = torch.arange(n, device=cuda)
    for d in range(3):
        su = prng.uniforms_at(prng.stage_key(ik, d, 1), idx, 3, n)
        got = fused.fused_prim_bounce(static, cfg, paths, su)
        want = fused.fused_prim_bounce_plain(static, cfg, paths, su)
        assert torch.equal(got.bounces, want.bounces)
        for a, b in zip((*got.origin, *got.direction, *got.color),
                        (*want.origin, *want.direction, *want.color)):
            assert float((~torch.isclose(a, b, rtol=1e-5, atol=1e-6)).float().mean()) <= 1e-3
        assert _bits_equal(fused.fused_prim_bounce(static, cfg, paths,
                                                   su_key=prng.stage_key(ik, d, 1)), got)
        paths = want
    base_key = prng.prng_key(0)
    film_k, alive_k = fused.fused_prim_iteration(static, cfg, cam, film_ops.new_film(n, cuda), 1,
                                                 base_key)
    film_p, alive_p = fused.fused_prim_iteration_plain(static, cfg, cam,
                                                       film_ops.new_film(n, cuda), 1, base_key)
    assert alive_k.shape == (80,) and int((alive_k - alive_p).abs().max()) <= 2
    got, want = torch.stack(list(film_k), 1), torch.stack(list(film_p), 1)
    outside = ~torch.isclose(got, want, rtol=2e-4, atol=2e-5)
    assert float(outside.any(dim=1).float().mean()) <= 5e-3
    r = Renderer(make())
    before = fused.fused_prim_iteration.launches
    r.step_many(2)
    assert fused.fused_prim_iteration.launches == before + 2
    assert np.isfinite(r.image()).all() and r.image().sum() > 0


def test_prim_tables_beyond_shared_memory(cuda):
    """1,600 primitives (243 KB of tables, beyond a block's 227 KB of shared
    memory): the bounce (both uniform forms, bit-equal to each other),
    mesh-shade and iteration kernels read the tables from device memory and
    agree with their plain versions (integers equal,
    floats to ``rtol=1e-5, atol=1e-6`` on all but one lane in a thousand;
    the film of 1,024 pixels with at most 5 outside ``rtol=2e-4,
    atol=2e-5``)."""
    from project3_cuda_path_tracer_2025_tpu_torch.scene import many_prims_scene, scene_from_dict

    base = str(REPO / "scenes" / "cornell_dof.json")
    scene = set_resolution(scene_from_dict(many_prims_scene(base, 1600, 200, depth=8)), 32, 32)
    _, static = build_device_scene(scene, cuda)
    cam = camera_state(derive_render_camera(scene.state.camera))
    assert len(static.geoms) * ctypes.sizeof(kernels.PttGeom) > 232448
    cfg, n = RenderConfig(), static.pixel_count
    ik, paths = _camera_paths(static, cam, cuda)
    idx = torch.arange(n, device=cuda)
    # A made-up mesh of 200 triangles, the k-th of material k, its vertex
    # normals all +z: a mesh hit on every third lane.
    rows = torch.zeros((200, intersect_mxu.SHADE_ROW), device=cuda)
    rows[:, [2, 5, 8]] = 1.0
    rows[:, 9] = torch.arange(200, device=cuda).float()
    rows[:, 13], rows[:, 17] = 1.0, 1.0  # e1 = x, e2 = y
    mesh = types.SimpleNamespace(attrs_shade=rows)
    for d in range(2):
        skey = prng.stage_key(ik, d, 1)
        su = prng.uniforms_at(skey, idx, 3, n)
        hit = (idx % 3 == 0) & paths.alive
        sargs = (static, cfg, paths, torch.where(hit, 0.5, 0.0).float(), None, None, skey, n,
                 "tlim", mesh)
        tri = torch.where(hit, idx % 200, -1).to(torch.int32)
        got_s, (got_tl, _, _) = fused.fused_mesh_shade(*sargs, mesh_tri=tri)
        want_s, (want_tl, _, _) = fused.fused_mesh_shade_plain(*sargs, mesh_tri=tri)
        got = fused.fused_prim_bounce(static, cfg, paths, su)
        want = fused.fused_prim_bounce_plain(static, cfg, paths, su)
        assert _bits_equal(fused.fused_prim_bounce(static, cfg, paths, su_key=skey), got)
        for g, w, extra in ((got, want, ()), (got_s, want_s, ((got_tl, want_tl),))):
            assert torch.equal(g.bounces, w.bounces)
            for a, b in (*zip((*g.origin, *g.direction, *g.color),
                              (*w.origin, *w.direction, *w.color)), *extra):
                assert float((~torch.isclose(a, b, rtol=1e-5, atol=1e-6)).float().mean()) <= 1e-3
        paths = want
    base_key = prng.prng_key(0)
    film_k, alive_k = fused.fused_prim_iteration(static, cfg, cam, film_ops.new_film(n, cuda), 1,
                                                 base_key)
    film_p, alive_p = fused.fused_prim_iteration_plain(static, cfg, cam,
                                                       film_ops.new_film(n, cuda), 1, base_key)
    assert int((alive_k - alive_p).abs().max()) <= 2
    got, want = torch.stack(list(film_k), 1), torch.stack(list(film_p), 1)
    assert int((~torch.isclose(got, want, rtol=2e-4, atol=2e-5)).any(dim=1).sum()) <= 5


def _plain_until_dead(static, cfg, cam, base_key, device):
    """``fused_prim_iteration_plain``, stopped once no path is alive (a dead
    path is left as it is, so the later depths add nothing): the reference
    of the iteration kernel at any depth.  Returns (film [N, 3], alive)."""
    n, depth = static.pixel_count, static.trace_depth
    idx = torch.arange(n, dtype=torch.int32, device=device)
    cam_key, ik = fused.kernel_key_words(1, base_key)
    paths = camera_ops.generate_camera_rays(
        cam, static.width, static.height, depth, prng.uniforms_at(cam_key, idx, 4, n), idx=idx)
    alive = torch.zeros(depth, dtype=torch.int32, device=device)
    for d in range(depth):
        if not bool(paths.alive.any()):
            break
        paths = fused.fused_prim_bounce_plain(
            static, cfg, paths, prng.uniforms_at(prng.stage_key(ik, d, 1), idx, 3, n))
        alive[d] = paths.alive.sum()
    return torch.stack(list(paths.color), 1), alive


@pytest.mark.parametrize("case", ["32x32", "depth 80", "tables beyond shared memory",
                                  "keys beyond shared memory"])
def test_iteration_kernel_regenerates_at_any_size(cuda, case):
    """The iteration kernel's persistent, regenerating grid where it is
    thin or long: 1,024 pixels (fewer than the grid's resident lanes), the
    40-primitive scene at depth 80, 1,600 primitives (tables in device
    memory), and depth 20,000 (shade keys and counters beyond shared memory,
    in device memory) on 64 pixels.  Alive counts equal the plain path's
    (within 2 at 40 and 1,600 primitives, as the tests above hold them),
    films at the goldens' tolerance.  The counting variant (``lobe_counts``)
    at each size, its tally in shared or in device memory: the kernel's
    film and alive counts bit for bit, and each scatter counted once (at
    each depth but the last, as many as paths alive after it)."""
    from project3_cuda_path_tracer_2025_tpu_torch.ops import shade as shade_ops
    from project3_cuda_path_tracer_2025_tpu_torch.scene import many_prims_scene, scene_from_dict

    base = str(REPO / "scenes" / "cornell_dof.json")
    doc, res = {
        "32x32": (None, 32),
        "depth 80": (many_prims_scene(base, 40, 40, depth=80), 64),
        "tables beyond shared memory": (many_prims_scene(base, 1600, 200, depth=8), 16),
        "keys beyond shared memory": (None, 8),
    }[case]
    scene = load_scene(base) if doc is None else scene_from_dict(doc)
    if case == "keys beyond shared memory":
        scene.state.trace_depth = 20_000
    scene = set_resolution(scene, res, res)
    _, static = build_device_scene(scene, cuda)
    cam = camera_state(derive_render_camera(scene.state.camera))
    cfg, n = RenderConfig(), static.pixel_count
    before = fused.fused_prim_iteration.launches
    film_k, alive_k = fused.fused_prim_iteration(static, cfg, cam, film_ops.new_film(n, cuda), 1,
                                                 prng.prng_key(0))
    want, alive_p = _plain_until_dead(static, cfg, cam, prng.prng_key(0), cuda)
    assert alive_k.shape == (static.trace_depth,)
    if case in ("depth 80", "tables beyond shared memory"):
        assert int((alive_k - alive_p).abs().max()) <= 2
    else:
        assert torch.equal(alive_k, alive_p)
    got = torch.stack(list(film_k), 1)
    assert bool(torch.isfinite(got).all())
    outside = ~torch.isclose(got, want, rtol=2e-4, atol=2e-5)
    assert int(outside.any(dim=1).sum()) <= max(3, n // 200)
    assert fused.fused_prim_iteration.launches == before + 1
    lobes = torch.zeros((static.trace_depth, len(shade_ops.LOBES)), dtype=torch.int32,
                        device=cuda)
    film_c, alive_c = fused.fused_prim_iteration(static, cfg, cam, film_ops.new_film(n, cuda), 1,
                                                 prng.prng_key(0), lobe_counts=lobes)
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(film_c, film_k))
    assert torch.equal(alive_c, alive_k)
    assert torch.equal(lobes[:-1].sum(dim=1), alive_k[:-1])
    assert fused.fused_prim_iteration.launches == before + 2


def _sorted_shade_states(static, dev, cam, device, bounces):
    """Each sorted bounce of a mesh frame as the main path shades it:
    yields (args, tri, win), the shade's arguments with the rays in
    coherence order and their t_limit, the walk's winning triangles
    (``mesh_tri``) and the carried prim winner (``prim_t_min(...,
    winner=True)``, permuted with the rays); the next bounce from the plain
    shade."""
    cfg = RenderConfig()
    tables = dev.mxu_mesh
    ik, paths = _camera_paths(static, cam, device)
    prim_static = dataclasses.replace(static, num_triangles=0)
    for d in range(bounces):
        tl, win = prim_t_min(static, cfg, paths.origin, paths.direction, winner=True)
        perm = intersect_mxu.coherence_perm(tables, paths.origin, paths.direction, paths.alive,
                                            tl, cfg.ray_sort_bits, cfg.ray_sort_dir_bits,
                                            mode="signature")
        paths, (tl, win) = permute_path_state(paths, perm, extra=(tl, win))
        mh = fused.mesh_walk(tables, static, cfg, paths, tl, plain=True)
        args = (prim_static, cfg, paths, mh.t, None, None, prng.stage_key(ik, d, 1),
                static.pixel_count, "tlim+key", tables)
        yield args, mh.tri, win
        paths = fused.fused_mesh_shade_plain(*args, mesh_tri=mh.tri)[0]


def _shade_bits(out):
    p, (tl, key, win) = out
    return [x.view(torch.int32) if x.dtype == torch.float32 else x
            for x in (*p.origin, *p.direction, *p.color, p.bounces, tl, key, win)
            if x is not None]


def test_mesh_shade_kernel_carried_winner_on_sorted_bounces(cuda):
    """All eight sorted bounces of the 5k mesh at 160x160: the shade kernel
    given the carried winner is bit-equal to its plain version given it, and
    to itself without it; the winner it emits is the plain version's."""
    dev, static, cam = _setup(MESH, 160, cuda)
    before = fused.fused_mesh_shade.launches
    taken = 0
    for args, tri, win in _sorted_shade_states(static, dev, cam, cuda, static.trace_depth):
        got = fused.fused_mesh_shade(*args, prim_winner=win, mesh_tri=tri)
        want = fused.fused_mesh_shade_plain(*args, prim_winner=win, mesh_tri=tri)
        every = fused.fused_mesh_shade(*args, mesh_tri=tri)
        for a, b in zip(_shade_bits(got), _shade_bits(want)):
            assert torch.equal(a, b)
        for a, b in zip(_shade_bits(got), _shade_bits(every)):
            assert torch.equal(a, b)
        taken += int((args[2].alive & (tri < 0) & (win >= 0)).sum())
    assert fused.fused_mesh_shade.launches == before + 2 * static.trace_depth
    assert taken > 1000


MESH_200K = "cornell_mesh_200k.json"


def _torch_key(tables, paths, tl):
    """The key of the torch glue (``intersect_mxu.sort_key``, signature)."""
    cfg = RenderConfig()
    return intersect_mxu.sort_key(tables, paths.origin, paths.direction, paths.alive, tl,
                                  cfg.ray_sort_bits, cfg.ray_sort_dir_bits, mode="signature")


def _large_table(center, device):
    """``key_case``'s boxes and rays at 8,192 tiles (256 KB of boxes, more
    than a block's shared memory would hold), on ``device``."""
    from torch_fixtures import key_case

    tables, paths, tl = key_case(8192, center.cpu().numpy(), np.random.default_rng(11))
    to = lambda x: x.to(device)
    paths = type(paths)(*(type(f)(*map(to, f)) if isinstance(f, tuple) else to(f)
                          for f in paths))
    tables = types.SimpleNamespace(**{k: to(v) for k, v in vars(tables).items()})
    return tables, paths, to(tl)


@pytest.mark.parametrize("table", ["200k", "8192 tiles"])
def test_mesh_shade_kernel_key_at_any_tile_count(cuda, table):
    """#3 with "tlim+key" past the old 24-tile rule: on three sorted bounces
    of the 200k mesh at 128x128 with the knot's table (196 tiles) and with
    ``key_case``'s 8,192 tiles, every plane -- rays, t_lim, key, winner -- is
    bit-equal to ``fused_mesh_shade_plain``, and the key is the torch
    glue's on the scattered rays."""
    dev, static, cam = _setup(MESH_200K, 128, cuda)
    tables = dev.mxu_mesh
    assert tables.tile_aabb.shape[0] == 196
    # The surface rows stay the knot's, which the walk's winners index.
    key_tables = tables if table == "200k" else types.SimpleNamespace(
        **{**vars(_large_table(tables.center, cuda)[0]), "attrs_shade": tables.attrs_shade})
    live = 0
    for args, tri, win in _sorted_shade_states(static, dev, cam, cuda, 3):
        args = (*args[:9], key_tables)
        got = fused.fused_mesh_shade(*args, prim_winner=win, mesh_tri=tri)
        want = fused.fused_mesh_shade_plain(*args, prim_winner=win, mesh_tri=tri)
        for a, b in zip(_shade_bits(got), _shade_bits(want)):
            assert torch.equal(a, b)
        p, (tl, key, _) = got
        assert torch.equal(key, _torch_key(key_tables, p, tl))
        live += int((key < (1 << 30)).sum())
    assert live > 1000


# case -> (scene, resolution, the walk that feeds the shade, its traversal)
SURFACE_CASES = {
    "5k mono": (MESH, 160, "mono_intersect", "auto"),
    "200k binned": (MESH_200K, 128, "binned_intersect", "binned"),
}


# emit -> the planes a shade call gives back: the paths' 11, then t_lim, the
# key and the winner of its MeshCarry where it emits them
SHADE_PLANES = {"": 11, "tlim": 13, "tlim+key": 14}


def _flat_outputs(out):
    """A shade's outputs as flat int32 views: the paths and the MeshCarry."""
    if out is None:
        return []
    if isinstance(out, torch.Tensor):
        return [out.view(torch.int32) if out.dtype == torch.float32 else out]
    return [x for e in out for x in _flat_outputs(e)]


@pytest.mark.parametrize("case", list(SURFACE_CASES))
def test_mesh_shade_resolves_the_walks_surface(cuda, case, monkeypatch):
    """#3 in mode "plain" on the main path's own calls: one frame, sorted,
    with prefix tiers (4, 2), of the 5k mesh through mono walk #4 and of the
    200k knot through binned #10.  Every shade call takes the walk's (t,
    tri) and no resolved surface, and is bit-equal to
    ``fused_mesh_shade_plain`` on the same arguments, paths and
    ``MeshCarry``; calls on a tier's head among them."""
    name, res, walk, traversal = SURFACE_CASES[case]
    dev, static, cam = _setup(name, res, cuda)
    n = static.pixel_count
    calls, shade = [], fused.fused_mesh_shade

    def spy(*a, **k):
        got = shade(*a, **k)
        want = fused.fused_mesh_shade_plain(*a, **k)
        got_f, want_f = _flat_outputs(got), _flat_outputs(want)
        calls.append((k["mode"], a[4] is None and a[5] is None, k["tables"] is dev.mxu_mesh,
                      (len(got_f), len(want_f)), SHADE_PLANES[k["emit"]],
                      all(torch.equal(x, y) for x, y in zip(got_f, want_f)),
                      a[2].pixel.shape[0], int(((k["mesh_tri"] >= 0) & a[2].alive).sum())))
        return got
    spy.__dict__ = shade.__dict__
    monkeypatch.setattr(fused, "fused_mesh_shade", spy)
    walk_fn = getattr(intersect_mxu, walk)
    before = walk_fn.launches
    cfg = RenderConfig(ray_sorting="on", bounce_prefix_tiers=(4, 2), mxu_traversal=traversal)
    megakernel_iteration(dev, static, cfg, cam, film_ops.new_film(n, cuda), 1, prng.prng_key(0))
    assert walk_fn.launches > before
    assert len(calls) == static.trace_depth
    for mode, unresolved, own_tables, planes, want_planes, equal, _, _ in calls:
        assert (mode, unresolved, own_tables) == ("plain", True, True)
        assert planes == (want_planes, want_planes) and equal, (case, calls)
    assert calls[0][4] == SHADE_PLANES["tlim+key"] and calls[-1][4] == SHADE_PLANES[""]
    heads = sum(c[6] < n for c in calls)
    hits = sum(c[7] for c in calls)
    assert heads >= 1 and hits > 1000, (heads, hits)


def _frame_launches(scene, wrap=None):
    """Device activities (kernels, copies, fills) and ``mesh.surface`` spans
    of one traced ``Renderer.step_many(1)``: the second frame of a fresh
    renderer of seed 5 (the first warms it up), so two calls trace the
    same frame.  ``wrap`` replaces ``fused.fused_mesh_shade`` meanwhile."""
    from project3_cuda_path_tracer_2025_tpu_torch.utils import timers

    r = Renderer(scene, RenderConfig(), seed=5, device="cuda:0")
    r.step_many(1)
    shade = fused.fused_mesh_shade
    if wrap is not None:
        fused.fused_mesh_shade = wrap(shade)
        fused.fused_mesh_shade.__dict__ = shade.__dict__  # its launch count is the kernel's
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            r.step_many(1)
            torch.cuda.synchronize()
    finally:
        fused.fused_mesh_shade = shade
    launches = spans = 0
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CPU:
            spans += name == timers.SPAN_PREFIX + "mesh.surface"
        elif hasattr(e, "activity_type"):
            launches += e.activity_type() in ("kernel", "gpu_memcpy", "gpu_memset")
        else:
            launches += not (name.startswith(("ProfilerStep#", timers.SPAN_PREFIX))
                             or (hasattr(e, "is_user_annotation") and e.is_user_annotation()))
    return launches, spans, r.static.trace_depth


@pytest.mark.parametrize("name", [MESH, MESH_200K])
def test_step_many_leaves_the_surface_to_the_shade(cuda, name):
    """``Renderer.step_many`` on the 5k mesh and the 200k knot at 64x64:
    no ``mesh.surface`` span opens, and the frame launches exactly 91 device
    activities a bounce fewer than the same frame with the torch resolve
    (``resolve_mesh_surface``, the surface stage the kernel took over) run
    before each shade launch."""
    scene = set_resolution(load_scene(str(REPO / "scenes" / name)), 64, 64)

    def with_torch_resolve(shade):
        def run(*a, **k):
            paths = a[2]
            fused.resolve_mesh_surface(k["tables"], k["mesh_tri"], paths.origin,
                                       paths.direction, a[1].baby_epsilon)
            return shade(*a, **k)
        return run

    got, got_spans, depth = _frame_launches(scene)
    torch_resolve, resolve_spans, _ = _frame_launches(scene, with_torch_resolve)
    assert (got_spans, resolve_spans) == (0, depth)
    assert torch_resolve - got == 91 * depth, (got, torch_resolve)


@pytest.mark.parametrize("case", ["200k camera", "8192 tiles"])
def test_mesh_prelude_kernel_matches_plain(cuda, case):
    """The prelude kernel (bounce 0's t_lim, winner and key) on the 200k
    mesh's camera rays at 128x128 and on ``key_case``'s rays over 8,192
    tiles: bit-equal to ``mesh_prelude_plain``, its key the torch glue's on
    the same t_lim; without the boxes it gives no key and the same t_lim
    and winner."""
    dev, static, cam = _setup(MESH_200K, 128, cuda)
    prim_static = dataclasses.replace(static, num_triangles=0)
    cfg = RenderConfig()
    if case == "200k camera":
        tables, paths = dev.mxu_mesh, _camera_paths(static, cam, cuda)[1]
    else:
        tables, paths, _ = _large_table(dev.mxu_mesh.center, cuda)
    before = fused.mesh_prelude.launches
    got = fused.mesh_prelude(prim_static, cfg, paths, tables)
    want = fused.mesh_prelude_plain(prim_static, cfg, paths, tables)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b)
    assert torch.equal(got.key, _torch_key(tables, paths, got.t_lim))
    assert int((got.key < (1 << 30)).sum()) > 500
    bare = fused.mesh_prelude(prim_static, cfg, paths)
    assert bare.key is None
    assert torch.equal(bare.t_lim, got.t_lim) and torch.equal(bare.win, got.win)
    assert fused.mesh_prelude.launches == before + 2


def test_mesh_frame_carried_keys_match_the_torch_key_route(cuda):
    """One 200k frame at 200x200 on the main path (the prelude's key at
    bounce 0, #3's after it) against the same frame by the route that
    built every key in torch: bounce 0 from ``prim_t_min``, and the carry
    handed on without its key, so each bounce sorts by ``coherence_perm``.
    The kernels' keys equal the torch keys at every bounce, and so the
    permutations, and the films are bit-equal."""
    scene = set_resolution(load_scene(str(REPO / "scenes" / MESH_200K)), 200, 200)
    r = Renderer(scene, RenderConfig(), seed=5, device=cuda)
    dev, static, cfg = r.dev, r.static, r.cfg
    n, depth = static.pixel_count, static.trace_depth
    film_k, alive_k = megakernel_iteration(dev, static, cfg, r._cam_state,
                                           film_ops.new_film(n, cuda), 1, r._base_key)
    prim_static = dataclasses.replace(static, num_triangles=0)
    tables = dev.mxu_mesh
    ikey = prng.iteration_key(r._base_key, 1)
    paths = camera_ops.generate_camera_rays(
        r._cam_state, static.width, static.height, depth,
        prng.uniforms(prng.stage_key(ikey, 0, 0), n, 4, cuda),
        idx=torch.arange(n, dtype=torch.int32, device=cuda))
    tl, win = prim_t_min(static, cfg, paths.origin, paths.direction, winner=True)
    carry = fused.MeshCarry(tl, fused.mesh_prelude(prim_static, cfg, paths, tables).key, win)
    live = 0
    for d in range(depth):
        assert torch.equal(carry.key, _torch_key(tables, paths, carry.t_lim)), d
        live += int((carry.key < (1 << 30)).sum())
        want = d < depth - 1
        out = fused.fused_mesh_bounce(dev, static, cfg, paths, su_key=prng.stage_key(ikey, d, 1),
                                      rng_n=n, carry=carry._replace(key=None),
                                      want_carry=want, carry_winner=True)
        paths, carry = out if want else (out, None)
    film_t = film_ops.accumulate(film_ops.new_film(n, cuda), paths, permuted=True)
    assert torch.equal(torch.stack(list(film_k), 1), torch.stack(list(film_t), 1))
    assert live > 1000 and float(film_k.x.sum()) > 0


def _bins_args(tables, ro, rd, alive, tl, tiers=None):
    """The packet bins' arguments as ``_binning`` builds them: the rays of
    the smallest binned tier holding the last live one (all of them with
    ``tiers`` None), its budget, top-K 128."""
    live = alive & intersect_mxu.root_hit_mask(tables, ro, rd, tl)
    pr = intersect_mxu.plan_rays(tables, ro, rd, live, tl)
    n_pad = pr.tl.shape[0]
    npre = n_pad
    if tiers is not None:
        last = intersect_mxu.live_position(pr.live)
        npre = next(p for p in intersect_mxu.binned_prefixes(n_pad, tiers) + [n_pad] if last < p)
    cut = lambda v: Vec3(*(x[:npre] for x in v))
    budget = intersect_mxu.pair_budget(max(npre, ro.x.shape[0] // 4), tables.tile_aabb.shape[0])
    return (tables.tile_aabb, cut(pr.os), cut(pr.d), pr.live[:npre], pr.tl[:npre], budget,
            intersect_mxu.BINNED_TOPK)


def test_packet_bins_kernels_match_plain_on_the_200k_knot(cuda):
    """The packet bins kernels on the 200k knot (196 tiles) at 192x192 (144
    groups of 32 packets: two segments of the column scan): its camera rays
    unsorted, and three sorted bounces (camera rays, then two later
    bounces), over all the rays and at the binned tier the traversal takes:
    src, vt, dst and overflow bit-equal to ``packet_bins_plain``'s, one
    launch counted a call."""
    from torch_fixtures import assert_bins_equal

    dev, static, states = _bounce_states(MESH_200K, 192, cuda, bounces=3)
    tables = dev.mxu_mesh
    assert tables.tile_aabb.shape[0] == 196
    paths = _camera_paths(static, _setup(MESH_200K, 192, cuda)[2], cuda)[1]
    cases = [(paths.origin, paths.direction, paths.alive,
              prim_t_min(static, RenderConfig(), paths.origin, paths.direction))] + states
    visits = 0
    for d, state in enumerate(cases):
        for tiers in (None, RenderConfig().mxu_binned_tiers):
            args = _bins_args(tables, *state, tiers)
            before = intersect_mxu.packet_bins.launches
            got = intersect_mxu.packet_bins(*args)
            assert intersect_mxu.packet_bins.launches == before + 1
            want = intersect_mxu.packet_bins_plain(*args)
            assert_bins_equal(got, want)
            visits += int((want.vt >= 0).sum())
    assert visits > 1000


@pytest.mark.parametrize("ct", [1, 79, 300, 1024])
def test_packet_bins_kernels_edge_cases(cuda, ct):
    """``prepass_case``'s boxes and rays (a dead block, a block live in its
    last lane only, a ray on a tile's face) at 1, 79, 300 and 1,024 tiles:
    topk 0, 2, 128 and 2,000 (at or above the tile count: the dense plane
    where 128 >= ct too), under the pair budget, one of 3 visits and none
    (overflowing), over all 6 blocks and a prefix of 2: the kernels
    bit-equal to ``packet_bins_plain``."""
    from torch_fixtures import assert_bins_equal, prepass_case

    aabb, os_, d, live, tl = (x.to(cuda) if isinstance(x, torch.Tensor)
                              else Vec3(*(c.to(cuda) for c in x)) for x in prepass_case(ct))
    overflowed = 0
    for n in (tl.shape[0], 512):
        cut = lambda v: Vec3(*(x[:n] for x in v))
        rays = (cut(os_), cut(d), live[:n], tl[:n])
        for budget in (intersect_mxu.pair_budget(n, ct), 96, 0):
            for topk in (0, 2, 128, 2000):
                want = intersect_mxu.packet_bins_plain(aabb, *rays, budget, topk)
                assert_bins_equal(intersect_mxu.packet_bins(aabb, *rays, budget, topk), want)
                overflowed += bool(want.overflow)
    assert overflowed >= 4


def test_binned_frame_film_matches_the_plain_bins(cuda, monkeypatch):
    """Two 200k frames at 800x800 (the benchmark cell's) through the
    Renderer: the kernels build the bins on every bounce (8 calls a frame)
    and no bounce's bins overflow to the streamed walk; the film is
    bit-equal to the same frames with ``packet_bins_plain`` in the kernels'
    place."""
    scene = load_scene(str(REPO / "scenes" / MESH_200K))
    kernel_bins = intersect_mxu.packet_bins
    films = {}
    for how in ("kernels", "plain"):
        if how == "plain":
            monkeypatch.setattr(intersect_mxu, "packet_bins", intersect_mxu.packet_bins_plain)
        r = Renderer(scene, RenderConfig(), seed=3, device=cuda)
        counts = lambda: (kernel_bins.launches, intersect_mxu._binning.overflows,
                          intersect_mxu.binned_intersect.launches)
        before = counts()
        r.step_many(2)
        torch.cuda.synchronize()
        got = [a - b for a, b in zip(counts(), before)]
        depth = r.static.trace_depth
        assert got == [2 * depth if how == "kernels" else 0, 0, 2 * depth], how
        films[how] = torch.stack(list(r.film), 1)
    assert torch.equal(films["kernels"], films["plain"])
    assert float(films["kernels"].sum()) > 0


def test_mesh_shade_kernel_winner_tie_and_inside(cuda):
    """``tests/torch_fixtures.py::winner_case`` on the card: a two-sphere
    tie at equal t, origins inside a cube and within ray_eps of its face,
    rays that hit no prim, mesh-hit and dead lanes; both emit modes: the
    kernel with the winner bit-equal to its plain version and to itself
    without it."""
    from torch_fixtures import winner_case

    dev, static, _ = _setup(MESH, 8, cuda)
    prim_static, paths, mt, tri = winner_case(static, np.random.default_rng(7), n=4096)
    to = lambda x: x.to(cuda)
    paths = type(paths)(*(type(f)(*map(to, f)) if isinstance(f, tuple) else to(f)
                          for f in paths))
    mt, tri = to(mt), to(tri)
    cfg = RenderConfig()
    win = prim_t_min(prim_static, cfg, paths.origin, paths.direction, winner=True)[1]
    for emit in ("tlim", "tlim+key"):
        args = (prim_static, cfg, paths, mt, None, None, prng.prng_key(4), 4096, emit,
                dev.mxu_mesh)
        got = fused.fused_mesh_shade(*args, prim_winner=win, mesh_tri=tri)
        want = fused.fused_mesh_shade_plain(*args, prim_winner=win, mesh_tri=tri)
        every = fused.fused_mesh_shade(*args, mesh_tri=tri)
        for a, b in zip(_shade_bits(got), _shade_bits(want)):
            assert torch.equal(a, b)
        for a, b in zip(_shade_bits(got), _shade_bits(every)):
            assert torch.equal(a, b)


def test_measuring_scripts_run_on_the_card(cuda, capsys):
    """Each script's main() at a small size on the card: exit 0, JSON lines
    with times and the card's name."""
    import importlib.util
    import json
    import sys

    sys.path.insert(0, str(REPO / "scripts"))
    runs = {
        "torch_profile_epilogue": ["--res", "128", "--k", "2", "--check-plain"],
        "torch_scene_matrix": ["--res", "64", "--spp", "1", "--batch", "1", "--only", "5k"],
        "torch_bench_binned": ["--res", "128", "--k", "2", "scenes/cornell_mesh_200k.json"],
        "torch_profile_mesh_bounce": ["--res", "128", "--k", "2"],
        "torch_profile_wavefront": ["--res", "128", "--k", "2"],
        "torch_diag_mesh_traversal": ["--res", "128", "--k", "2"],
        "torch_bench_scenes": ["--res", "64", "--spp", "2", "--batch", "1", "--quick", "--scenes",
                               "scenes/cornell_dof.json"],
    }
    try:
        for name, argv in runs.items():
            spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            sys.modules[name] = mod
            spec.loader.exec_module(mod)
            assert mod.main(argv) == 0, name
            recs = [json.loads(x) for x in capsys.readouterr().out.splitlines()
                    if x.startswith("{")]
            assert recs and all("NVIDIA" in r["card"] for r in recs), name
            timed = [r.get("ms", r.get("ms_per_frame")) for r in recs if "sort" not in r]
            assert all(t is not None and t > 0 for t in timed), name
    finally:
        sys.path.remove(str(REPO / "scripts"))


# ---------------------------------------------------------------------------
# Bounce prefix tiers (the kernels on a sliced head) and the native BVH
# builder on the card's machine
# ---------------------------------------------------------------------------

# case -> (scene, resolution, config, the bounce body the tiers slice).  The
# wavefront at 256x256: its heads (16,384 and 32,768 rows) reach the scan
# kernel, which takes 16,384 flags and more.
TIER_CASES = {
    "mesh 5k": (MESH, 128, {}, "mesh"),
    "mesh 20k binned": ("cornell_mesh_20k.json", 128, dict(mxu_traversal="binned"), "mesh"),
    "mesh 80k streamed": ("cornell_mesh_80k.json", 128, {}, "mesh"),
    "textured prims": (PRIM_TEX, 128, {}, "tex"),
    "textured mesh": (MESH_TEX, 128, {}, "mesh"),
    "wavefront": ("cornell_dof.json", 256, dict(integrator="wavefront", stream_compaction=True),
                  "wavefront"),
}


@pytest.mark.parametrize("case", list(TIER_CASES))
def test_tiered_paths_match_plain_on_sliced_heads(cuda, case, monkeypatch):
    """Tiers (4, 2) against none on the card: the kernel frames bit-equal
    with equal alive counts, a tier engaged (the bounce bodies' rows), each
    kernel called on a head (the traversal, the shade in its mode, the scan)
    bit-equal to its plain version on the same head, and the tiered kernel
    frame against the tiered ``plain=True`` frame at the film bars."""
    from project3_cuda_path_tracer_2025_tpu_torch.models import wavefront
    from project3_cuda_path_tracer_2025_tpu_torch.ops import scan

    name, res, kw, kind = TIER_CASES[case]
    dev, static, cam = _setup(name, res, cuda)
    n = static.pixel_count
    rows, heads = [], []
    body = {"mesh": (fused, "_fused_mesh_bounce_at", 3), "tex": (fused, "_fused_tex_bounce_at", 3),
            "wavefront": (wavefront, "intersect_scene", 2)}[kind]

    def spy(mod, fname, take):
        fn = getattr(mod, fname)

        def run(*args, **k):
            take(fname, fn, args, k)
            return fn(*args, **k)
        run.__dict__ = fn.__dict__  # the wrapper's launch count is the function's
        monkeypatch.setattr(mod, fname, run)

    spy(body[0], body[1], lambda f, fn, a, k: rows.append(a[body[2]].pixel.shape[0]))
    head_rows = {"mesh_intersect_mxu": lambda a: a[3].x.shape[0],
                 "fused_mesh_shade": lambda a: a[2].origin.x.shape[0],
                 "scan_flat": lambda a: a[0].shape[0]}

    def keep(fname, fn, args, k):
        if head_rows[fname](args) < n:
            heads.append((fname, fn, args, k))
    spy(intersect_mxu, "mesh_intersect_mxu", keep)
    spy(fused, "fused_mesh_shade", keep)
    spy(scan, "scan_flat", keep)
    iterate = wavefront_iteration if kind == "wavefront" else megakernel_iteration
    out = {}
    for tiers in ((4, 2), ()):
        rows.clear()
        film = film_ops.new_film(n, cuda)
        out[tiers] = iterate(dev, static, RenderConfig(bounce_prefix_tiers=tiers, **kw), cam,
                             film, 1, prng.prng_key(0)) + (list(rows),)
    (f1, a1, r1), (f0, a0, r0) = out[(4, 2)], out[()]
    assert all(torch.equal(a, b) for a, b in zip(f1, f0))
    assert torch.equal(a1, a0)
    assert min(r1) < n and set(r0) == {n}, (r1, r0)
    kinds = set()
    for fname, fn, args, k in heads:
        if fname == "mesh_intersect_mxu":
            got, want = fn(*args, **{**k, "plain": False}), fn(*args, **{**k, "plain": True})
            pairs = [(got.t, want.t), (got.tri, want.tri)]
        elif fname == "fused_mesh_shade":
            flat = lambda o: [o] if isinstance(o, torch.Tensor) else (
                [] if o is None else [x for e in o for x in flat(e)])
            pairs = list(zip(flat(fn(*args, **k)), flat(fused.fused_mesh_shade_plain(*args, **k))))
            fname = f"shade {k.get('mode', 'plain')}"
        else:
            pairs = [(fn(*args, **k), scan.scan_flat_plain(*args, **k))]
        assert all(torch.equal(a, b) for a, b in pairs), (case, fname)
        kinds.add(fname)
    want_kinds = {"mesh": {"mesh_intersect_mxu", "shade plain"}, "wavefront": {"scan_flat"},
                  "tex": {"mesh_intersect_mxu", "shade precomputed"}}[kind]
    if name == MESH_TEX:
        want_kinds = {"mesh_intersect_mxu", "shade textured"}
    assert want_kinds <= kinds, (case, kinds)
    if kind != "wavefront":
        film_p, alive_p = megakernel_iteration(
            dev, static, RenderConfig(bounce_prefix_tiers=(4, 2), **kw), cam,
            film_ops.new_film(n, cuda), 1, prng.prng_key(0), plain=True)
        got = torch.stack(list(f1), 1).cpu().numpy()
        want = torch.stack(list(film_p), 1).cpu().numpy()
        outside = ~np.isclose(got, want, rtol=2e-4, atol=2e-5)
        assert outside.any(axis=1).mean() <= 0.005
        np.testing.assert_allclose(got.sum(), want.sum(), rtol=1e-4)


def test_native_bvh_on_the_cards_machine(cuda):
    """The native BVH builder builds and loads where the card is; the
    renderer's default tree is its tree, and the 5k frame with it agrees
    with the NumPy tree's at the film bars."""
    from project3_cuda_path_tracer_2025_tpu_torch.native import bvh_native

    assert bvh_native.load() is not None and bvh_native.library_path().is_file()
    path = str(REPO / "scenes" / MESH)
    scene = set_resolution(load_scene(path), 64, 64)
    native = bvh_native.build(scene.tri_positions, scene.tri_centroids, 4)
    assert np.array_equal(scene.bvh.tri_indices, native["tri_indices"])
    films = []
    for tree in (True, False):
        r = Renderer(set_resolution(load_scene(path, native_bvh=tree), 64, 64),
                     RenderConfig(native_bvh=tree), device=cuda)
        r.step_many(2)
        films.append(torch.stack(list(r.film), 1).cpu().numpy())
    outside = ~np.isclose(films[0], films[1], rtol=2e-4, atol=2e-5)
    assert outside.any(axis=1).mean() <= 0.005
    np.testing.assert_allclose(films[0].sum(), films[1].sum(), rtol=1e-4)
