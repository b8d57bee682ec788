"""The mesh shade's carried prim winner in the port's torch code, without
the card: ``prim_t_min(..., winner=True)``, ``intersect_winner``, the plain
shade given the winner (``fused_mesh_shade_plain(prim_winner=...)``), and a
whole frame with and without the carry.

Taking the winner back must give what testing every prim gives, bit for
bit: the winner's test repeats the same float32 operations on the same
origin and direction.  So everything here is compared exactly (float
planes by their bits).  The rays: the camera rays of
``scenes/cornell_mesh_5k.json`` and the bounces after them, and
``tests/torch_fixtures.py::winner_case`` (a two-sphere tie at equal t,
origins inside a cube and within ray_eps of its face, rays that hit no
prim, made-up mesh hits, dead lanes).
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu_torch.models import megakernel_iteration
from project3_cuda_path_tracer_2025_tpu_torch.ops import camera as camera_ops
from project3_cuda_path_tracer_2025_tpu_torch.ops import film as film_ops
from project3_cuda_path_tracer_2025_tpu_torch.ops import fused
from project3_cuda_path_tracer_2025_tpu_torch.ops.intersect import (
    intersect_scene, intersect_winner, prim_t_min,
)
from project3_cuda_path_tracer_2025_tpu_torch.scene import (
    build_device_scene, camera_state, derive_render_camera, load_scene, set_resolution,
)
from project3_cuda_path_tracer_2025_tpu_torch.utils import prng
from project3_cuda_path_tracer_2025_tpu_torch.utils.vec import Vec3
from torch_fixtures import winner_case

REPO = pathlib.Path(__file__).resolve().parent.parent
SCENES = {"plain": "cornell_mesh_5k.json", "textured": "cornell_mesh_textured_local.json"}


def _setup(name, res):
    scene = set_resolution(load_scene(str(REPO / "scenes" / name)), res, res)
    dev, static = build_device_scene(scene, "cpu")
    return scene, dev, static, camera_state(derive_render_camera(scene.state.camera))


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_same(got, want):
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))


def _isect_planes(i):
    return [i.t, *i.normal, i.material_id, i.uv_u, i.uv_v, *i.dpdu, *i.dpdv, i.is_triangle]


def _camera_paths(static, cam):
    n = static.pixel_count
    ik = prng.iteration_key(prng.prng_key(0), 1)
    return ik, camera_ops.generate_camera_rays(
        cam, static.width, static.height, static.trace_depth,
        prng.uniforms_at(prng.stage_key(ik, 0, 0), torch.arange(n), 4, n))


@pytest.mark.parametrize("case", ["camera", "crafted"])
def test_winner_gives_the_nearest_hit(case):
    """``prim_t_min``'s t is the same with and without the winner, and
    ``intersect_winner`` on it equals ``intersect_scene`` on every lane."""
    _, _, static, cam = _setup("cornell_mesh_5k.json", 16)
    cfg = RenderConfig()
    if case == "camera":
        prim_static = dataclasses.replace(static, num_triangles=0)
        paths = _camera_paths(static, cam)[1]
    else:
        prim_static, paths = winner_case(static, np.random.default_rng(1))[:2]
    t, win = prim_t_min(prim_static, cfg, paths.origin, paths.direction, winner=True)
    _assert_same([t], [prim_t_min(prim_static, cfg, paths.origin, paths.direction)])
    assert win.dtype == torch.int32 and bool(((win >= -1) & (win < len(prim_static.geoms))).all())
    want = intersect_scene(None, prim_static, paths, cfg)
    _assert_same(_isect_planes(intersect_winner(prim_static, paths, cfg, win)),
                 _isect_planes(want))
    assert bool((want.t[win >= 0] == t[win >= 0]).all())
    if case == "crafted":
        q, k = paths.pixel.shape[0] // 4, len(static.geoms)
        assert bool((win[:q] != k + 1).all()) and int((win[:q] == k).sum()) > 100
        assert bool((win[3 * q:] == -1).all())


@pytest.mark.parametrize("emit", ["tlim", "tlim+key"])
@pytest.mark.parametrize("mode", ["plain", "textured"])
def test_plain_shade_with_the_carried_winner(mode, emit):
    """Three chained bounces of the plain shade at 16x16, each given the
    winner the bounce before emitted (the first the prepass's): every
    output, the emitted t_lim, key and winner included, equals the shade's
    without the winner."""
    _, dev, static, cam = _setup(SCENES[mode], 16)
    cfg = RenderConfig()
    n = static.pixel_count
    prim_static = dataclasses.replace(static, num_triangles=0)
    tables = dev.mxu_mesh
    ik, paths = _camera_paths(static, cam)
    tl, win = prim_t_min(static, cfg, paths.origin, paths.direction, winner=True)
    taken = 0
    for d in range(3):
        if mode == "plain":
            mh = fused.mesh_walk(tables, static, cfg, paths, tl)
            surf, alb, tri = (mh.t, None, None), None, mh.tri
        else:
            *surf, alb = fused.textured_mesh_surface(dev, static, cfg, paths, tl)
            tri = None
        args = (prim_static, cfg, paths, *surf, prng.stage_key(ik, d, 1), n, emit, tables)
        got_p, (got_tl, got_key, got_win) = fused.fused_mesh_shade_plain(
            *args, mode=mode, mesh_albedo=alb, prim_winner=win, mesh_tri=tri)
        want_p, (want_tl, want_key, _) = fused.fused_mesh_shade_plain(
            *args, mode=mode, mesh_albedo=alb, mesh_tri=tri)
        _assert_same([*got_p.origin, *got_p.direction, *got_p.color, got_p.bounces, got_tl],
                     [*want_p.origin, *want_p.direction, *want_p.color, want_p.bounces, want_tl])
        if emit == "tlim+key":
            assert torch.equal(got_key, want_key)
        _assert_same([got_win], [prim_t_min(prim_static, cfg, want_p.origin, want_p.direction,
                                            winner=True)[1]])
        taken += int((paths.alive & ((surf[2] if tri is None else tri) < 0) & (win >= 0)).sum())
        paths, tl, win = got_p, got_tl, got_win
    assert taken > 50


def test_plain_shade_winner_crafted():
    """``winner_case``'s rays through the plain shade, two chained bounces:
    the same outputs with the winner as without."""
    _, dev, static, _ = _setup("cornell_mesh_5k.json", 8)
    cfg = RenderConfig()
    prim_static, paths, mt, tri = winner_case(static, np.random.default_rng(2))
    n = paths.pixel.shape[0]
    ik = prng.iteration_key(prng.prng_key(1), 4)
    win = prim_t_min(prim_static, cfg, paths.origin, paths.direction, winner=True)[1]
    for d in range(2):
        args = (prim_static, cfg, paths, mt, None, None, prng.stage_key(ik, d, 1), n, "tlim",
                dev.mxu_mesh)
        got_p, (got_tl, _, got_win) = fused.fused_mesh_shade_plain(*args, prim_winner=win,
                                                                   mesh_tri=tri)
        want_p, (want_tl, _, _) = fused.fused_mesh_shade_plain(*args, mesh_tri=tri)
        _assert_same([*got_p.origin, *got_p.direction, *got_p.color, got_p.bounces, got_tl],
                     [*want_p.origin, *want_p.direction, *want_p.color, want_p.bounces, want_tl])
        paths, win, tri = got_p, got_win, torch.full_like(tri, -1)


def test_shade_refuses_a_winner_it_cannot_use():
    _, _, static, _ = _setup("cornell_mesh_5k.json", 8)
    prim_static, paths, mt, mm = winner_case(static, np.random.default_rng(0), n=64)
    surface = Vec3(mt, mt, mt)
    args = (prim_static, RenderConfig(), paths, mt, surface, mm, prng.prng_key(0), 64)
    with pytest.raises(ValueError, match="takes no prim_winner"):
        fused.fused_mesh_shade_plain(*args, mode="precomputed", mesh_albedo=surface,
                                     prim_winner=torch.zeros_like(mm))


@pytest.mark.parametrize("case", ["plain with a normal", "plain with a material",
                                  "plain without tables", "plain without a winner",
                                  "textured without a normal", "textured with a winner"])
def test_shade_checks_each_modes_mesh_inputs(case):
    """Mode "plain" takes the walk's winner (``mesh_tri``) and the tables'
    rows and no normal or material; the textured modes take a resolved
    normal and the material and no winner."""
    _, dev, static, _ = _setup("cornell_mesh_5k.json", 8)
    prim_static, paths, mt, tri = winner_case(static, np.random.default_rng(0), n=64)
    surface, mat = Vec3(mt, mt, mt), torch.zeros_like(tri)
    resolved, walk = "mesh_normal, mesh_mat and mesh_albedo are required", "mesh_tri and tables"
    normal, material, winner, tables, mode, match = {
        "plain with a normal": (surface, None, tri, dev.mxu_mesh, "plain", resolved),
        "plain with a material": (None, mat, tri, dev.mxu_mesh, "plain", resolved),
        "plain without tables": (None, None, tri, None, "plain", walk),
        "plain without a winner": (None, None, None, dev.mxu_mesh, "plain", walk),
        "textured without a normal": (None, mat, None, dev.mxu_mesh, "textured", resolved),
        "textured with a winner": (surface, mat, tri, dev.mxu_mesh, "textured", walk),
    }[case]
    with pytest.raises(ValueError, match=match):
        fused.fused_mesh_shade(prim_static, RenderConfig(), paths, mt, normal, material,
                               prng.prng_key(0), 64, tables=tables, mode=mode,
                               mesh_albedo=None if mode == "plain" else surface,
                               mesh_tri=winner)


@pytest.mark.parametrize("sorting", ["on", "off"])
def test_frame_is_the_same_with_and_without_the_carried_winner(sorting):
    """``megakernel_iteration`` with ``fused_bounce="on"`` on the 5k mesh
    at 16x16 (the kernels' plain versions on the CPU; with sorting on, the
    winner is permuted with the rays at each resort): film and alive counts
    bit for bit with and without the carry."""
    _, dev, static, cam = _setup("cornell_mesh_5k.json", 16)
    cfg = RenderConfig(fused_bounce="on", ray_sorting=sorting)
    n = static.pixel_count
    runs = [megakernel_iteration(dev, static, cfg, cam, film_ops.new_film(n), 1,
                                 prng.prng_key(0), carry_winner=c) for c in (True, False)]
    (film_w, alive_w), (film_a, alive_a) = runs
    _assert_same([*film_w, alive_w], [*film_a, alive_a])
    assert int(alive_w[0]) > 0 and float(film_w.x.sum()) > 0
