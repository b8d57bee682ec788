"""The chunked chain of the port against the JAX package's (``_run``
:2607-2658 there, ``_chain`` here): a mesh of more triangles than one call
takes (``chunk_tris``) runs as one call per chunk of tiles, each call's
t_limit the running closest hit.

With ``chunk_tris=GROUP_TRIS`` (one tile a call, as
``tests/test_intersect_mxu.py:124,193`` force the chain on small meshes):
the sweep branch (each chunk behind its envelope cull, then the sweep) and
the planned branch (each chunk's plan built against the running best, then
a planned walk), ray sorting off and on, on a random 2,300-triangle mesh (3
chunks), on the two-tile tie mesh (an exact tie across chunks stays with the
earlier one) and on the two synthetic tables of the JAX package's own chain
tests (a real tile and a never-hit one; a third of the rays pointing away
from the mesh and short t_limits, so that the envelope cull differs per ray
and a cull taken from unsorted origins would drop hits).  Each result is
held to the JAX package's chain in interpret mode and to the port's single
call.  Beyond the streamed plan's 1,024 tiles "streamed" and "binned" fall
back to the planned chain: a 1,025-tile table (3 real tiles, the rest
empty and far away) must give what the 3 real tiles give in one call.

Tolerance: none; ``t`` and ``tri`` are bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_2025_tpu.ops import intersect_mxu as jm
from project3_cuda_path_tracer_2025_tpu_torch.ops import intersect_mxu as mxu
from project3_cuda_path_tracer_2025_tpu_torch.utils.vec import Vec3
from test_torch_mesh_planned import traversal_case
from torch_compare import TIE_TRIS, never_hit_padded, run_tables_both, sphere_rays

from project3_cuda_path_tracer_2025_tpu.utils.vec import Vec3 as JVec3

ONE_TILE = mxu.GROUP_TRIS


def _arrays(jt):
    return (jt.features, jt.tile_aabb, jt.group_aabb, jt.center)


def _equal(got, want, min_hits=50):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert (got[1] >= 0).sum() >= min_hits


@pytest.fixture(scope="module", params=["random_2300", "tie"])
def case(request):
    return request.param, traversal_case(request.param)


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("planned", [False, True], ids=["sweep", "planned"])
def test_chain_matches_jax_and_the_single_call(case, planned, sort):
    name, c = case
    num, padded, bounds = c["sizes"]
    kw = dict(sort=sort, bounds=bounds, planned=planned)
    got, want = run_tables_both(_arrays(c["jt"]), c["pt"], num, padded, c["j"], c["t"],
                                chunk_tris=ONE_TILE, **kw)
    _equal(got, want)
    single = mxu.mesh_intersect_mxu(c["pt"], num, padded, *c["t"], 1e-5, sort_rays=sort,
                                    mesh_bounds=bounds, planned=planned, compute_uv=False)
    _equal(got, (single.t.numpy(), single.tri.numpy()))
    if name == "tie":  # the tie across chunks stays with the earlier chunk
        assert set(np.unique(got[1][got[1] >= 0])) == {TIE_TRIS[0]}


def test_chain_walks_a_plan_per_chunk(monkeypatch):
    """The planned branch builds one plan per chunk against the running best
    (t_limits that shrink from chunk to chunk) and reads the live position
    to the host no more than once."""
    c = traversal_case("random_2300")
    num, padded, bounds = c["sizes"]
    seen, reads = [], []
    plan, pos = mxu.plan_with_prefix, mxu.live_position
    monkeypatch.setattr(mxu, "plan_with_prefix",
                        lambda aabb, os, d, live, tl, *a, **k:
                        seen.append((aabb.shape[0], tl.clone())) or plan(aabb, os, d, live, tl,
                                                                         *a, **k))
    monkeypatch.setattr(mxu, "live_position", lambda live: reads.append(1) or pos(live))
    mxu.mesh_intersect_mxu(c["pt"], num, padded, *c["t"], 1e-5, planned=True,
                           chunk_tris=ONE_TILE, compute_uv=False)
    assert [s[0] for s in seen] == [1, 1, 1]
    assert all((b[1] <= a[1]).all() for a, b in zip(seen, seen[1:]))
    assert (seen[2][1] < seen[0][1]).any()
    assert len(reads) <= 1


def _synthetic(seed, away):
    """A one-tile random mesh grown by a never-hit tile, and 500 rays; with
    ``away`` a third of them leave the mesh behind and half of the t_limits
    are 2.0 or 0.5 (``tests/test_intersect_mxu.py:143-196``)."""
    c = traversal_case("random_150")
    rng = np.random.default_rng(seed)
    n = 500
    o, d = sphere_rays(rng, n)
    if away:
        out = rng.random(n) < 0.33
        d = np.where(out[:, None], o / 3.0, d).astype(np.float32)
        active = rng.random(n) > 0.3
        lim = np.where(rng.random(n) > 0.5, 3.4e38,
                       np.where(rng.random(n) > 0.5, 2.0, 0.5)).astype(np.float32)
    else:
        active = rng.random(n) > 0.1
        lim = np.full(n, 3.4e38, np.float32)
    j3 = lambda a: JVec3(*[jnp.asarray(a[:, i]) for i in range(3)])
    t3 = lambda a: Vec3(*[torch.from_numpy(a[:, i].copy()) for i in range(3)])
    jarrs, pt = never_hit_padded(c["jt"], 2)
    return dict(jarrs=jarrs, pt=pt, num=c["sizes"][0], bounds=c["sizes"][2],
                j=(j3(o), j3(d), jnp.asarray(active), jnp.asarray(lim)),
                t=(t3(o), t3(d), torch.from_numpy(active), torch.from_numpy(lim)))


def test_chunked_synthetic_matches_single():
    s = _synthetic(44, away=False)
    args = (s["jarrs"], s["pt"], s["num"], 2 * ONE_TILE, s["j"], s["t"])
    single, jsingle = run_tables_both(*args)
    chunked, jchunked = run_tables_both(*args, chunk_tris=ONE_TILE)
    _equal(single, jsingle)
    _equal(chunked, jchunked)
    _equal(chunked, single)


@pytest.mark.parametrize("planned", [False, True], ids=["sweep", "planned"])
def test_chunked_sorted_envelope_cull(planned):
    s = _synthetic(46, away=True)
    args = (s["jarrs"], s["pt"], s["num"], 2 * ONE_TILE, s["j"], s["t"])
    base, jbase = run_tables_both(*args, bounds=s["bounds"])
    got, want = run_tables_both(*args, bounds=s["bounds"], sort=True, planned=planned,
                                chunk_tris=ONE_TILE)
    _equal(base, jbase, min_hits=20)
    _equal(got, want, min_hits=20)
    _equal(got, base, min_hits=20)


@pytest.mark.parametrize("flags", [dict(planned=True, streamed=True),
                                   dict(planned=True, streamed=True, binned=True)],
                         ids=["streamed", "binned"])
def test_beyond_the_streamed_plan_falls_back_to_the_chain(flags, monkeypatch):
    """1,025 tiles: 3 real, 1,022 empty ones far away.  "streamed" and "binned" become
    the planned chain (33 chunks of 32 tiles, the last of 1), and give what
    one call over the 3 real tiles gives."""
    c = traversal_case("random_2300")
    num, padded, bounds = c["sizes"]
    _, big = never_hit_padded(c["jt"], 1025, far=True)
    chunks = []
    walk = mxu.walk_plain
    monkeypatch.setattr(mxu, "walk_plain", lambda tables, *a: chunks.append(
        tables.tile_aabb.shape[0]) or walk(tables, *a))
    got = mxu.mesh_intersect_mxu(big, num, 1025 * ONE_TILE, *c["t"], 1e-5, sort_rays=True,
                                 mesh_bounds=bounds, compute_uv=False, plain=True, **flags)
    assert chunks == [32] * 32 + [1]
    monkeypatch.undo()
    want = mxu.mesh_intersect_mxu(c["pt"], num, padded, *c["t"], 1e-5, sort_rays=True,
                                  mesh_bounds=bounds, compute_uv=False, planned=True)
    _equal((got.t.numpy(), got.tri.numpy()), (want.t.numpy(), want.tri.numpy()))
    jwant = jm.mesh_intersect_mxu(c["jt"], num, padded, *c["j"], 1e-5, interpret=True,
                                  planned=True, planned_epilogue="running")
    _equal((got.t.numpy(), got.tri.numpy()), (np.asarray(jwant.t), np.asarray(jwant.tri)))


def test_planned_chain_render_is_bit_identical_to_auto():
    """8x8, depth 3, 1 spp of cornell_mesh_80k.json (79 tiles): "planned" is
    the planned chain of 3 chunks (32, 32 and 15 tiles), "sweep" the sweep
    chain, "auto" the streamed walk; one film."""
    import pathlib

    from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer
    from project3_cuda_path_tracer_2025_tpu_torch.scene import load_scene, set_resolution

    repo = pathlib.Path(__file__).resolve().parent.parent
    scene = set_resolution(load_scene(str(repo / "scenes" / "cornell_mesh_80k.json")), 8, 8)
    scene.state.trace_depth = 3
    films = {}
    for mode in ("auto", "planned", "sweep"):
        r = Renderer(scene, RenderConfig(mxu_traversal=mode, mesh_intersector="mxu",
                                         fused_bounce="on"), seed=0, device="cpu")
        r.step_many(1)
        films[mode] = torch.stack(list(r.film), 1).numpy(), r._alive_counts
    assert films["auto"][0].sum() > 0
    for mode in ("planned", "sweep"):
        np.testing.assert_array_equal(films[mode][0], films["auto"][0])
        np.testing.assert_array_equal(films[mode][1], films["auto"][1])
