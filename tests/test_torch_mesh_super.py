"""The super-tile streamed walk (``_streamed_super_kernel``, Pallas #8) of
the port against the JAX package's.

With ``PTT_STREAM_SUPER=1``, ``mesh_intersect_mxu(streamed=True)`` walks a
plan of super-tiles (8 contiguous tiles under their envelope) in both
packages.  On the CPU the port runs ``streamed_super_plain``; the JAX
package runs its Pallas kernel in interpret mode.  Cases, as in
``tests/test_intersect_mxu.py:656-691``: a random 2,300-triangle mesh whose
3 tiles make one short super-tile (the switch set after the tables exist,
so the JAX wrapper pads them to 8 and the port's kernel never takes a tile
past the last), ray sorting off and on; and 33,000 random triangles built
with the switch already on, so that ``build_mxu_tables`` pads the 33 tiles
to 40 in both packages (equal arrays, ``padded_tris`` still 33 tiles'
worth).  The super plan (the tile plan over the super boxes) must equal the
JAX package's, and the switch must read alike ("0" off, "1" on, anything
else on beyond 320k triangles).

Tolerance: none; ``t``, ``tri`` and the plan are bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_2025_tpu.ops import intersect_mxu as jm
from project3_cuda_path_tracer_2025_tpu_torch.ops import intersect_mxu as mxu
from test_torch_mesh_plan import _assert_plans_equal, _inputs
from test_torch_mesh_planned import assert_bit_equal, run_both, traversal_case
from torch_compare import mesh_tables_pair, pair, pair1, sphere_rays

SUPER = dict(planned=True, streamed=True)


@pytest.mark.parametrize("mode", ["0", "1", "auto"])
@pytest.mark.parametrize("padded", [33 * 1024, 320 * 1024, 321 * 1024])
def test_switch_reads_like_jax(monkeypatch, mode, padded):
    monkeypatch.setenv("PTT_STREAM_SUPER", mode)
    assert mxu.stream_super_enabled(padded) == jm.stream_super_enabled(padded)
    assert mxu.stream_super_enabled(padded) == (mode == "1" or (mode == "auto"
                                                                and padded > 320 * 1024))
    assert (mxu.SUPER_TILES, mxu.STREAM_SUPER_MIN) == (jm.SUPER_TILES, jm.STREAM_SUPER_MIN)


@pytest.mark.parametrize("sort", [False, True])
def test_super_walk_matches_jax(monkeypatch, sort):
    """3 tiles, the switch set after the tables were built."""
    c = traversal_case("random_2300")
    monkeypatch.setenv("PTT_STREAM_SUPER", "1")
    taken = []
    plain = mxu.streamed_super_plain
    monkeypatch.setattr(mxu, "streamed_super_plain",
                        lambda *a: taken.append(a[5].cnt.shape[0]) or plain(*a))
    got, want = run_both(c, sort, **SUPER)
    assert taken == [3]  # the super walk ran, over 3 blocks
    assert_bit_equal(got, want)
    monkeypatch.setenv("PTT_STREAM_SUPER", "0")
    num, padded, bounds = c["sizes"]
    ref = mxu.mesh_intersect_mxu(c["pt"], num, padded, *c["t"], 1e-5, sort_rays=sort,
                                 mesh_bounds=bounds, planned=True, planned_epilogue="running")
    assert torch.equal(got.tri, ref.tri) and torch.equal(got.t, ref.t)
    assert taken == [3]


def _jax_super_aabb(aabb):
    """The super boxes as ``run_streamed_super`` builds them (:2381-2402)."""
    s = jm.SUPER_TILES
    ct = aabb.shape[0]
    cs = (ct + s - 1) // s
    never = np.concatenate([np.full((cs * s - ct, 3), 1e30), np.full((cs * s - ct, 5), -1e30)],
                           1).astype(np.float32)
    grp = np.concatenate([aabb, never]).reshape(cs, s, 8)
    return np.concatenate([grp[:, :, 0:3].min(1), grp[:, :, 3:6].max(1),
                           np.zeros((cs, 2), np.float32)], 1)


@pytest.mark.parametrize("tiles", [3, 20])
def test_super_plan_equals_jax(tiles):
    """The plan over the super boxes of the first ``tiles`` tiles of a
    20-tile random mesh (one short super; two whole ones and a short one),
    4,096 rays whose live rays fill the 1/4 prefix."""
    rng = np.random.default_rng(70 + tiles)
    pos = rng.uniform(-1, 1, (20 * 1024, 1, 3)) + rng.uniform(-0.1, 0.1, (20 * 1024, 3, 3))
    pos = pos[np.argsort(pos[:, 0, 0])].astype(np.float32)  # tiles are slabs in x
    jt, pt = mesh_tables_pair(pos)
    aabb = pt.tile_aabb[:tiles]
    saabb = mxu.super_aabb(aabb)
    want_boxes = _jax_super_aabb(aabb.numpy())
    np.testing.assert_array_equal(saabb.numpy(), want_boxes)
    n = 4096
    o, d = sphere_rays(rng, n)
    live = np.arange(n) < 900
    lim = np.where(rng.random(n) > 0.5, 3.4e38, 3.0).astype(np.float32)
    (rayf, tlim), port = _inputs(pt, o, d, live, lim)
    got = mxu.plan_with_prefix(saabb, *port)
    want = jm._plan_with_prefix(jnp.asarray(want_boxes), rayf, tlim)
    _assert_plans_equal(got, want)
    assert saabb.shape[0] == -(-tiles // 8) and int(got.cnt.sum()) > 0


def test_tables_built_with_the_switch_on(monkeypatch):
    """33,000 triangles: 33 tiles, padded to 40 when the switch is on at
    build time, in both packages; then the super walk over those tables."""
    rng = np.random.default_rng(77)
    t = 33_000
    pos = rng.uniform(-1, 1, (t, 1, 3)) + rng.uniform(-0.05, 0.05, (t, 3, 3))
    pos = pos[np.argsort(pos[:, 0, 0])].astype(np.float32)
    z = lambda *s: np.zeros(s, np.float32)
    build = lambda m: m.build_mxu_tables(pos, z(t, 3, 3), z(t, 3, 2), z(t, 3), z(t, 3),
                                         np.zeros(t, np.int32))
    monkeypatch.setenv("PTT_STREAM_SUPER", "auto")  # 33k is below the auto band
    assert build(mxu).tile_aabb.shape[0] == build(jm).tile_aabb.shape[0] == 33
    monkeypatch.setenv("PTT_STREAM_SUPER", "1")
    jt, own = build(jm), build(mxu)
    assert own.tile_aabb.shape[0] == jt.tile_aabb.shape[0] == 40
    for f in ("features", "tile_aabb", "attrs", "attrs_shade", "center"):
        np.testing.assert_array_equal(getattr(own, f).numpy(), np.asarray(getattr(jt, f)), f)
    n = 600
    o, d = sphere_rays(rng, n)
    (ro, jro), (rd, jrd) = pair(o.T), pair(d.T)
    active, jactive = pair1(rng.random(n) > 0.2)
    lim, jlim = pair1(np.where(rng.random(n) > 0.5, 3.4e38, 3.0).astype(np.float32))
    padded = 33 * 1024  # the scene constant is not super-padded in either package
    want = jm.mesh_intersect_mxu(jt, t, padded, jro, jrd, jactive, jlim, 1e-5, interpret=True,
                                 sort_rays=True, **SUPER)
    got = mxu.mesh_intersect_mxu(own, t, padded, ro, rd, active, lim, 1e-5, sort_rays=True,
                                 **SUPER)
    assert_bit_equal(got, want)
    ref = mxu.mesh_intersect_mxu(own, t, padded, ro, rd, active, lim, 1e-5, sort_rays=True)
    assert torch.equal(got.tri, ref.tri) and torch.equal(got.t, ref.t)  # the sweep chain
