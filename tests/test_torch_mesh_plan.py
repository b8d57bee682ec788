"""The tile plan and the packet bins of the port against the JAX package's.

The plan (``_build_tile_plan`` and ``_plan_with_prefix`` there,
``build_tile_plan`` and ``plan_with_prefix`` here) is each 256-ray block's
candidate tiles, front to back; the packet bins (``_packet_bins`` /
``packet_bins``) lay the 8-ray packets of each tile's candidates out
tile-major for the binned visits.  Both are float32 slab arithmetic with
integer and boolean results, sorts and scatters: the arrays must be equal.
Cases: a random 2,300-triangle mesh (3 tiles) with rays from a sphere
around it, 700 rays (3 blocks) and 4,096 rays (16 blocks) whose live rays
fill the 1/16 prefix, the 1/4 prefix or all of it; and, as in the JAX
package's ``tests/test_intersect_mxu.py:437-504``, a random 9,000-triangle
mesh crossed by rays in a narrow corridor, so that packets hit a strict
subset of tiles and a top-K slot list shorter than the tile count holds
every packet's candidates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_2025_tpu.ops import intersect_mxu as jm
from project3_cuda_path_tracer_2025_tpu.scene import build_device_scene as j_build
from project3_cuda_path_tracer_2025_tpu_torch.ops import intersect_mxu as mxu
from project3_cuda_path_tracer_2025_tpu_torch.scene import from_jax_scene
from project3_cuda_path_tracer_2025_tpu_torch.utils.vec import Vec3
from tests.test_intersect import _random_mesh_scene
from torch_compare import sphere_rays


def _mesh(n_tris, seed):
    rng = np.random.default_rng(seed)
    jdev, js = j_build(_random_mesh_scene(rng, n_tris=n_tris))
    dev, _ = from_jax_scene(jax.tree_util.tree_map(np.asarray, jdev), js)
    return rng, jdev.mxu_mesh, dev.mxu_mesh, js


def _inputs(tables, o, d, live, lim):
    """Both sides' padded plan inputs: JAX's rayf [n_pad, 16] / tlim
    [n_pad, 1] as ``_run`` builds them, the port's (os, d, live, tl)."""
    n = o.shape[0]
    n_pad = (n + 255) // 256 * 256
    c = tables.center.numpy()
    pad = lambda a, f: np.concatenate([a, np.full((n_pad - n,) + a.shape[1:], f, a.dtype)])
    osp = pad(o - c, 0.0).astype(np.float32)
    dp = pad(d, 0.0)
    one = pad(live.astype(np.float32), 0.0)
    tl = pad(lim, np.float32(3.4e38))
    rayf = np.zeros((n_pad, 16), np.float32)
    rayf[:, 0:3] = dp * one[:, None]
    rayf[:, 3] = (osp[:, 1] * dp[:, 2] - osp[:, 2] * dp[:, 1]) * one
    rayf[:, 4] = (osp[:, 2] * dp[:, 0] - osp[:, 0] * dp[:, 2]) * one
    rayf[:, 5] = (osp[:, 0] * dp[:, 1] - osp[:, 1] * dp[:, 0]) * one
    rayf[:, 6:9] = osp * one[:, None]
    rayf[:, 9] = one
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    port = (Vec3(*(t(osp[:, i]) for i in range(3))), Vec3(*(t(dp[:, i]) for i in range(3))),
            t(one > 0), t(tl))
    return (jnp.asarray(rayf), jnp.asarray(tl[:, None])), port


def _assert_plans_equal(got, want):
    for a, b, name in zip(got, want, ("ids", "tlo", "cnt")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.fixture(scope="module")
def mesh():
    return _mesh(2300, 80)


def test_build_tile_plan_matches_jax(mesh):
    rng, jt, pt, _ = mesh
    n = 700
    o, d = sphere_rays(rng, n)
    d[::13, 1] = 0.0  # exact zero components take the 1e-20 guard
    live = rng.random(n) > 0.3
    lim = np.where(rng.random(n) > 0.5, 3.4e38, 2.0).astype(np.float32)
    (rayf, tlim), (os, dp, lv, tl) = _inputs(pt, o, d, live, lim)
    got = mxu.build_tile_plan(pt.tile_aabb, os, dp, lv, tl)
    want = jm._build_tile_plan(jt.tile_aabb, rayf[:, 6:9], rayf[:, 0:3], rayf[:, 9], tlim[:, 0])
    _assert_plans_equal(got, want)
    assert got.cnt.sum() > 0 and not torch.isinf(got.tlo[:got.cnt[0]]).any()


@pytest.mark.parametrize("last_live,npre", [(200, 256), (900, 1024), (4000, 4096)])
def test_plan_with_prefix_matches_jax(mesh, last_live, npre):
    """16 blocks; the live rays end before ray ``last_live``, so the plan is
    built over the first ``npre`` rays (the 1/16 prefix, the 1/4 prefix,
    all of them) and the blocks past it are empty."""
    rng, jt, pt, _ = mesh
    n = 4096
    o, d = sphere_rays(rng, n)
    live = (rng.random(n) > 0.3) & (np.arange(n) < last_live)
    lim = np.where(rng.random(n) > 0.5, 3.4e38, 2.0).astype(np.float32)
    (rayf, tlim), (os, dp, lv, tl) = _inputs(pt, o, d, live, lim)
    got = mxu.plan_with_prefix(pt.tile_aabb, os, dp, lv, tl)
    want = jm._plan_with_prefix(jt.tile_aabb, rayf, tlim)
    _assert_plans_equal(got, want)
    assert mxu.live_position(lv) < last_live
    nb_pre = npre // 256
    assert got.cnt[:nb_pre].sum() > 0 and (got.cnt[nb_pre:] == 0).all()
    if npre < n:  # the prefix plan equals the plan of the prefix rays
        cut = lambda v: Vec3(*(x[:npre] for x in v))
        sub = mxu.build_tile_plan(pt.tile_aabb, cut(os), cut(dp), lv[:npre], tl[:npre])
        torch.testing.assert_close(got.ids[:nb_pre * 3], sub.ids, rtol=0, atol=0)


def _assert_bins_equal(got, want):
    src, vt, dst, ovf = want
    np.testing.assert_array_equal(got.src.numpy(), np.asarray(src))
    np.testing.assert_array_equal(got.vt.numpy(), np.asarray(vt))
    assert (got.dst is None) == (dst is None)
    if dst is not None:
        np.testing.assert_array_equal(got.dst.numpy(), np.asarray(dst))
    assert bool(got.overflow) == bool(np.asarray(ovf))


@pytest.mark.parametrize("topk", [0, 128, 2, 1])
def test_packet_bins_match_jax(mesh, topk):
    rng, jt, pt, _ = mesh
    n = 1100
    o, d = sphere_rays(rng, n)
    live = rng.random(n) > 0.3
    lim = np.where(rng.random(n) > 0.5, 3.4e38, 2.0).astype(np.float32)
    (rayf, tlim), (os, dp, lv, tl) = _inputs(pt, o, d, live, lim)
    ct = pt.tile_aabb.shape[0]
    budget = mxu.pair_budget(os.x.shape[0], ct)
    got = mxu.packet_bins(pt.tile_aabb, os, dp, lv, tl, budget, topk)
    _assert_bins_equal(got, jm._packet_bins(jt.tile_aabb, rayf, tlim, budget, topk))
    assert (got.vt >= 0).sum() > 3


def test_packet_bins_engaged_top_k_match_jax():
    """Corridor rays (+x through a band of the mesh): for the largest K <
    Ct that does not overflow, the bins equal JAX's and hold the same slots
    as the dense scatter's."""
    rng, jt, pt, js = _mesh(9000, 81)
    ct = pt.tile_aabb.shape[0]
    n = 1100
    lo3, hi3 = np.asarray(js.mesh_bounds[:3]), np.asarray(js.mesh_bounds[3:])
    o = np.stack([np.full(n, lo3[0] - 1.0),
                  lo3[1] + (hi3[1] - lo3[1]) * rng.random(n) * 0.2,
                  lo3[2] + (hi3[2] - lo3[2]) * rng.random(n) * 0.2], 1).astype(np.float32)
    d = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (n, 1))
    live = rng.random(n) < 0.9
    lim = np.full(n, 3.4e38, np.float32)
    (rayf, tlim), (os, dp, lv, tl) = _inputs(pt, o, d, live, lim)
    budget = mxu.pair_budget(os.x.shape[0], ct)
    dense = mxu.packet_bins(pt.tile_aabb, os, dp, lv, tl, budget, 0)
    assert not bool(dense.overflow)
    engaged = None
    for k in range(ct - 1, 0, -1):
        got = mxu.packet_bins(pt.tile_aabb, os, dp, lv, tl, budget, k)
        _assert_bins_equal(got, jm._packet_bins(jt.tile_aabb, rayf, tlim, budget, k))
        if bool(got.overflow):
            break
        engaged = got
    assert engaged is not None, "no K < Ct engaged without overflow"
    np.testing.assert_array_equal(engaged.src.numpy(), dense.src.numpy())
    np.testing.assert_array_equal(engaged.vt.numpy(), dense.vt.numpy())
