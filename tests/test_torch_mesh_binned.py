"""The packet-binned traversal (``_binned_kernel`` #10, with the streamed
walk as its fallback) of the port against the JAX package's.

``mesh_intersect_mxu(binned=True)`` on the CPU runs the port's bins, its
plain binned visits (``binned_intersect_plain``), the reduce and, where
the JAX package falls back, the plain streamed walk; the JAX package runs
its Pallas kernels in interpret mode.  The cases are those of the JAX
package's ``test_mxu_binned_matches_sweep_bitexact``
(``tests/test_intersect_mxu.py:382-433``): 1,100 rays on a random
300-triangle mesh with the binned tier engaged ((4,), 15% live, sorted),
the liveness fallback ((4,), 90% live), the multi-tier chain ((4, 2, 1) at
40% and 90% live, sorted and unsorted), and on a random 2,500-triangle
mesh (3 tiles) the top-K slot lists with K = 2 and the per-packet overflow
fallback with K = 1; and the two-tile tie mesh.  (The bins of an engaged
K < Ct are held to the JAX package's in ``test_torch_mesh_plan.py``.)

Tolerance: none; ``t`` and ``tri`` are bit-equal (see
``test_torch_mesh_planned.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_2025_tpu_torch.ops import intersect_mxu as mxu
from project3_cuda_path_tracer_2025_tpu_torch.utils.vec import Vec3
from test_torch_mesh_planned import assert_bit_equal, run_both, traversal_case
from torch_compare import TIE_TRIS, sphere_rays

from project3_cuda_path_tracer_2025_tpu.utils.vec import Vec3 as JVec3

N = 1100


def _with_rays(c, rng, live_frac):
    o, d = sphere_rays(rng, N)
    active = rng.random(N) < live_frac
    lim = np.where(rng.random(N) > 0.5, 3.4e38, 2.0).astype(np.float32)
    j3 = lambda a: JVec3(*[jnp.asarray(a[:, i]) for i in range(3)])
    t3 = lambda a: Vec3(*[torch.from_numpy(a[:, i].copy()) for i in range(3)])
    c = dict(c)
    c["j"] = (j3(o), j3(d), jnp.asarray(active), jnp.asarray(lim))
    c["t"] = (t3(o), t3(d), torch.from_numpy(active), torch.from_numpy(lim))
    return c


def _counts():
    return mxu.binned_intersect.launches, mxu.streamed_intersect.launches, mxu.packet_bins.launches


@pytest.fixture
def taken(monkeypatch):
    """Which plain traversals ran: "binned" and/or "walk"."""
    ran = []
    for name, tag in (("binned_intersect_plain", "binned"), ("walk_plain", "walk")):
        fn = getattr(mxu, name)
        monkeypatch.setattr(mxu, name, lambda *a, _f=fn, _t=tag: ran.append(_t) or _f(*a))
    return ran


@pytest.mark.parametrize("tiers,live_frac,sort,path", [
    ((4,), 0.15, True, "binned"),
    ((4,), 0.9, True, "walk"),  # live rays beyond the only tier
    ((4, 2, 1), 0.4, True, "binned"),
    ((4, 2, 1), 0.9, True, "binned"),
    ((4, 2, 1), 0.9, False, "binned"),
])
def test_binned_matches_jax(taken, tiers, live_frac, sort, path):
    rng = np.random.default_rng(int(live_frac * 100) + len(tiers) + sort)
    c = _with_rays(traversal_case("random_300"), rng, live_frac)
    before = _counts()
    got, want = run_both(c, sort, planned=True, streamed=True, binned=True, binned_tiers=tiers)
    assert_bit_equal(got, want, min_hits=20)
    assert taken == [path]
    assert _counts() == before  # CPU tensors: plain versions only


@pytest.mark.parametrize("k,path", [(2, None), (1, "walk")])
def test_binned_top_k_and_overflow_match_jax(taken, k, path):
    rng = np.random.default_rng(70 + k)
    c = _with_rays(traversal_case("random_2300"), rng, 0.9)
    got, want = run_both(c, True, planned=True, streamed=True, binned=True, binned_topk=k)
    assert_bit_equal(got, want, min_hits=20)
    if path is not None:  # K = 1 < the candidate tiles of some packet: overflow
        assert taken == [path]


def test_binned_tie_mesh_matches_jax():
    c = traversal_case("tie")
    got, want = run_both(c, True, planned=True, streamed=True, binned=True,
                         binned_tiers=(2, 1))
    assert_bit_equal(got, want)
    hit = got.tri.numpy() >= 0
    assert set(np.unique(got.tri.numpy()[hit])) == {TIE_TRIS[0]}


@pytest.mark.parametrize("k,path", [(128, "binned"), (2, "walk"), (1, "walk")])
def test_binned_overflow_counts_its_fallback(taken, k, path):
    """With one tier over every ray the bins are built on each call; with K
    = 1 or 2 some packet has more candidate tiles (of 3) than its slot list
    holds, the bins overflow and the streamed walk takes the rays, once
    counted by ``_binning.overflows``: the same (t, tri) as the streamed
    traversal."""
    rng = np.random.default_rng(90 + k)
    c = _with_rays(traversal_case("random_2300"), rng, 0.9)
    num, padded, bounds = c["sizes"]
    flags = dict(planned=True, streamed=True, sort_rays=True, mesh_bounds=bounds)
    overflows = mxu._binning.overflows
    got = mxu.mesh_intersect_mxu(c["pt"], num, padded, *c["t"], 1e-5, binned=True,
                                 binned_tiers=(1,), binned_topk=k, **flags)
    assert mxu._binning.overflows - overflows == (path == "walk")
    assert taken == [path]
    want = mxu.mesh_intersect_mxu(c["pt"], num, padded, *c["t"], 1e-5, **flags)
    assert torch.equal(got.tri, want.tri) and torch.equal(got.t, want.t)
    assert int((got.tri >= 0).sum()) >= 20
