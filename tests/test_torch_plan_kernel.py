"""The plan prepass (``_plan_prepass_kernel``, Pallas #11) of the port
against the JAX package's.

``plan_prepass`` gives, per (256-ray block, tile), whether any live ray
enters the tile's widened box before its t_limit (``h``) and the block's
least entry distance (``lb``); ``build_tile_plan_prepass`` sorts them into
the plan.  On the CPU the port runs ``plan_prepass_plain``; the JAX package
runs ``_build_tile_plan_pallas`` in interpret mode.  The populations are
those of ``tests/test_plan_pallas.py`` (4 blocks of random rays, 30% dead,
a sixteenth axis-aligned, random boxes) at its tile counts 3, 7 and 129.
The plan must equal the JAX kernel's and both packages' plans in plain
array code (``build_tile_plan`` / ``_build_tile_plan``), and a traversal
with ``plan_impl="pallas"`` (the JAX package's name for the switch, also
read from ``PTT_PLAN_IMPL``) must give the hits of the default plan.

Tolerance: none; ``ids``, ``tlo`` and ``cnt`` are equal arrays (float32
slab arithmetic in the same order, min and any over a block's rays).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_2025_tpu.ops import intersect_mxu as jm
from project3_cuda_path_tracer_2025_tpu_torch.ops import intersect_mxu as mxu
from project3_cuda_path_tracer_2025_tpu_torch.utils.vec import Vec3
from test_torch_mesh_plan import _assert_plans_equal
from test_torch_mesh_planned import assert_bit_equal, run_both, traversal_case
from tests.test_plan_pallas import _population


def _port_inputs(rayf, tlim, aabb):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return (t(aabb), Vec3(*(t(rayf[:, 6 + i]) for i in range(3))),
            Vec3(*(t(rayf[:, i]) for i in range(3))), t(rayf[:, 9] > 0), t(tlim[:, 0]))


@pytest.mark.parametrize("ct", [3, 7, 129])
def test_plan_prepass_matches_jax(ct):
    rng = np.random.default_rng(11 + ct)
    rayf, tlim, aabb = _population(rng, 4 * mxu.RAY_TILE, ct)
    args = _port_inputs(rayf, tlim, aabb)
    before = mxu.plan_prepass.launches
    got = mxu.build_tile_plan_prepass(*args)
    assert mxu.plan_prepass.launches == before  # CPU tensors: the plain version
    want = jm._build_tile_plan_pallas(jnp.asarray(aabb), jnp.asarray(rayf), jnp.asarray(tlim),
                                      interpret=True)
    _assert_plans_equal(got, want)
    _assert_plans_equal(got, jm._build_tile_plan(aabb, rayf[:, 6:9], rayf[:, 0:3], rayf[:, 9],
                                                 tlim[:, 0]))
    for a, b in zip(got, mxu.build_tile_plan(*args)):
        assert torch.equal(a, b)
    assert 0 < int(got.cnt.sum()) <= 4 * ct


@pytest.mark.parametrize("ct", [3, 129])
def test_plan_prepass_slabs(ct):
    """(h, lb) themselves: a tile no live ray of a block enters has h False
    and lb inf; every lb is the least clamped entry, so never negative."""
    rng = np.random.default_rng(30 + ct)
    rayf, tlim, aabb = _population(rng, 4 * mxu.RAY_TILE, ct, dead_frac=0.9)
    rayf[256:512] = 0.0  # a dead block
    h, lb = mxu.plan_prepass(*_port_inputs(rayf, tlim, aabb))
    assert h.shape == lb.shape == (4, ct) and h.dtype == torch.bool
    assert not h[1].any() and h.any()
    assert torch.isinf(lb[~h]).all() and (lb[h] >= 0).all() and torch.isfinite(lb[h]).all()


@pytest.mark.parametrize("flags", [dict(planned=True), dict(planned=True, streamed=True)],
                         ids=["planned", "streamed"])
def test_traversal_with_the_plan_kernel(flags, monkeypatch):
    c = traversal_case("random_2300")
    calls = []
    plain = mxu.plan_prepass_plain
    monkeypatch.setattr(mxu, "plan_prepass_plain", lambda *a: calls.append(1) or plain(*a))
    got, want = run_both(c, True, plan_impl="pallas", **flags)
    assert calls == [1]
    assert_bit_equal(got, want)
    num, padded, bounds = c["sizes"]
    monkeypatch.setenv("PTT_PLAN_IMPL", "pallas")  # the same switch, from the environment
    env = mxu.mesh_intersect_mxu(c["pt"], num, padded, *c["t"], 1e-5, sort_rays=True,
                                 mesh_bounds=bounds, **flags)
    assert calls == [1, 1]
    monkeypatch.setenv("PTT_PLAN_IMPL", "xla")
    ref = mxu.mesh_intersect_mxu(c["pt"], num, padded, *c["t"], 1e-5, sort_rays=True,
                                 mesh_bounds=bounds, **flags)
    assert calls == [1, 1]
    for r in (env, ref):
        assert torch.equal(got.tri, r.tri) and torch.equal(got.t, r.t)
