"""Which traversal the port runs, against the JAX package's choice, and what
it refuses.

``resolve_traversal_mode`` and ``traversal_flags`` must give the JAX
package's answers at every padded mesh size (mono up to 8 tiles, planned up
to 32, binned in (128k, 320k], streamed beyond) and with the binned tiers
and budget anchor passed through.  What the port refused while its last
traversals were missing now runs and matches the JAX package: a mesh of
more than 1,024 tiles (the chunked planned chain), the sweep traversal
(asked for, or reached by the planned walk's plan-size guard), the planned
walk beyond 32 tiles, and the two environment switches of the JAX package
(``PTT_STREAM_SUPER``, ``PTT_PLAN_IMPL=pallas``).  What it still refuses
(``mxu_plan="frustum"``, ``mesh_state_order="pixel"``, prefix tiers,
``native_bvh``, ``devices > 1``) is held in ``test_torch_mesh_tables.py``
and ``test_torch_scene.py``.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_2025_tpu.ops import intersect_mxu as jm
from project3_cuda_path_tracer_2025_tpu_torch import cli
from project3_cuda_path_tracer_2025_tpu_torch.ops import intersect_mxu as mxu
from project3_cuda_path_tracer_2025_tpu_torch.utils.vec import Vec3
from test_torch_mesh_planned import traversal_case
from torch_compare import never_hit_padded, run_tables_both

from project3_cuda_path_tracer_2025_tpu.utils.vec import Vec3 as JVec3

REPO = pathlib.Path(__file__).resolve().parent.parent
SIZES = [1024 * k for k in (1, 5, 8, 9, 20, 24, 25, 32, 33, 79, 125, 126, 128, 129, 196,
                            312, 313, 489, 1024, 1025)]


@pytest.mark.parametrize("padded", SIZES)
def test_auto_policy_matches_jax(padded):
    assert mxu.resolve_traversal_mode("auto", padded) == jm.resolve_traversal_mode("auto", padded)
    for mode in ("auto", "sweep", "planned", "streamed", "binned", "mono"):
        kw = dict(binned_tiers=(8, 4, 2), binned_budget_rays=640_000)
        assert mxu.traversal_flags(mode, padded, **kw) == jm.traversal_flags(mode, padded, **kw)
    with pytest.raises(ValueError):
        mxu.traversal_flags("bogus", padded)


@pytest.fixture(scope="module")
def case():
    return traversal_case("random_2300")


def _grown(c, tiles, n=None):
    """The case's 3 real tiles grown to ``tiles`` by empty tiles far away,
    and its 700 rays followed by dead ones up to ``n``."""
    jarrs, pt = never_hit_padded(c["jt"], tiles, far=True)
    (ro, rd, act, lim), (jro, jrd, jact, jlim) = c["t"], c["j"]
    if n is not None:
        k = n - act.shape[0]
        grow = lambda x, f: torch.cat([x, x.new_full((k,), f)])
        ro, rd = Vec3(*(grow(x, 0.0) for x in ro)), Vec3(*(grow(x, 1.0) for x in rd))
        act, lim = grow(act, False), grow(lim, 3.4e38)
        jgrow = lambda x, f: jnp.concatenate([x, jnp.full((k,), f, x.dtype)])
        jro, jrd = JVec3(*(jgrow(x, 0.0) for x in jro)), JVec3(*(jgrow(x, 1.0) for x in jrd))
        jact, jlim = jgrow(jact, False), jgrow(jlim, 3.4e38)
    return jarrs, pt, (jro, jrd, jact, jlim), (ro, rd, act, lim)


# What the port refused until its last traversals were ported, one case
# each: (tiles of the table, rays, flags, environment, the plain version the
# port must now reach, how often).
FORMER_REFUSALS = {
    "beyond_1024_tiles": (1025, None, dict(planned=True, streamed=True), {}, "walk_plain", 33),
    "every_flag_off_is_the_sweep": (3, None, {}, {}, "sweep_intersect_plain", 1),
    # 2,735 blocks x 32 tiles x 8 > 700,000: the guard drops the plan
    "plan_guard_turns_planned_into_the_sweep":
        (32, 2735 * 256, dict(planned=True), {}, "sweep_intersect_plain", 1),
    "planned_beyond_32_tiles": (33, None, dict(planned=True), {}, "walk_plain", 2),
    "stream_super_switch": (3, None, dict(planned=True, streamed=True),
                            {"PTT_STREAM_SUPER": "1"}, "streamed_super_plain", 1),
    "plan_impl_switch": (3, None, dict(planned=True), {"PTT_PLAN_IMPL": "pallas"},
                         "plan_prepass_plain", 1),
}


@pytest.mark.parametrize("name", list(FORMER_REFUSALS))
def test_refusals_name_their_roadmap_items(case, monkeypatch, name):
    """Each call the port used to refuse now runs, through the traversal the
    JAX package takes for it, and gives the JAX package's (t, tri) bit for
    bit (its kernels in interpret mode)."""
    tiles, n, flags, env, reached, times = FORMER_REFUSALS[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jarrs, pt, rays_j, rays_t = _grown(case, tiles, n)
    calls = []
    plain = getattr(mxu, reached)
    monkeypatch.setattr(mxu, reached, lambda *a, **k: calls.append(1) or plain(*a, **k))
    num = case["sizes"][0]
    got, want = run_tables_both(jarrs, pt, num, tiles * 1024, rays_j, rays_t, **flags)
    assert len(calls) == times
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert (got[1] >= 0).sum() >= 50


def test_cli_takes_the_traversal_flag(tmp_path):
    scene = str(REPO / "scenes" / "cornell_mesh_20k.json")
    for mode in ("sweep", "planned", "binned"):
        rc = cli.main([scene, "--res", "8", "8", "--spp", "1", "--depth", "2", "--device", "cpu",
                       "--mesh-intersector", "mxu", "--mxu-traversal", mode,
                       "--out", str(tmp_path / mode), "--quiet"])
        assert rc == 0
        assert any(p.suffix == ".png" for p in (tmp_path / mode).iterdir())
