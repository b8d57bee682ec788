"""Which traversal the port runs, against the JAX package's choice, and what
it refuses.

``resolve_traversal_mode`` and ``traversal_flags`` must give the JAX
package's answers at every padded mesh size (mono up to 8 tiles, planned up
to 32, binned in (128k, 320k], streamed beyond) and with the binned tiers
and budget anchor passed through.  The port refuses, naming its
``ROADMAP.md`` item: a mesh of more than 1,024 tiles (the chunked planned
chain), the sweep traversal (asked for, or reached by the planned walk's
plan-size guard), the planned walk beyond 32 tiles, and the two
environment switches of the JAX package that select unported kernels.
"""

import pathlib

import pytest
import torch

from project3_cuda_path_tracer_2025_tpu.ops import intersect_mxu as jm
from project3_cuda_path_tracer_2025_tpu_torch import cli
from project3_cuda_path_tracer_2025_tpu_torch.ops import intersect_mxu as mxu
from project3_cuda_path_tracer_2025_tpu_torch.utils.vec import Vec3
from test_torch_mesh_planned import traversal_case

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


def _run(tables, n, padded, **flags):
    z = torch.zeros(n)
    ro, rd = Vec3(z, z, z), Vec3(z, z, z + 1.0)
    return mxu.mesh_intersect_mxu(tables, padded, padded, ro, rd, torch.ones(n, dtype=torch.bool),
                                  torch.full((n,), 3.4e38), 1e-5, **flags)


@pytest.fixture(scope="module")
def tables():
    return traversal_case("random_2300")["pt"]


def test_refusals_name_their_roadmap_items(tables, monkeypatch):
    with pytest.raises(NotImplementedError, match="Queue 1 #2, larger meshes"):
        _run(tables, 8, 1025 * 1024, planned=True, streamed=True)
    with pytest.raises(NotImplementedError, match="Queue 2 #9"):
        _run(tables, 8, 3072)  # every flag off: the sweep
    with pytest.raises(NotImplementedError, match="Queue 2 #9"):
        # 2,734 blocks x 32 tiles x 8 > 700,000: the guard drops the plan
        _run(tables, 2735 * 256, 32 * 1024, planned=True)
    with pytest.raises(NotImplementedError, match="Queue 1 #2, larger meshes"):
        _run(tables, 8, 33 * 1024, planned=True)  # beyond the planned walk's table
    monkeypatch.setenv("PTT_STREAM_SUPER", "1")
    with pytest.raises(NotImplementedError, match="Queue 2 #8"):
        _run(tables, 8, 3072, planned=True, streamed=True)
    monkeypatch.setenv("PTT_STREAM_SUPER", "0")
    monkeypatch.setenv("PTT_PLAN_IMPL", "pallas")
    with pytest.raises(NotImplementedError, match="Queue 2 #11"):
        _run(tables, 8, 3072, planned=True)
    monkeypatch.setenv("PTT_PLAN_IMPL", "xla")
    assert _run(tables, 8, 3072, planned=True).tri.shape == (8,)


def test_cli_takes_the_traversal_flag(tmp_path):
    scene = str(REPO / "scenes" / "cornell_mesh_20k.json")
    with pytest.raises(NotImplementedError, match="Queue 2 #9"):
        cli.main([scene, "--mxu-traversal", "sweep", "--device", "cpu", "--quiet"])
    for mode in ("planned", "binned"):
        rc = cli.main([scene, "--res", "8", "8", "--spp", "1", "--depth", "2", "--device", "cpu",
                       "--mesh-intersector", "mxu", "--mxu-traversal", mode,
                       "--out", str(tmp_path / mode), "--quiet"])
        assert rc == 0
        assert any(p.suffix == ".png" for p in (tmp_path / mode).iterdir())
