"""The sweep (``_intersect_kernel``, Pallas #9) of the port against the JAX
package's.

``mesh_intersect_mxu`` with every traversal flag off is the sweep in both
packages: each tile of the table in ascending id, no plan.  On the CPU the
port runs ``sweep_intersect_plain`` (what the wrapper runs on CPU tensors);
the JAX package runs its Pallas kernel in interpret mode.  Cases: random
meshes of 300 and 2,300 triangles (1 and 3 tiles) and the two-tile tie mesh
(``torch_compare.tie_mesh``), ray sorting off and on; 700 rays of which the
second block of 256 is entirely dead and a third of the t_limits stop
short of the mesh (0.5) or inside it (2.0).  The sweep is the oracle the
JAX package holds its other traversals to, so inside the port the sweep,
the planned, the streamed and the binned traversals must agree on the same
fixtures, and a render with ``mxu_traversal="sweep"`` must give the "auto"
film.

Tolerance: none; ``t`` and ``tri`` are bit-equal (see
``test_torch_mesh_planned.py``), films are bit-identical.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_2025_tpu_torch import cli
from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer
from project3_cuda_path_tracer_2025_tpu_torch.ops import intersect_mxu as mxu
from project3_cuda_path_tracer_2025_tpu_torch.scene import load_scene, set_resolution
from project3_cuda_path_tracer_2025_tpu_torch.utils.vec import Vec3
from test_torch_mesh_planned import assert_bit_equal, run_both, traversal_case
from torch_compare import TIE_TRIS, sphere_rays

from project3_cuda_path_tracer_2025_tpu.utils.vec import Vec3 as JVec3

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", params=["random_300", "random_2300", "tie"])
def case(request):
    return request.param, traversal_case(request.param)


@pytest.mark.parametrize("sort", [False, True])
def test_sweep_matches_jax(case, sort):
    name, c = case
    before = mxu.sweep_intersect.launches
    got, want = run_both(c, sort)  # every flag off: the sweep
    assert_bit_equal(got, want)
    assert mxu.sweep_intersect.launches == before  # CPU tensors: the plain version
    if name == "tie":
        hit = got.tri.numpy() >= 0
        assert set(np.unique(got.tri.numpy()[hit])) == {TIE_TRIS[0]}


@pytest.mark.parametrize("sort", [False, True])
def test_sweep_dead_block_and_short_limits(sort):
    """The second block of 256 rays is dead (the JAX kernel's block_live
    skip), and the t_limits are 0.5 (short of the mesh), 2.0 (inside it) or
    none."""
    c = traversal_case("random_2300")
    rng = np.random.default_rng(19)
    n = 700
    o, d = sphere_rays(rng, n)
    active = rng.random(n) > 0.2
    active[256:512] = False
    lim = rng.choice(np.asarray([0.5, 2.0, 3.4e38], np.float32), n)
    j3 = lambda a: JVec3(*[jnp.asarray(a[:, i]) for i in range(3)])
    t3 = lambda a: Vec3(*[torch.from_numpy(a[:, i].copy()) for i in range(3)])
    c["j"] = (j3(o), j3(d), jnp.asarray(active), jnp.asarray(lim))
    c["t"] = (t3(o), t3(d), torch.from_numpy(active), torch.from_numpy(lim))
    got, want = run_both(c, sort)
    assert_bit_equal(got, want, min_hits=50)
    assert (got.tri.numpy()[256:512] == -1).all()
    assert (got.tri.numpy()[lim == 0.5] == -1).all()


@pytest.mark.parametrize("flags", [dict(planned=True), dict(planned=True, streamed=True),
                                   dict(planned=True, streamed=True, binned=True),
                                   dict(planned=True, planned_epilogue="running")],
                         ids=["planned", "streamed", "binned", "planned_exit"])
def test_traversals_match_the_sweep(case, flags):
    """The port's other traversals against its sweep, bit for bit (the JAX
    package's "matches_sweep_bitexact" tests)."""
    _, c = case
    num, padded, bounds = c["sizes"]
    run = lambda **kw: mxu.mesh_intersect_mxu(c["pt"], num, padded, *c["t"], 1e-5, sort_rays=True,
                                              mesh_bounds=bounds, **kw)
    sweep, other = run(), run(**flags)
    assert torch.equal(sweep.tri, other.tri)
    assert torch.equal(sweep.t, other.t)
    assert torch.equal(sweep.u, other.u) and torch.equal(sweep.v, other.v)
    assert (sweep.tri >= 0).sum() >= 50


def _film(scene, mode):
    r = Renderer(scene, RenderConfig(mxu_traversal=mode, mesh_intersector="mxu",
                                     fused_bounce="on"), seed=0, device="cpu")
    r.step_many(1)
    return torch.stack(list(r.film), 1).numpy(), r._alive_counts


def test_sweep_render_is_bit_identical_to_auto():
    """8x8, depth 3, 1 spp of cornell_mesh_20k.json (20 tiles: one sweep
    call a bounce) with "sweep" and with "auto" (the lane-best planned
    walk)."""
    scene = set_resolution(load_scene(str(REPO / "scenes" / "cornell_mesh_20k.json")), 8, 8)
    scene.state.trace_depth = 3
    (film_s, alive_s), (film_a, alive_a) = _film(scene, "sweep"), _film(scene, "auto")
    assert film_s.sum() > 0
    np.testing.assert_array_equal(film_s, film_a)
    np.testing.assert_array_equal(alive_s, alive_a)


def test_cli_takes_the_sweep(tmp_path):
    scene = str(REPO / "scenes" / "cornell_mesh_20k.json")
    out = {}
    for mode in ("sweep", "planned"):
        rc = cli.main([scene, "--res", "8", "8", "--spp", "1", "--depth", "2", "--device", "cpu",
                       "--mesh-intersector", "mxu", "--mxu-traversal", mode,
                       "--out", str(tmp_path / mode), "--quiet"])
        assert rc == 0
        out[mode] = next(p for p in (tmp_path / mode).iterdir() if p.suffix == ".png")
    assert out["sweep"].read_bytes() == out["planned"].read_bytes()
