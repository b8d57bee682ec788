"""The planned walks (``_planned_kernel_lanebest`` #5 and ``_planned_kernel``
#6) of the port against the JAX package's.

``mesh_intersect_mxu(planned=True)`` on the CPU runs the port's plain
walk (``walk_plain``, what the kernels' wrappers run on CPU tensors) over
the port's tile plan; the JAX package runs its Pallas kernel in interpret
mode, ``planned_epilogue="lanebest_force"`` for #5 and ``"running"`` for #6.
Cases: a random 2,300-triangle mesh (3 tiles, the last part padding; 700
rays, 70% active, half of the t_limits finite) with the BVH's leaf order
carried across by ``from_jax_scene``, and a two-tile mesh whose tiles hold
the same triangle, with boxes that make the plan visit the higher tile
first (``torch_compare.tie_mesh``): every ray that hits it ties across
tiles, and the lower id must win.  Ray sorting off and on.

Tolerance: none.  ``t`` and ``tri`` are bit-equal: both sides evaluate
every candidate pair with the same float32 operations in the same order
(the numerators as fused multiply-add chains, ``fma32`` in the port), and
the winner rule (least t, then lowest id) does not depend on the order of
visits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_2025_tpu.ops.intersect_mxu import mesh_intersect_mxu as j_mxu
from project3_cuda_path_tracer_2025_tpu.scene import build_device_scene as j_build
from project3_cuda_path_tracer_2025_tpu.utils.vec import Vec3 as JVec3
from project3_cuda_path_tracer_2025_tpu_torch.ops import intersect_mxu as mxu
from project3_cuda_path_tracer_2025_tpu_torch.scene import from_jax_scene
from project3_cuda_path_tracer_2025_tpu_torch.utils.vec import Vec3
from tests.test_intersect import _random_mesh_scene
from torch_compare import TIE_TRIS, mesh_tables_pair, sphere_rays, tie_mesh

EPS = 1e-5


def traversal_case(name: str) -> dict:
    """A mesh and rays shared by the walk tests: the JAX and the port
    tables, (num_tris, padded_tris, bounds) and the rays on both sides."""
    if name == "tie":
        rng = np.random.default_rng(60)
        pos, o, d, lim = tie_mesh(rng, 900)
        jt, pt = mesh_tables_pair(pos)
        sizes = (2048, 2048, tuple(pos.reshape(-1, 3).min(0)) + tuple(pos.reshape(-1, 3).max(0)))
        active = rng.random(900) > 0.1
    else:
        n_tris = int(name.split("_")[1])
        rng = np.random.default_rng(50 + n_tris)
        jdev, js = j_build(_random_mesh_scene(rng, n_tris=n_tris))
        dev, _ = from_jax_scene(jax.tree_util.tree_map(np.asarray, jdev), js)
        jt, pt = jdev.mxu_mesh, dev.mxu_mesh
        sizes = (js.num_triangles, js.mxu_padded_tris, js.mesh_bounds)
        n = 700
        o, d = sphere_rays(rng, n)
        active = rng.random(n) > 0.3
        lim = np.where(rng.random(n) > 0.5, 3.4e38, 2.0).astype(np.float32)
    j3 = lambda a: JVec3(*[jnp.asarray(a[:, i]) for i in range(3)])
    t3 = lambda a: Vec3(*[torch.from_numpy(a[:, i].copy()) for i in range(3)])
    return dict(
        jt=jt, pt=pt, sizes=sizes,
        j=(j3(o), j3(d), jnp.asarray(active), jnp.asarray(lim)),
        t=(t3(o), t3(d), torch.from_numpy(active.copy()), torch.from_numpy(lim.copy())),
    )


def run_both(case, sort, **flags):
    num, padded, bounds = case["sizes"]
    want = j_mxu(case["jt"], num, padded, *case["j"], EPS, interpret=True, sort_rays=sort,
                 mesh_bounds=bounds, **flags)
    got = mxu.mesh_intersect_mxu(case["pt"], num, padded, *case["t"], EPS, sort_rays=sort,
                                 mesh_bounds=bounds, **flags)
    return got, want


def assert_bit_equal(got, want, min_hits=50):
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    np.testing.assert_array_equal(got.t.numpy(), np.asarray(want.t))
    assert (got.tri.numpy() >= 0).sum() >= min_hits


@pytest.fixture(scope="module", params=["random_2300", "tie"])
def case(request):
    return request.param, traversal_case(request.param)


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("epilogue", ["lanebest_force", "running"])
def test_planned_walk_matches_jax(case, epilogue, sort):
    name, c = case
    before = (mxu.planned_lanebest_intersect.launches, mxu.planned_intersect.launches)
    got, want = run_both(c, sort, planned=True, planned_epilogue=epilogue)
    assert_bit_equal(got, want)
    # CPU tensors: the wrappers ran their plain version, no kernel.
    assert (mxu.planned_lanebest_intersect.launches, mxu.planned_intersect.launches) == before
    if name == "tie":
        hit = got.tri.numpy() >= 0
        assert set(np.unique(got.tri.numpy()[hit])) == {TIE_TRIS[0]}


def test_tie_case_visits_the_higher_tile_first():
    """The plan of the tie mesh lists tile 1 before tile 0 for the blocks
    that hold hitting rays, so the tie rule is what picks id 5."""
    c = traversal_case("tie")
    ro, rd, active, lim = c["t"]
    tab = c["pt"]
    live = active & mxu.root_hit_mask(tab, ro, rd, lim)
    plan = mxu.build_tile_plan(tab.tile_aabb, *mxu.plan_rays(tab, ro, rd, live, lim))
    ids = plan.ids.reshape(-1, 2)
    assert (plan.cnt == 2).all() and (ids[:, 0] == 1).all()
