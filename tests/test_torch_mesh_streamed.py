"""The streamed walk (``_streamed_kernel`` #7) of the port against the JAX
package's.

``mesh_intersect_mxu(planned=True, streamed=True)`` on the CPU runs the
port's plain walk over its global tile plan; the JAX package runs its
Pallas kernel in interpret mode.  Cases: random meshes of 300 and 2,300
triangles (1 and 3 tiles), the two-tile tie mesh (``torch_compare.tie_mesh``),
and 2,304 rays (9 blocks) with 15% of them active, so that after the sort
the plan is built over the 1/4 live prefix; ray sorting off and on.

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


@pytest.fixture(scope="module", params=["random_300", "random_2300", "tie"])
def case(request):
    return request.param, traversal_case(request.param)


@pytest.mark.parametrize("sort", [False, True])
def test_streamed_walk_matches_jax(case, sort):
    name, c = case
    before = mxu.streamed_intersect.launches
    got, want = run_both(c, sort, planned=True, streamed=True)
    assert_bit_equal(got, want)
    assert mxu.streamed_intersect.launches == before
    if name == "tie":
        hit = got.tri.numpy() >= 0
        assert set(np.unique(got.tri.numpy()[hit])) == {TIE_TRIS[0]}


@pytest.mark.parametrize("sort", [False, True])
def test_streamed_walk_over_a_live_prefix(sort):
    """Nine blocks with few live rays: sorted, the plan covers the 1/4
    prefix and the blocks behind it walk nothing; unsorted, the full plan."""
    c = traversal_case("random_2300")
    rng = np.random.default_rng(9)
    n = 2304
    o, d = sphere_rays(rng, n)
    active = rng.random(n) < 0.15
    lim = np.where(rng.random(n) > 0.5, 3.4e38, 2.0).astype(np.float32)
    j3 = lambda a: JVec3(*[jnp.asarray(a[:, i]) for i in range(3)])
    t3 = lambda a: Vec3(*[torch.from_numpy(a[:, i].copy()) for i in range(3)])
    c["j"] = (j3(o), j3(d), jnp.asarray(active), jnp.asarray(lim))
    c["t"] = (t3(o), t3(d), torch.from_numpy(active), torch.from_numpy(lim))
    got, want = run_both(c, sort, planned=True, streamed=True)
    assert_bit_equal(got, want, min_hits=20)
