"""The port's bounce prefix tiers against the JAX package's.

* ``tier_sizes`` equals the JAX function on the cases of the JAX package's
  ``tests/test_fused.py::test_tier_sizes_unit`` and on a sweep of sizes.
* The port's tiered wavefront film (``cornell_dof.json`` at 24x24, depth 8,
  compaction on, tiers (4, 2): 576 rays, tiers of 256 and 512 rows, which
  engage from bounce 2) against the JAX package's tiered film of the same
  scene and seed: the goldens' film bars (``tests/torch_compare.py``) and
  equal alive counts.  The JAX side traces its bounce loop once
  (``unroll_bounces=False``, which the port ignores) to keep its compile
  short.
"""

import pathlib

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_2025_tpu.config import RenderConfig as JConfig
from project3_cuda_path_tracer_2025_tpu.models import Renderer as JRenderer
from project3_cuda_path_tracer_2025_tpu.ops.fused import tier_sizes as j_tier_sizes
from project3_cuda_path_tracer_2025_tpu.scene import load_scene as j_load
from project3_cuda_path_tracer_2025_tpu.scene import set_resolution as j_set_res
from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer, wavefront
from project3_cuda_path_tracer_2025_tpu_torch.ops.fused import tier_sizes
from project3_cuda_path_tracer_2025_tpu_torch.scene import load_scene, set_resolution
from torch_compare import assert_films_close

REPO = pathlib.Path(__file__).resolve().parent.parent
DOF = str(REPO / "scenes" / "cornell_dof.json")
RES, DEPTH, SPP = 24, 8, 2


@pytest.mark.parametrize("n,tiers,want", [
    (1024, (4, 2), [256, 512]),
    (1024, (2, 2, 4), [256, 512]),
    (1000, (2,), [512]),
    (256, (2,), []),
    (1024, (), []),
    (1024, (1,), []),
    (640000, (8, 4, 2), [80128, 160000, 320000]),
])
def test_tier_sizes_match_jax(n, tiers, want):
    assert tier_sizes(n, tiers) == j_tier_sizes(n, tiers) == want


def test_tier_sizes_match_jax_on_a_sweep():
    rng = np.random.default_rng(0)
    for n in [*range(250, 1300, 7), 320000, 640000, 160000]:
        tiers = tuple(int(t) for t in rng.integers(0, 17, rng.integers(0, 4)))
        assert tier_sizes(n, tiers) == j_tier_sizes(n, tiers), (n, tiers)


def test_tiered_wavefront_matches_jax(monkeypatch):
    cfg = dict(integrator="wavefront", stream_compaction=True, bounce_prefix_tiers=(4, 2))
    rows = []
    stage = wavefront.intersect_scene

    def spy(dev, static, head, c):
        rows.append(head.pixel.shape[0])
        return stage(dev, static, head, c)

    monkeypatch.setattr(wavefront, "intersect_scene", spy)
    scene = set_resolution(load_scene(DOF), RES, RES)
    scene.state.trace_depth = DEPTH
    r = Renderer(scene, RenderConfig(**cfg), seed=0, device="cpu")
    r.step_many(SPP)
    film = torch.stack(list(r.film), 1).numpy()
    assert {256, 512} <= set(rows)  # both tiers engaged

    jscene = j_set_res(j_load(DOF), RES, RES)
    jscene.state.trace_depth = DEPTH
    jr = JRenderer(jscene, JConfig(unroll_bounces=False, **cfg), seed=0)
    for _ in range(SPP):
        jr.step()
    f = jr._flat_film()
    jfilm = np.stack([np.asarray(f.x), np.asarray(f.y), np.asarray(f.z)], 1)
    np.testing.assert_array_equal(np.asarray(r._alive_counts), np.asarray(jr._alive_counts))
    assert film.sum() > 0
    assert_films_close(film, jfilm)
