"""The larger-mesh slice as a whole: the port's ``Renderer(device="cpu")``
on ``scenes/cornell_mesh_20k.json`` (20,480 triangles, 20 tiles) against
the JAX package's ``Renderer``.

At 16x16, depth 3 (cut from the scene's 8 to keep the JAX compile short),
2 spp, seed 0, ``mesh_intersector="mxu"``, ``fused_bounce="on"``, both
scenes built by the NumPy BVH construction.  The port renders once per
traversal (``mxu_traversal`` auto = planned with the lane-best walk,
planned, streamed, binned; the plain versions of their kernels here): the
films must be bit-identical, since every traversal gives each ray the same
hit.  The JAX package renders with "auto", its planned walk in interpret
mode.  Tolerance against it: the goldens' ``rtol=2e-4, atol=2e-5``
(``tests/torch_compare.py``; the shade's cos/sin and XLA's ``rsqrt`` differ
in the last bits), and equal alive counts.
"""

import pathlib

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_2025_tpu.config import RenderConfig as JConfig
from project3_cuda_path_tracer_2025_tpu.models import Renderer as JRenderer
from project3_cuda_path_tracer_2025_tpu.scene import load_scene as j_load
from project3_cuda_path_tracer_2025_tpu.scene import set_resolution as j_set_res
from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer
from project3_cuda_path_tracer_2025_tpu_torch.scene import load_scene, set_resolution
from torch_compare import assert_films_close

REPO = pathlib.Path(__file__).resolve().parent.parent
MESH = str(REPO / "scenes" / "cornell_mesh_20k.json")
RES, DEPTH, SPP = 16, 3, 2
CONFIG = dict(mesh_intersector="mxu", fused_bounce="on")


@pytest.fixture(scope="module")
def port_films():
    scene = set_resolution(load_scene(MESH), RES, RES)
    scene.state.trace_depth = DEPTH
    out = {}
    for mode in ("auto", "planned", "streamed", "binned"):
        r = Renderer(scene, RenderConfig(mxu_traversal=mode, **CONFIG), seed=0, device="cpu")
        r.step_many(SPP)
        out[mode] = torch.stack(list(r.film), 1).numpy(), r._alive_counts
    return out


@pytest.mark.parametrize("mode", ["planned", "streamed", "binned"])
def test_traversals_give_bit_identical_films(port_films, mode):
    film, alive = port_films[mode]
    np.testing.assert_array_equal(film, port_films["auto"][0])
    np.testing.assert_array_equal(alive, port_films["auto"][1])


def test_renderer_matches_jax(port_films):
    scene = j_set_res(j_load(MESH, native_bvh=False), RES, RES)
    scene.state.trace_depth = DEPTH
    r = JRenderer(scene, JConfig(**CONFIG), seed=0)
    for _ in range(SPP):
        r.step()
    f = r._flat_film()
    jfilm = np.stack([np.asarray(f.x), np.asarray(f.y), np.asarray(f.z)], 1)
    film, alive = port_films["auto"]
    assert film.sum() > 0
    np.testing.assert_array_equal(alive, np.asarray(r._alive_counts))
    assert_films_close(film, jfilm)
