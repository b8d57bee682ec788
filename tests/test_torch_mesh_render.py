"""The mesh slice as a whole: the port's ``Renderer(device="cpu")`` against
the JAX package's ``Renderer`` on ``scenes/cornell_mesh_5k.json``.

At 16x16, depth 3 (cut from the scene's 8 to keep the JAX compile short),
2 spp, seed 0, both with the scene built by the NumPy BVH construction, for
``RenderConfig(mesh_intersector="mxu", fused_bounce="on")`` (the fused mesh
bounce: the mono traversal's and the mesh shade's plain versions here, the
Pallas kernels in interpret mode there) and for the default configuration
(on the CPU: the threaded BVH walk and the unfused shade).  Images match
to ``atol=1e-4`` (the JAX package's own bar, ``tests/test_fused.py:59``)
and alive counts are equal.

Ray sorting is a permutation of the path state with pixel-keyed RNG and a
by-pixel film scatter, so in the port the images with sorting on and off
(and at any resort cadence, and through the unfused sorted intersector)
are bit-identical, as the JAX package requires of itself
(``tests/test_fused.py:63-91``).
"""

import pathlib

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_2025_tpu.config import RenderConfig as JConfig
from project3_cuda_path_tracer_2025_tpu.models import Renderer as JRenderer
from project3_cuda_path_tracer_2025_tpu.scene import load_scene as j_load
from project3_cuda_path_tracer_2025_tpu.scene import set_resolution as j_set_res
from project3_cuda_path_tracer_2025_tpu_torch import cli
from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer
from project3_cuda_path_tracer_2025_tpu_torch.ops import fused, intersect_mxu
from project3_cuda_path_tracer_2025_tpu_torch.scene import load_scene, set_resolution

REPO = pathlib.Path(__file__).resolve().parent.parent
MESH = str(REPO / "scenes" / "cornell_mesh_5k.json")
RES, DEPTH, SPP = 16, 3, 2
CONFIGS = {
    "fused_mxu": dict(mesh_intersector="mxu", fused_bounce="on"),
    "default": dict(),
}


def _port(**cfg):
    scene = set_resolution(load_scene(MESH, native_bvh=False), RES, RES)
    scene.state.trace_depth = DEPTH
    r = Renderer(scene, RenderConfig(**cfg), seed=0, device="cpu")
    r.step_many(SPP)
    return torch.stack(list(r.film), 1).numpy(), r._alive_counts


@pytest.fixture(scope="module", params=list(CONFIGS))
def jax_render(request):
    scene = j_set_res(j_load(MESH, native_bvh=False), RES, RES)
    scene.state.trace_depth = DEPTH
    r = JRenderer(scene, JConfig(**CONFIGS[request.param]), seed=0)
    for _ in range(SPP):
        r.step()
    f = r._flat_film()
    film = np.stack([np.asarray(f.x), np.asarray(f.y), np.asarray(f.z)], 1)
    return request.param, film, np.asarray(r._alive_counts)


def test_renderer_matches_jax(jax_render):
    name, jfilm, jalive = jax_render
    film, alive = _port(**CONFIGS[name])
    np.testing.assert_array_equal(alive, jalive)
    assert np.isfinite(film).all() and film.sum() > 0
    np.testing.assert_allclose(film, jfilm, atol=1e-4)


def test_sorted_and_unsorted_images_are_bit_identical():
    base, alive = _port(mesh_intersector="mxu", fused_bounce="on", ray_sorting="off")
    assert alive[0] > 0
    for kw in (
        dict(ray_sorting="on"),
        dict(ray_sorting="on", ray_sort_mode="morton"),
        dict(ray_sorting="on", ray_sort_every=2, ray_sort_first_bounce=False),
    ):
        film, _ = _port(mesh_intersector="mxu", fused_bounce="on", **kw)
        np.testing.assert_array_equal(film, base)
    # The unfused path's intersector sorts internally and scatters back.
    unfused_sorted, _ = _port(mesh_intersector="mxu", ray_sorting="on")
    unfused, _ = _port(mesh_intersector="mxu", ray_sorting="off")
    np.testing.assert_array_equal(unfused_sorted, unfused)


def test_fused_mesh_path_launches_no_kernel_on_the_cpu():
    """On CPU tensors the wrappers run their plain versions: no launch."""
    before = (intersect_mxu.mono_intersect.launches, fused.fused_mesh_shade.launches)
    _port(mesh_intersector="mxu", fused_bounce="on")
    assert (intersect_mxu.mono_intersect.launches, fused.fused_mesh_shade.launches) == before


@pytest.mark.parametrize("intersector", ["threaded", "brute", "mxu"])
def test_cli_renders_a_mesh_scene(tmp_path, intersector):
    rc = cli.main([MESH, "--res", "8", "8", "--spp", "1", "--depth", "2", "--device", "cpu",
                   "--mesh-intersector", intersector, "--out", str(tmp_path), "--quiet"])
    assert rc == 0
    assert any(p.suffix == ".png" for p in tmp_path.iterdir())
