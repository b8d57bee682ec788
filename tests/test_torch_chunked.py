"""The port's chunked step (``RenderConfig(pixel_chunks=C)``) on the CPU,
after the JAX package's ``tests/test_chunked.py``: C sequential ``shard=``
calls over pixel blocks, each writing into its slice of the film, give the
unchunked film bit for bit (step and ``step_many``); a chunk count that
does not divide the pixels raises; 0 (auto) resolves to 1; chunks never
compose with devices; and the film agrees with the JAX package's chunked
render at ``torch_compare.assert_films_close``.
"""

import pathlib

import numpy as np
import pytest

from project3_cuda_path_tracer_2025_tpu.config import RenderConfig as JConfig
from project3_cuda_path_tracer_2025_tpu.models import Renderer as JRenderer
from project3_cuda_path_tracer_2025_tpu.scene import load_scene as j_load
from project3_cuda_path_tracer_2025_tpu.scene import set_resolution as j_set_res
from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer
from project3_cuda_path_tracer_2025_tpu_torch.ops import fused
from project3_cuda_path_tracer_2025_tpu_torch.scene import load_scene, set_resolution
from torch_compare import assert_films_close

REPO = pathlib.Path(__file__).resolve().parent.parent
DOF = str(REPO / "scenes" / "cornell_dof.json")
MESH = str(REPO / "scenes" / "cornell_mesh_5k.json")


def _scene(path, res=16, depth=2):
    s = set_resolution(load_scene(path), res, res)
    s.state.trace_depth = depth
    return s


def _flat(r) -> np.ndarray:
    f = r._flat_film()
    return np.stack([np.asarray(f.x), np.asarray(f.y), np.asarray(f.z)], 1)


@pytest.mark.parametrize(
    "path,kw",
    [
        (MESH, dict(bvh_acceleration=False)),
        (DOF, dict(integrator="wavefront")),
        (MESH, dict(mesh_intersector="mxu", ray_sorting="on", fused_bounce="on")),
        (DOF, dict(fused_bounce="on")),
    ],
    ids=["brute", "wavefront", "fused-mesh-mxu", "prim-fused"],
)
def test_pixel_chunks_bitexact(path, kw):
    """Chunked == unchunked, bit for bit (the "prim-fused" case against the
    iteration kernel's plain version, which the unchunked step takes)."""
    s = _scene(path)
    a = Renderer(s, RenderConfig(**kw), device="cpu")
    b = Renderer(s, RenderConfig(pixel_chunks=4, **kw), device="cpu")
    assert b._pixel_chunks == 4
    a.step()
    b.step()
    np.testing.assert_array_equal(b.image(), a.image())
    np.testing.assert_array_equal(b._alive_counts, a._alive_counts)
    a.step_many(2)
    b.step_many(2)
    assert b.iteration == 3
    np.testing.assert_array_equal(b.image(), a.image())


def test_chunks_run_the_megakernel_not_the_iteration_kernel(monkeypatch):
    """Like the JAX package's chunked step, the chunks run
    ``megakernel_iteration`` under ``shard=``; the iteration kernel (#1)
    stays the unchunked prim step's."""
    calls = []
    monkeypatch.setattr(fused, "fused_prim_iteration",
                        lambda *a, **k: calls.append("iteration kernel"))
    r = Renderer(_scene(DOF), RenderConfig(pixel_chunks=8, fused_bounce="on"), device="cpu")
    r.step()
    assert not calls and r.iteration == 1 and np.isfinite(r.image()).all()


def test_pixel_chunks_must_divide():
    with pytest.raises(ValueError, match="divide"):
        Renderer(_scene(DOF, res=10), RenderConfig(pixel_chunks=3), device="cpu")


def test_pixel_chunks_resolution():
    """0 (auto) resolves to 1: the JAX package's auto rule works around a
    fault of its TPU backend and is not ported.  Explicit values pass
    through; chunks never compose with devices."""
    assert RenderConfig().resolved_pixel_chunks(800 * 800) == 1
    assert RenderConfig(bvh_acceleration=False).resolved_pixel_chunks(800 * 800) == 1
    assert RenderConfig(pixel_chunks=1).resolved_pixel_chunks(640000) == 1
    assert RenderConfig(pixel_chunks=4).resolved_pixel_chunks(640000) == 4
    with pytest.raises(ValueError):
        RenderConfig(pixel_chunks=-1)
    s = _scene(DOF)
    r = Renderer(s, RenderConfig(pixel_chunks=4, devices=2), device="cpu")
    assert r._pixel_chunks == 1 and len(r.film) == 2
    r.step()
    single = Renderer(s, RenderConfig(), device="cpu")
    single.step()
    np.testing.assert_array_equal(r.image(), single.image())


def test_pixel_chunks_match_jax_chunked():
    js = j_set_res(j_load(DOF), 16, 16)
    js.state.trace_depth = 3
    j = JRenderer(js, JConfig(pixel_chunks=4))
    j.step()
    j.step()
    r = Renderer(_scene(DOF, depth=3), RenderConfig(pixel_chunks=4), device="cpu")
    r.step()
    r.step()
    assert_films_close(_flat(r), _flat(j))
    np.testing.assert_array_equal(r._alive_counts, np.asarray(j._alive_counts))
