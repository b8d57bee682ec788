"""The port's cross-package goldens for the textured stand-in scenes.

Each ``tests/torch_goldens/<name>.npz`` is a 32x32, 2 spp, seed 0 film of
one stand-in scene (its own depth 8) rendered by the JAX package on the CPU
with ``mesh_intersector="mxu"`` and ``fused_bounce="on"`` (its Pallas shade
kernel in interpret mode, modes "precomputed" and "textured"), the scene
built by the NumPy BVH construction (``native_bvh=False``; the port renders
with it too, not with its default native build), so triangle ids are the
same on both sides:

* ``prim_textured.npz``: ``scenes/cornell_prim_textured_local.json`` (a
  textured sphere beside a mesh: the textured-prim bounce, mode
  "precomputed", the packed single-quad gather);
* ``mesh_textured.npz``: ``scenes/cornell_mesh_textured_local.json`` (a
  textured, bump-mapped uv sphere whose bump map is its albedo file: the
  textured mesh bounce, mode "textured"; the loader gives the two maps two
  texture ids, so it takes the two-quad gather);
* ``mesh_textured_bump.npz``: ``scenes/cornell_mesh_textured_bump_local.json``
  (the same mesh with a distinct height map).

``chip_smoke.py`` holds the card's renders to them.  Here the JAX package
regenerates each, so a file cannot go stale, and the port's CPU render of the
same configuration is held to it.

Tolerance: the goldens' per-pixel ``rtol=2e-4, atol=2e-5``
(``tests/test_goldens.py``) on at least 99% of the pixels, every pixel
within ``rtol=1e-2``, and film sums to 1e-4.  Untextured films meet the
per-pixel bar everywhere (``tests/test_torch_mesh_golden.py``); here the
bilinear texel weights and the bump normal magnify the last-bit differences
of the winner's (u, v) (XLA contracts multiply-adds, torch does not) by the
texture's gradient in texel space, and a few pixels of the bump-mapped
sphere drift past 2e-4.  The regenerated JAX film must equal the file to the
goldens' bar on every pixel.

To write the files anew, run ``python tests/test_torch_tex_golden.py [name ...]``.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDENS = {
    "prim_textured": "cornell_prim_textured_local.json",
    "mesh_textured": "cornell_mesh_textured_local.json",
    "mesh_textured_bump": "cornell_mesh_textured_bump_local.json",
}
RES, SPP = 32, 2
CONFIG = dict(mesh_intersector="mxu", fused_bounce="on")
PIXEL_SHARE = 0.01
OUTLIER_RTOL = 1e-2

sys.path[:0] = [str(REPO), str(REPO / "tests")]
from torch_compare import FILM_ATOL, FILM_RTOL, FILM_SUM_RTOL, assert_films_close  # noqa: E402


def golden_path(name: str) -> pathlib.Path:
    return REPO / "tests" / "torch_goldens" / f"{name}.npz"


def jax_film(name: str) -> np.ndarray:
    from project3_cuda_path_tracer_2025_tpu.config import RenderConfig as JConfig
    from project3_cuda_path_tracer_2025_tpu.models import Renderer as JRenderer
    from project3_cuda_path_tracer_2025_tpu.scene import load_scene as j_load
    from project3_cuda_path_tracer_2025_tpu.scene import set_resolution as j_set_res

    scene = j_set_res(j_load(str(REPO / "scenes" / GOLDENS[name]), native_bvh=False), RES, RES)
    r = JRenderer(scene, JConfig(**CONFIG), seed=0)
    for _ in range(SPP):
        r.step()
    f = r._flat_film()
    return np.stack([np.asarray(f.x), np.asarray(f.y), np.asarray(f.z)], 1)


def assert_textured_films_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    outside = ~np.isclose(got, want, rtol=FILM_RTOL, atol=FILM_ATOL)
    assert outside.any(axis=1).mean() <= PIXEL_SHARE, outside.any(axis=1).sum()
    np.testing.assert_allclose(got, want, rtol=OUTLIER_RTOL, atol=FILM_ATOL)
    np.testing.assert_allclose(got.sum(), want.sum(), rtol=FILM_SUM_RTOL)


@pytest.mark.parametrize("name", list(GOLDENS))
def test_tex_golden_is_the_jax_render(name):
    g = np.load(golden_path(name))
    assert (int(g["width"]), int(g["height"]), int(g["spp"])) == (RES, RES, SPP)
    assert str(g["scene"]) == f"$REPO/scenes/{GOLDENS[name]}"
    assert_films_close(jax_film(name), g["film"])


@pytest.mark.parametrize("name", list(GOLDENS))
def test_port_cpu_tex_render_matches_golden(name):
    from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer
    from project3_cuda_path_tracer_2025_tpu_torch.scene import load_scene, set_resolution

    g = np.load(golden_path(name))
    r = Renderer(set_resolution(load_scene(str(REPO / "scenes" / GOLDENS[name]),
                                        native_bvh=False), RES, RES),
                 RenderConfig(**CONFIG), seed=0, device="cpu")
    assert r.static.num_textures > 0
    r.step_many(SPP)
    assert_textured_films_close(torch.stack(list(r.film), 1).numpy(), g["film"])


if __name__ == "__main__":
    for name in sys.argv[1:] or list(GOLDENS):
        np.savez_compressed(
            golden_path(name), film=jax_film(name), width=RES, height=RES, spp=SPP,
            scene=f"$REPO/scenes/{GOLDENS[name]}",
            config=str(sorted(CONFIG.items())),
        )
        print(f"wrote {golden_path(name)}")
