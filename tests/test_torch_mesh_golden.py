"""The port's cross-package goldens for the mesh slices.

Each ``tests/torch_goldens/<name>.npz`` is a 32x32, 2 spp, seed 0 film of
one mesh scene (its own depth 8) rendered by the JAX package on the CPU
with ``mesh_intersector="mxu"`` and ``fused_bounce="on"``, the scene built
by the NumPy BVH construction (``native_bvh=False``; the port renders
with it too, not with its default native build), so triangle ids are the
same on both sides:

* ``mesh5k.npz``: ``scenes/cornell_mesh_5k.json`` (5 tiles: the mono
  traversal);
* ``mesh20k.npz``: ``scenes/cornell_mesh_20k.json`` (20 tiles: the
  planned walk);
* ``mesh80k.npz``: ``scenes/cornell_mesh_80k.json`` (79 tiles: the
  streamed walk).

``chip_smoke.py`` holds the card's renders to them.

Here the JAX package regenerates each, so a file cannot go stale, and the
port's CPU render of the same configuration is held to it.  Tolerance: the
goldens' per-pixel ``rtol=2e-4, atol=2e-5`` (``tests/test_goldens.py``) on
every pixel and the film sums to 1e-4 (``tests/torch_compare.py``); the
regenerated JAX film must equal the file to the same bar.

To write the files anew (after a deliberate change of the JAX package's
mesh path), run ``python tests/test_torch_mesh_golden.py [name ...]``.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDENS = {
    "mesh5k": "cornell_mesh_5k.json",
    "mesh20k": "cornell_mesh_20k.json",
    "mesh80k": "cornell_mesh_80k.json",
}
RES, SPP = 32, 2
CONFIG = dict(mesh_intersector="mxu", fused_bounce="on")

sys.path[:0] = [str(REPO), str(REPO / "tests")]
from torch_compare import assert_films_close  # noqa: E402


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


@pytest.mark.parametrize("name", list(GOLDENS))
def test_golden_is_the_jax_render(name):
    g = np.load(golden_path(name))
    assert (int(g["width"]), int(g["height"]), int(g["spp"])) == (RES, RES, SPP)
    assert str(g["scene"]) == f"$REPO/scenes/{GOLDENS[name]}"
    assert_films_close(jax_film(name), g["film"])


@pytest.mark.parametrize("name", list(GOLDENS))
def test_port_cpu_render_matches_golden(name):
    from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer
    from project3_cuda_path_tracer_2025_tpu_torch.scene import load_scene, set_resolution

    g = np.load(golden_path(name))
    r = Renderer(set_resolution(load_scene(str(REPO / "scenes" / GOLDENS[name]),
                                        native_bvh=False), RES, RES),
                 RenderConfig(**CONFIG), seed=0, device="cpu")
    r.step_many(SPP)
    assert_films_close(torch.stack(list(r.film), 1).numpy(), g["film"])


if __name__ == "__main__":
    for name in sys.argv[1:] or list(GOLDENS):
        np.savez_compressed(
            golden_path(name), film=jax_film(name), width=RES, height=RES, spp=SPP,
            scene=f"$REPO/scenes/{GOLDENS[name]}",
            config=str(sorted(CONFIG.items())),
        )
        print(f"wrote {golden_path(name)}")
