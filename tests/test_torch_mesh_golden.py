"""The port's cross-package golden for the mesh slice.

``tests/torch_goldens/mesh5k.npz`` is a 32x32, 2 spp, seed 0 film of
``scenes/cornell_mesh_5k.json`` (its own depth 8) rendered by the JAX
package on the CPU with ``mesh_intersector="mxu"`` and
``fused_bounce="on"``, the scene built by the NumPy BVH construction
(``native_bvh=False``, the one the port has), so triangle ids are the
same on both sides.  ``chip_smoke.py`` holds the card's render to it.

Here the JAX package regenerates it, so the file cannot go stale, and the
port's CPU render of the same configuration is held to it.  Tolerance: the
goldens' per-pixel ``rtol=2e-4, atol=2e-5`` (``tests/test_goldens.py``) on
every pixel and the film sums to 1e-4 (``tests/torch_compare.py``); the
regenerated JAX film must equal the file to the same bar.

To write the file anew (after a deliberate change of the JAX package's
mesh path), run ``python tests/test_torch_mesh_golden.py``.
"""

import pathlib
import sys

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "torch_goldens" / "mesh5k.npz"
SCENE = REPO / "scenes" / "cornell_mesh_5k.json"
RES, SPP = 32, 2
CONFIG = dict(mesh_intersector="mxu", fused_bounce="on")

sys.path[:0] = [str(REPO), str(REPO / "tests")]
from torch_compare import assert_films_close  # noqa: E402


def jax_film() -> np.ndarray:
    from project3_cuda_path_tracer_2025_tpu.config import RenderConfig as JConfig
    from project3_cuda_path_tracer_2025_tpu.models import Renderer as JRenderer
    from project3_cuda_path_tracer_2025_tpu.scene import load_scene as j_load
    from project3_cuda_path_tracer_2025_tpu.scene import set_resolution as j_set_res

    scene = j_set_res(j_load(str(SCENE), native_bvh=False), RES, RES)
    r = JRenderer(scene, JConfig(**CONFIG), seed=0)
    for _ in range(SPP):
        r.step()
    f = r._flat_film()
    return np.stack([np.asarray(f.x), np.asarray(f.y), np.asarray(f.z)], 1)


def test_golden_is_the_jax_render():
    g = np.load(GOLDEN)
    assert (int(g["width"]), int(g["height"]), int(g["spp"])) == (RES, RES, SPP)
    assert str(g["scene"]) == "$REPO/scenes/cornell_mesh_5k.json"
    assert_films_close(jax_film(), g["film"])


def test_port_cpu_render_matches_golden():
    from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer
    from project3_cuda_path_tracer_2025_tpu_torch.scene import load_scene, set_resolution

    g = np.load(GOLDEN)
    r = Renderer(set_resolution(load_scene(str(SCENE)), RES, RES),
                 RenderConfig(**CONFIG), seed=0, device="cpu")
    r.step_many(SPP)
    assert_films_close(torch.stack(list(r.film), 1).numpy(), g["film"])


if __name__ == "__main__":
    np.savez_compressed(
        GOLDEN, film=jax_film(), width=RES, height=RES, spp=SPP,
        scene="$REPO/scenes/cornell_mesh_5k.json",
        config=str(sorted(CONFIG.items())),
    )
    print(f"wrote {GOLDEN}")
