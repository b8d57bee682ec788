"""The plain reference on the CPU: it imports nothing of JAX or of the
program, it agrees with the port's CPU path on both configurations at a
small size, and the control (the reference in bfloat16 in the program's
place) fails every cell's check."""

import ast
import json

import numpy as np
import pytest
import torch

import check
import control
from conftest import BENCH
from spec import Spec

ROOT = BENCH.parent
BANNED = ("jax", "jaxlib", "flax", "project3_cuda_path_tracer_2025_tpu",
          "project3_cuda_path_tracer_2025_tpu_torch")


def test_reference_imports_neither_jax_nor_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in BANNED, f"{path.name} imports {name}"


@pytest.mark.parametrize("config,res,spp", [("cornell", 12, 6), ("cornell_mesh_200k", 8, 2)])
def test_reference_agrees_with_the_port_on_the_cpu(config, res, spp):
    from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer
    from project3_cuda_path_tracer_2025_tpu_torch.scene import set_resolution
    from project3_cuda_path_tracer_2025_tpu_torch.scene.loader import scene_from_dict

    cfg = Spec.load().config(config)
    r = Renderer(set_resolution(scene_from_dict(cfg["scene"], cfg["dir"]), res, res),
                 RenderConfig(), seed=1234, device="cpu")
    r.step_many(spp)
    film = r.image().reshape(-1, 3)
    scene = check.load_scene(cfg, (res, res))
    tracer = check.Tracer(scene, 1234)
    pixels = np.arange(res * res)
    ref = check.reference_sums(tracer, [scene.render_camera()], [(0, pixels, spp)])[0]
    numbers = check.gaps(film, ref, "")
    assert numbers["max_gap"] <= 1e-6, numbers
    assert film.sum() > 0
    _, alive = tracer.radiance([scene.render_camera()], torch.arange(res * res),
                               torch.full((res * res,), spp))
    assert alive.tolist() == r._alive_counts.tolist()


@pytest.mark.parametrize("cell,steps", [
    ("cornell.progressive", 3), ("cornell_mesh_200k.progressive", 3), ("cornell.orbit", 150)])
def test_control_fails_the_check(cell, steps):
    spec = Spec.load()
    limits = spec.limits(cell)
    for seed in (11, 12, 13):
        low = control.control_numbers(spec, spec.cell(cell), seed, steps, "cpu",
                                      torch.bfloat16, res=(16, 16))
        correct, _ = check.decide(low, limits)
        assert not correct, (seed, low)
        same = control.control_numbers(spec, spec.cell(cell), seed, steps, "cpu",
                                       torch.float32, res=(16, 16))
        assert all(v == 0.0 for v in same.values()), same


def test_configuration_files_name_their_scene():
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    for entry in doc["configs"]:
        cfg = json.loads((ROOT / entry["file"]).read_text())
        assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
        assert cfg["reduced"] == entry["reduced"] == []
        assert cfg["scene"] == json.loads((ROOT / cfg["scene_from"]).read_text())
