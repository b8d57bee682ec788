"""The plain reference on the CPU: it imports nothing of JAX or of the
program, it agrees with the port's CPU path on both configurations and on
a mesh with vertex normals at a small size, its walk count is the brute
force's, and the control (the reference in bfloat16 in the program's
place) fails every cell's check."""

import ast
import json

import numpy as np
import pytest
import torch

import check
import control
from conftest import BENCH
from reference import mesh as ref_mesh
from reference import scene as ref_scene
from reference import tracer as ref_tracer
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


def _port_and_reference(scene_file: str, res: int, spp: int):
    """(the port's film, the reference's sums, the port's alive counts, the
    reference's tracer) of one spp batch of ``scenes/<scene_file>``."""
    from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer
    from project3_cuda_path_tracer_2025_tpu_torch.scene import set_resolution
    from project3_cuda_path_tracer_2025_tpu_torch.scene.loader import scene_from_dict

    cfg = {"scene": json.loads((ROOT / "scenes" / scene_file).read_text()),
           "dir": str(ROOT / "scenes")}
    r = Renderer(set_resolution(scene_from_dict(cfg["scene"], cfg["dir"]), res, res),
                 RenderConfig(), seed=1234, device="cpu")
    r.step_many(spp)
    scene = check.load_scene(cfg, (res, res))
    tracer = check.Tracer(scene, 1234)
    return r.image().reshape(-1, 3), r._alive_counts.tolist(), tracer


def _flat(mesh) -> np.ndarray:
    """[T, 3, 3] float32: each triangle's flat normal at its three corners."""
    v = mesh.vertices.astype(np.float64)
    n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    return np.repeat(n[:, None], 3, axis=1).astype(np.float32)


def _reference_film(tracer, spp):
    scene = tracer.scene
    pixels = np.arange(scene.pixel_count)
    return check.reference_sums(tracer, [scene.render_camera()], [(0, pixels, spp)])[0]


def _camera_mesh_hits(tracer, spp) -> int:
    """Camera rays of iteration ``spp`` whose nearest mesh hit is nearer
    than every box and sphere."""
    n = tracer.scene.pixel_count
    cam_key, _ = tracer._keys(torch.full((n,), spp))
    pix = torch.arange(n)
    u = [ref_tracer.uniforms(cam_key, j * n + pix) for j in range(4)]
    table = torch.tensor([ref_tracer._camera_row(tracer.scene.render_camera())] * n)
    o, d = tracer._camera_rays(table, pix, u)
    t_prims = torch.full((n,), torch.finfo(torch.float32).max)
    for p in tracer.scene.prims:
        t, _ = (ref_tracer._box if p.kind == ref_scene.CUBE else ref_tracer._sphere)(p, o, d)
        t_prims = torch.where((t > 0) & (t < t_prims), t, t_prims)
    t_mesh, _ = tracer.meshes[0].nearest(o, d, t_prims)
    return int((t_mesh < t_prims).sum())


def test_reference_reads_vertex_normals_as_the_port_does():
    """The open 5k box: ico4.obj's faces ``v//vn`` shaded by interpolated
    vertex normals, at the bar of the two configurations, with mesh pixels
    seen; its walk count's rays are the alive paths before each bounce."""
    film, alive, tracer = _port_and_reference("cornell_mesh_5k.json", 16, 2)
    mesh = tracer.scene.meshes[0]
    assert len(mesh.vertices) == 5120
    assert not np.allclose(mesh.vertex_normals, _flat(mesh))
    numbers = check.gaps(film, _reference_film(tracer, 2), "")
    assert numbers["max_gap"] <= 1e-6, numbers
    assert _camera_mesh_hits(tracer, 2) > 0
    _, ref_alive = tracer.radiance([tracer.scene.render_camera()], torch.arange(256),
                                   torch.full((256,), 2))
    assert ref_alive.tolist() == alive
    walk = tracer.walk_counts(tracer.scene.render_camera(), 2)
    assert [w[0] for w in walk] == [256] + alive[:-1]
    assert all(w[1] >= w[2] > 0 for w in walk[:2])


def test_reference_with_flat_normals_fails_the_bar():
    """A planted fault: the reference shading ico4.obj flat, as it did
    before it read vertex normals, is refused by the same comparison."""
    film, _, tracer = _port_and_reference("cornell_mesh_5k.json", 16, 2)
    tracer.meshes[0].normals = torch.as_tensor(_flat(tracer.scene.meshes[0]))
    numbers = check.gaps(film, _reference_film(tracer, 2), "")
    assert numbers["max_gap"] > 1e-2, numbers


def test_reference_refuses_texture_coordinates(tmp_path):
    obj = tmp_path / "uv.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\nf 1/1 2/1 3/1\n")
    with pytest.raises(NotImplementedError, match="vt"):
        ref_scene.load_obj(str(obj), np.eye(4), 0)
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nf 1 2 4 3\n")
    with pytest.raises(NotImplementedError, match="triangles"):
        ref_scene.load_obj(str(obj), np.eye(4), 0)


def test_walk_count_is_the_brute_force_count():
    """Every (ray, triangle) pair of a small random mesh whose triangle's own
    box the ray's segment enters, by the grouped count and by NumPy over
    every pair, in the same float32 slab arithmetic."""
    rng = np.random.default_rng(7)
    t = 300  # five groups, the last one padded
    centre = rng.uniform(-1, 1, (t, 1, 3))
    verts = (centre + rng.uniform(-0.15, 0.15, (t, 3, 3))).astype(np.float32)
    index = ref_mesh.MeshIndex(ref_scene.Mesh(verts, np.zeros_like(verts), 0), "cpu",
                               torch.float32)
    n = 2000
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_end = rng.uniform(0.5, 6, n).astype(np.float32)
    t_end[::3] = np.finfo(np.float32).max  # escaping rays
    cols = lambda a: tuple(torch.as_tensor(a[:, i].copy()) for i in range(3))
    entered = torch.zeros(t, dtype=torch.bool)
    pairs = index.walk_count(cols(o), cols(d), torch.as_tensor(t_end), entered)

    lo, hi = verts.min(axis=1), verts.max(axis=1)  # [T, 3]
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.float32(1.0) / d
        t1 = (lo[None] - o[:, None]) * inv[:, None]
        t2 = (hi[None] - o[:, None]) * inv[:, None]
    near = np.minimum(t1, t2).max(axis=2)
    far = np.maximum(t1, t2).min(axis=2)
    brute = (far >= near) & (far > 0) & (near <= t_end[:, None])  # [rays, T]
    assert 0 < pairs == int(brute.sum())
    assert entered.tolist() == brute.any(axis=0).tolist()


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
