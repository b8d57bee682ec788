"""The port's scene layer against the JAX package's.

The loader, OBJ loader and BVH construction are copies (the JAX package's scene
modules cannot be imported without JAX), so they must load every in-repo
scene to the same host arrays; ``build_device_scene`` must give the same
``SceneStatic``, ``GeomConst`` and ``MaterialConst`` values; and
``from_jax_scene`` must carry a JAX scene across unchanged.  A subprocess
with JAX made unimportable checks that the port never imports it.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_2025_tpu.scene import build_device_scene as j_build
from project3_cuda_path_tracer_2025_tpu.scene import load_scene as j_load
from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu_torch.scene import (
    build_device_scene, from_jax_scene, load_scene,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
PRIM_SCENES = [
    "cornell.json",  # the stand-in the bench and entry() read
    "cornell_dof.json",
    "cornell_transmissive_sphere.json",
    "cornell_all_lobes.json",
]
# The loader copy also loads meshes.  The textured scenes reference texture
# files that are not in the repo: both loaders must refuse them the same way.
LOAD_SCENES = PRIM_SCENES + [
    "cornell_mesh_5k.json",
    "cornell_mesh_5k_closed.json",
    "cornell_prim_textured.json",
    "cornell_mesh_textured.json",
]


def _load_both(name):
    path = str(REPO / "scenes" / name)
    try:
        want = j_load(path, native_bvh=False)
    except Exception as e:  # the port must fail the same way
        with pytest.raises(type(e)):
            load_scene(path, native_bvh=False)
        return None, None
    return want, load_scene(path, native_bvh=False)


@pytest.mark.parametrize("name", LOAD_SCENES)
def test_loader_matches_jax(name):
    want, got = _load_both(name)
    if want is None:
        return
    assert got.state.iterations == want.state.iterations
    assert got.state.trace_depth == want.state.trace_depth
    assert got.state.image_name == want.state.image_name
    for f in dataclasses.fields(want.state.camera):
        np.testing.assert_array_equal(
            getattr(got.state.camera, f.name), getattr(want.state.camera, f.name)
        )
    assert got.material_name_to_id == want.material_name_to_id
    assert len(got.materials) == len(want.materials)
    for a, b in zip(got.materials, want.materials):
        for f in dataclasses.fields(b):
            np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name))
    assert len(got.geoms) == len(want.geoms)
    for a, b in zip(got.geoms, want.geoms):
        assert int(a.type) == int(b.type) and a.material_id == b.material_id
        for f in ("translation", "rotation", "scale", "transform",
                  "inverse_transform", "inv_transpose"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for f in ("tri_positions", "tri_normals", "tri_uvs", "tri_material_ids",
              "tri_centroids", "tri_dpdu", "tri_dpdv"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    if want.bvh is None:
        assert got.bvh is None
    else:
        for f in dataclasses.fields(want.bvh):
            np.testing.assert_array_equal(getattr(got.bvh, f.name), getattr(want.bvh, f.name))


def _static_fields(static):
    return {f.name: getattr(static, f.name) for f in dataclasses.fields(static)}


@pytest.mark.parametrize("name", PRIM_SCENES)
def test_device_scene_matches_jax(name):
    path = str(REPO / "scenes" / name)
    jdev, jstatic = j_build(j_load(path))
    dev, static = build_device_scene(load_scene(path), "cpu")
    assert _static_fields(static) == _static_fields(jstatic)
    assert static.geoms == jstatic.geoms
    assert static.material_consts == jstatic.material_consts
    jm, m = jdev.materials, dev.materials
    for f in jm._fields:
        a, b = getattr(m, f), getattr(jm, f)
        if f == "color":
            for c in "xyz":
                np.testing.assert_array_equal(getattr(a, c).numpy(), np.asarray(getattr(b, c)))
        else:
            assert a.numpy().dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", PRIM_SCENES)
def test_from_jax_scene_round_trip(name):
    path = str(REPO / "scenes" / name)
    jdev, jstatic = j_build(j_load(path))
    dev_np = jax.tree_util.tree_map(np.asarray, jdev)
    dev_a, static_a = from_jax_scene(dev_np, jstatic)
    dev_b, static_b = build_device_scene(load_scene(path), "cpu")
    assert static_a == static_b
    assert _static_fields(static_a) == _static_fields(jstatic)
    flat_a = jax.tree_util.tree_leaves(dev_a.materials)
    flat_b = jax.tree_util.tree_leaves(dev_b.materials)
    assert len(flat_a) == len(flat_b) == 12
    for a, b in zip(flat_a, flat_b):
        assert torch.equal(a, b)


def test_port_imports_no_jax(tmp_path):
    """Import every module of the port with JAX unimportable, then render
    8x8 on the CPU through the CLI and through the kernels' plain paths, a
    prim scene and a mesh scene."""
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
import importlib, pkgutil
import project3_cuda_path_tracer_2025_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from project3_cuda_path_tracer_2025_tpu_torch import cli
from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer
from project3_cuda_path_tracer_2025_tpu_torch.scene import load_scene, set_resolution
r = Renderer(set_resolution(load_scene({str(REPO / 'scenes' / 'cornell_dof.json')!r}), 8, 8),
             RenderConfig(fused_bounce="on"), device="cpu")
r.step_many(2)
assert r.image().shape == (8, 8, 3) and r.image().sum() > 0
m = Renderer(set_resolution(load_scene({str(REPO / 'scenes' / 'cornell_mesh_5k.json')!r}), 8, 8),
             RenderConfig(fused_bounce="on", mesh_intersector="mxu"), device="cpu")
m.step()
assert m.image().sum() > 0
rc = cli.main([{str(REPO / 'scenes' / 'cornell_dof.json')!r}, "--res", "8", "8", "--spp", "2",
               "--device", "cpu", "--out", {str(tmp_path)!r}, "--quiet"])
assert rc == 0
assert not any(k == "jax" or k.startswith("jax.") for k, v in sys.modules.items() if v is not None)
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=str(tmp_path), timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")
    assert any(p.suffix == ".png" for p in tmp_path.iterdir())


@pytest.mark.parametrize(
    "kw,item",
    [
        # The wavefront integrator is ported (test_wavefront_config_dispatches),
        # and its prefix tiers (tests/test_torch_tiers.py).
        pytest.param(dict(integrator="wavefront", bounce_prefix_tiers=(4, 2)), None,
                     id="kw0-wavefront"),
        # Ported: multi-device and chunked rendering build (item None), and
        # their invalid values raise ValueError.
        pytest.param(dict(devices=2), None, id="kw1-parallel/"),
        pytest.param(dict(pixel_chunks=4), None, id="kw2-parallel/"),
        # Every traversal is ported ("sweep" too); of the mesh knobs only the
        # do-not-port ones still raise.
        pytest.param(dict(mxu_plan="frustum"), "do-not-port", id="kw3-meshes"),
        # The native BVH build is ported (tests/test_torch_native_bvh.py).
        pytest.param(dict(native_bvh=True), None, id="kw4-native/"),
    ],
)
def test_config_raises_for_unported_paths(kw, item):
    """Only the do-not-port list still raises; a ported path's config
    builds, and its invalid counts raise ValueError."""
    if item is None:
        cfg = RenderConfig(**kw)
        assert all(getattr(cfg, k) == v for k, v in kw.items())
        counts = {k: -v for k, v in kw.items() if type(v) is int}
        if counts:
            with pytest.raises(ValueError):
                RenderConfig(**counts)
        return
    with pytest.raises(NotImplementedError, match=item):
        RenderConfig(**kw)


def test_wavefront_config_dispatches(monkeypatch):
    """``integrator="wavefront"`` is ported: the config builds, and the
    Renderer steps through ``wavefront_iteration`` (not the megakernel, not
    the fused iteration kernel)."""
    from project3_cuda_path_tracer_2025_tpu_torch.models import renderer, wavefront
    from project3_cuda_path_tracer_2025_tpu_torch.scene import set_resolution

    cfg = RenderConfig(integrator="wavefront", fused_bounce="on")
    calls = []

    def spy(*args, **kw):
        calls.append(args[2].integrator)
        return wavefront.wavefront_iteration(*args, **kw)

    monkeypatch.setattr(renderer, "wavefront_iteration", spy)
    monkeypatch.setattr(renderer, "megakernel_iteration", None)
    r = renderer.Renderer(set_resolution(load_scene(str(REPO / "scenes" / "cornell_dof.json")),
                                         8, 8), cfg, device="cpu")
    assert not r._use_fused_iter
    r.step_many(2)
    assert calls == ["wavefront", "wavefront"]
    assert r.image().sum() > 0


def test_mesh_scene_raises_not_ported():
    """Meshes of every size are ported (the 20,480 triangles of
    cornell_mesh_20k.json build; one past the streamed plan's 1,024 tiles,
    which both packages walk with the chunked planned chain, has no gate
    left and pads to 1,025 tiles), and so is the native BVH builder that
    the JAX package's loader defaults to: nothing raises for a mesh scene,
    with either builder."""
    from project3_cuda_path_tracer_2025_tpu_torch.scene import device

    path = str(REPO / "scenes" / "cornell_mesh_20k.json")
    assert RenderConfig().native_bvh and RenderConfig(native_bvh=True).native_bvh
    for native in (True, False):
        scene = load_scene(path, native_bvh=native)
        _, static = build_device_scene(scene, "cpu")
        assert static.mxu_padded_tris == 20 * 1024
        assert sorted(scene.bvh.tri_indices.tolist()) == list(range(20 * 1024))
    assert not hasattr(device, "_check_slice")
    assert device._padded_tris(1024 * 1024 + 1) == 1025 * 1024
