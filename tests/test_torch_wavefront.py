"""The port's wavefront integrator against the JAX package's, and against
the port's own megakernel.

* ``wavefront_iteration`` against the JAX package's on ``cornell_dof.json``
  at 16x16 (both scenes built by their own package from the same JSON), for
  each compaction policy (on, adaptive, off) and with material sorting:
  films to the goldens' tolerance (``tests/torch_compare.py``), alive counts
  equal.
* The port's wavefront film bit-identical to the port's megakernel film
  with ``fused_bounce="off"`` (the JAX package's
  ``tests/test_integrators.py::test_wavefront_matches_megakernel_bitexact``):
  every ray's stream is keyed by its pixel and the film scatter-adds by
  pixel, so compaction and sorting change no bit.  Prim, mesh and textured
  mesh scenes, 16x16 (a multiple of the CPU's vector width, so every lane
  takes the same SIMD code path whatever the permutation), two spp through
  ``Renderer``.
* The compaction primitives against the JAX package's: the front-pack
  permutation and live count, the compacted state, the material sort of
  paths and intersections (permutations exact, values moved bit for bit).
* The CLI's ``--integrator``, ``--compaction``, ``--no-compaction`` and
  ``--material-sort`` build the configuration the JAX CLI builds.
"""

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_2025_tpu.config import RenderConfig as JConfig
from project3_cuda_path_tracer_2025_tpu.models.wavefront import wavefront_iteration as j_wave
from project3_cuda_path_tracer_2025_tpu.ops import compaction as jcomp
from project3_cuda_path_tracer_2025_tpu.ops.rays import Intersections as JIsect
from project3_cuda_path_tracer_2025_tpu.ops.rays import PathState as JPaths
from project3_cuda_path_tracer_2025_tpu.scene import build_device_scene as j_build
from project3_cuda_path_tracer_2025_tpu.scene import camera_state as j_camera_state
from project3_cuda_path_tracer_2025_tpu.scene import derive_render_camera as j_derive
from project3_cuda_path_tracer_2025_tpu.scene import load_scene as j_load
from project3_cuda_path_tracer_2025_tpu.scene import set_resolution as j_set_res
from project3_cuda_path_tracer_2025_tpu.utils.vec import Vec3 as JVec3
from project3_cuda_path_tracer_2025_tpu_torch import cli
from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer, wavefront_iteration
from project3_cuda_path_tracer_2025_tpu_torch.ops import compaction
from project3_cuda_path_tracer_2025_tpu_torch.ops import film as film_ops
from project3_cuda_path_tracer_2025_tpu_torch.ops.rays import Intersections, PathState
from project3_cuda_path_tracer_2025_tpu_torch.scene import (
    build_device_scene, camera_state, derive_render_camera, load_scene, set_resolution,
)
from project3_cuda_path_tracer_2025_tpu_torch.utils import prng
from project3_cuda_path_tracer_2025_tpu_torch.utils.vec import Vec3
from torch_compare import assert_films_close, pair, pair1

REPO = pathlib.Path(__file__).resolve().parent.parent
RES = 16
OPTIONS = {
    "compaction": dict(stream_compaction=True),
    "adaptive": dict(stream_compaction="adaptive"),
    "no-compaction": dict(stream_compaction=False),
    "compaction+sort": dict(stream_compaction=True, material_sorting=True),
}


@pytest.fixture(scope="module")
def dof():
    path = str(REPO / "scenes" / "cornell_dof.json")
    jscene = j_set_res(j_load(path), RES, RES)
    jdev, jstatic = j_build(jscene)
    scene = set_resolution(load_scene(path), RES, RES)
    dev, static = build_device_scene(scene, "cpu")
    return (dev, static, camera_state(derive_render_camera(scene.state.camera)),
            jdev, jstatic, j_camera_state(j_derive(jscene.state.camera)))


@pytest.mark.parametrize("option", list(OPTIONS))
def test_wavefront_matches_jax(dof, option):
    dev, static, cam, jdev, jstatic, jcam = dof
    n = static.pixel_count
    film, alive = wavefront_iteration(
        dev, static, RenderConfig(integrator="wavefront", **OPTIONS[option]), cam,
        film_ops.new_film(n), 1, prng.prng_key(0))
    jcfg = JConfig(integrator="wavefront", **OPTIONS[option])
    step = jax.jit(functools.partial(j_wave, jdev, jstatic, jcfg))
    jfilm, jalive = step(jcam, JVec3(*[jnp.zeros(n, jnp.float32)] * 3), jnp.int32(1),
                         jax.random.PRNGKey(0))
    np.testing.assert_array_equal(alive.numpy(), np.asarray(jalive))
    assert alive[-1] < alive[0]
    assert_films_close(torch.stack(list(film), 1).numpy(),
                       np.stack([np.asarray(c) for c in jfilm], 1))


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("name", ["cornell_dof.json", "cornell_mesh_5k.json",
                                  "cornell_mesh_textured_local.json"])
def test_wavefront_film_bit_identical_to_megakernel(name, option):
    scene = lambda: set_resolution(load_scene(str(REPO / "scenes" / name)), RES, RES)
    ref = Renderer(scene(), RenderConfig(fused_bounce="off"), device="cpu")
    ref.step_many(2)
    wf = Renderer(scene(), RenderConfig(integrator="wavefront", **OPTIONS[option]),
                  device="cpu")
    wf.step_many(2)
    for a, b in zip(wf.film, ref.film):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(wf._alive_counts, ref._alive_counts)
    assert wf.image().sum() > 0


def _state(rng, n):
    """A seeded path state and intersections with repeated material ids."""
    f = lambda k: pair(rng.normal(size=(3, n)).astype(np.float32))
    o, d, c = f(0), f(1), f(2)
    pixel = pair1(rng.permutation(n).astype(np.int32))
    bounces = pair1(np.where(rng.random(n) > 0.45, rng.integers(1, 8, n), 0).astype(np.int32))
    paths = PathState(o[0], d[0], c[0], pixel[0], bounces[0])
    jpaths = JPaths(o[1], d[1], c[1], pixel[1], bounces[1])
    t = pair1(rng.uniform(-1.0, 9.0, n).astype(np.float32))
    nrm, du, dv = f(3), f(4), f(5)
    mat = pair1(rng.integers(0, 6, n).astype(np.int32))
    uu, vv = pair1(rng.random(n).astype(np.float32)), pair1(rng.random(n).astype(np.float32))
    tri = pair1(rng.random(n) > 0.5)
    mk = lambda k, I: I(t=t[k], normal=nrm[k], material_id=mat[k], uv_u=uu[k], uv_v=vv[k],
                        dpdu=du[k], dpdv=dv[k], is_triangle=tri[k])
    return paths, jpaths, mk(0, Intersections), mk(1, JIsect)


def _eq(got, want):
    if isinstance(got, Vec3):
        for a, b in zip(got, want):
            _eq(a, b)
        return
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_compaction_primitives_match_jax():
    rng = np.random.default_rng(11)
    n = 3000
    paths, jpaths, isect, jisect = _state(rng, n)
    perm, live = compaction.front_pack_permutation(paths.alive)
    jperm, jlive = jcomp.front_pack_permutation(jpaths.alive)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    assert int(live) == int(jlive) == int(paths.alive.sum())
    packed, _ = compaction.compact_paths(paths)
    jpacked, _ = jcomp.compact_paths(jpaths)
    for a, b in zip(packed, jpacked):
        _eq(a, b)
    assert packed.alive[: int(live)].all() and not packed.alive[int(live):].any()
    sp, si = compaction.sort_paths_by_material(paths, isect)
    jsp, jsi = jcomp.sort_paths_by_material(jpaths, jisect, 6)
    for a, b in zip(sp, jsp):
        _eq(a, b)
    for a, b in zip(si, jsi):
        _eq(a, b)
    assert (np.diff(si.material_id.numpy()) >= 0).all()


@pytest.mark.parametrize("flags,want", [
    (["--integrator", "wavefront"], dict(integrator="wavefront", stream_compaction="adaptive",
                                         material_sorting=False)),
    (["--integrator", "wavefront", "--no-compaction", "--material-sort"],
     dict(integrator="wavefront", stream_compaction=False, material_sorting=True)),
    (["--integrator", "wavefront", "--compaction", "on"],
     dict(integrator="wavefront", stream_compaction=True, material_sorting=False)),
    ([], dict(integrator="megakernel", stream_compaction="adaptive", material_sorting=False)),
])
def test_cli_integrator_flags(tmp_path, monkeypatch, flags, want):
    from project3_cuda_path_tracer_2025_tpu_torch import models

    made = []

    class Spy(Renderer):
        def __init__(self, scene, cfg, **kw):
            made.append(cfg)
            super().__init__(scene, cfg, **kw)

    monkeypatch.setattr(models, "Renderer", Spy)
    rc = cli.main([str(REPO / "scenes" / "cornell_dof.json"), "--res", "8", "8", "--spp", "1",
                   "--device", "cpu", "--out", str(tmp_path), "--quiet", *flags])
    assert rc == 0 and any(p.suffix == ".png" for p in tmp_path.iterdir())
    assert {k: getattr(made[0], k) for k in want} == want
