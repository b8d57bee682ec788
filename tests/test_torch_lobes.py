"""The iteration kernel's lobes on the CPU against the benchmark's plain
reference (``benchmark/reference``: the reference tracer's ``scatterRay``
written anew in plain torch, which the benchmark's output check runs on the
card).

Two sides of the port: the host twin of kernel #1's body
(``tests/prim_path_host.cpp::ptt_host_iteration_regen``, the regenerating
schedule that ``csrc/fused_prim.cu`` runs with warp votes, here with its
counting variant's lobe tally) and the port's plain path
(``fused_prim_iteration`` on CPU tensors).  Each renders a sphere of each
non-diffuse lobe in the Cornell box, and ``scenes/cornell_all_lobes.json``,
at RES x RES for SPP spp under one seed; each iteration's alive counts and
lobe tally are held to the reference's (``Tracer.lobe_counts``) bit for
bit, and the film to the bar below.  A planted fault in the glass lobe
fails the same comparison.
"""

import ctypes
import json
import pathlib

import numpy as np
import pytest
import torch

from benchmark.reference import scene as ref_scene
from benchmark.reference import tracer as ref_tracer
from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu_torch.ops import bsdf, fused
from project3_cuda_path_tracer_2025_tpu_torch.ops import film as film_ops
from project3_cuda_path_tracer_2025_tpu_torch.ops import shade as shade_ops
from project3_cuda_path_tracer_2025_tpu_torch.scene import (
    build_device_scene, camera_state, derive_render_camera, scene_from_dict, set_resolution,
)
from project3_cuda_path_tracer_2025_tpu_torch.utils import prng
from torch_compare import build_host

REPO = pathlib.Path(__file__).resolve().parent.parent
SCENES = REPO / "scenes"
HARNESS = REPO / "tests" / "prim_path_host.cpp"
RES, SPP, SEED = 16, 3, 1_234_567_891
CASES = ("glass", "mirror", "transmissive", "microfacet", None)  # None: all the lobes

# The film's bar, on the benchmark check's gap (a pixel's sum over channels
# of |port - reference| over the reference's sum): the mean gap and the
# share of pixels off by more than OFF.  The plain path runs the reference's
# float32 operations in its order, torch's on both sides, and agrees bit for
# bit.  The host twin takes cos and sin from libm, an ulp or so from torch's:
# on these cases that leaves 239-247 of 256 pixels bit-equal and one pixel
# off by ~3e-4 (the Cook-Torrance lobe's sampled half vector), and such a
# last bit could fork a specular path (a refraction or a Fresnel choice taken
# the other way), which moves its pixel by up to about its whole value.  The
# bar holds one pixel off or one forked path: a share of 1/256 and a mean of
# 1/256.  The alive counts and the lobe tallies are compared exactly: on
# these cases no path forks.
OFF = 1e-4
BAR = {"mean_gap": 1.0 / (RES * RES), "share_off": 1.0 / (RES * RES)}


def _doc(lobe: str = None) -> dict:
    """``scenes/cornell_all_lobes.json``, or with ``lobe`` the box and that
    lobe's sphere alone, with the materials the objects use."""
    doc = json.loads((SCENES / "cornell_all_lobes.json").read_text())
    if lobe is not None:
        doc["Objects"] = [o for o in doc["Objects"]
                          if o["TYPE"] == "cube" or o["MATERIAL"] == lobe]
        used = {o["MATERIAL"] for o in doc["Objects"]}
        doc["Materials"] = {k: v for k, v in doc["Materials"].items() if k in used}
    return doc


def _reference(doc: dict) -> tuple:
    """The reference's film [P, 3] over iterations 1..SPP (added in order in
    float32, as a film accumulates), and each iteration's alive counts and
    lobe tally [depth, len(LOBES)]."""
    scene = ref_scene.load(doc, str(SCENES), (RES, RES))
    tracer = ref_tracer.Tracer(scene, SEED)
    cam, n = scene.render_camera(), scene.pixel_count
    film = np.zeros((n, 3), np.float32)
    alive, tally = [], []
    for it in range(1, SPP + 1):
        rgb, a = tracer.radiance([cam], torch.arange(n), torch.full((n,), it))
        film += rgb.numpy()
        alive.append(a.numpy())
        counts = tracer.lobe_counts(cam, it)
        tally.append(np.stack([counts[name] for name in ref_scene.LOBES], axis=1))
    return film, alive, tally


def _static(doc: dict) -> tuple:
    scene = set_resolution(scene_from_dict(doc, str(SCENES)), RES, RES)
    _, static = build_device_scene(scene, "cpu")
    return static, camera_state(derive_render_camera(scene.state.camera))


def _plain(doc: dict) -> tuple:
    """The port's plain path: film, alive counts and lobe tallies as
    ``_reference``'s."""
    static, cam = _static(doc)
    film = film_ops.new_film(static.pixel_count)
    alive, tally = [], []
    for it in range(1, SPP + 1):
        lobes = torch.zeros((static.trace_depth, len(shade_ops.LOBES)), dtype=torch.int32)
        film, a = fused.fused_prim_iteration(static, RenderConfig(), cam, film, it,
                                             prng.prng_key(SEED), lobe_counts=lobes)
        alive.append(a.numpy())
        tally.append(lobes.numpy())
    return torch.stack(list(film), 1).numpy(), alive, tally


def _host_twin(lib, doc: dict) -> tuple:
    """Kernel #1's body on the host, four warps of 32 lanes, counting the
    lobes: film, alive counts and lobe tallies as ``_reference``'s."""
    static, cam = _static(doc)
    n, depth = static.pixel_count, static.trace_depth
    film = film_ops.new_film(n)
    alive, tally = [], []
    for it in range(1, SPP + 1):
        cam_key, iter_key = fused.kernel_key_words(it, prng.prng_key(SEED))
        keys = np.asarray([*cam_key, *iter_key], np.uint32)
        a = np.zeros(depth, np.int32)
        lobes = np.zeros((depth, len(shade_ops.LOBES)), np.int32)
        lib.ptt_host_iteration_regen(
            ctypes.byref(fused.scene_struct(static, RenderConfig())),
            ctypes.byref(fused.camera_struct(cam)), static.width, static.height, n, depth,
            keys.ctypes.data, *(c.data_ptr() for c in film), a.ctypes.data,
            4, 1, np.zeros(2, np.int64).ctypes.data, lobes.ctypes.data)
        alive.append(a)
        tally.append(lobes)
    return torch.stack(list(film), 1).numpy(), alive, tally


def _gaps(film: np.ndarray, ref: np.ndarray) -> dict:
    """The benchmark check's mean gap and share off (``benchmark/check.py``)."""
    film, ref = film.astype(np.float64), ref.astype(np.float64)
    den = ref.sum(axis=1)
    floor = max(1e-3 * float(np.mean(np.abs(den))), 1e-12)
    g = np.abs(film - ref).sum(axis=1) / np.maximum(np.abs(den), floor)
    return {"mean_gap": float(g.mean()), "share_off": float(np.mean(g > OFF))}


def _within(gaps: dict) -> bool:
    return all(gaps[k] <= BAR[k] for k in BAR)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build_host(tmp_path_factory, HARNESS, "libprim_path_host_lobes.so")
    P = ctypes.c_void_p
    lib.ptt_host_iteration_regen.argtypes = (
        [P, P] + [ctypes.c_int32] * 4 + [P] * 5 + [ctypes.c_int32] * 2 + [P, P])
    return lib


@pytest.fixture(scope="module")
def references():
    cache = {}

    def get(lobe):
        if lobe not in cache:
            cache[lobe] = _reference(_doc(lobe))
        return cache[lobe]

    return get


def test_the_tally_has_the_references_columns():
    assert shade_ops.LOBES == ref_scene.LOBES


@pytest.mark.parametrize("side", ["host twin", "plain"])
@pytest.mark.parametrize("lobe", CASES, ids=[c or "all lobes" for c in CASES])
def test_port_matches_the_reference(host_lib, references, lobe, side):
    ref_film, ref_alive, ref_tally = references(lobe)
    doc = _doc(lobe)
    film, alive, tally = _host_twin(host_lib, doc) if side == "host twin" else _plain(doc)
    gaps = _gaps(film, ref_film)
    assert _within(gaps), gaps
    if side == "plain":
        np.testing.assert_array_equal(film, ref_film)
    for it in range(SPP):
        np.testing.assert_array_equal(alive[it], ref_alive[it])
        np.testing.assert_array_equal(tally[it], ref_tally[it])
    # Every lobe of the case scatters, and every scatter is counted once: at
    # each depth but the last, as many as paths alive after it.
    total = sum(tally)
    for name in shade_ops.LOBES[:-1]:
        column = shade_ops.LOBES.index(name)
        assert (total[:, column].sum() > 0) == (lobe in (None, name)), (name, total)
    np.testing.assert_array_equal(total[:-1].sum(axis=1), sum(alive)[:-1])


def test_glass_that_always_refracts_fails_the_comparison(references, monkeypatch):
    """A planted fault: glass without its Fresnel choice, every path through
    it refracting.  The film leaves the bar on the glass sphere alone."""
    ref_film, _, _ = references("glass")
    transmit = bsdf.sample_f_specular_transmission

    def glass(albedo, normal, wo, ior, u_choice, baby_eps):
        trans, _ = transmit(albedo, normal, wo, ior, baby_eps)
        return trans._replace(f=albedo)

    monkeypatch.setattr(bsdf, "sample_f_glass", glass)
    film, _, _ = _plain(_doc("glass"))
    gaps = _gaps(film, ref_film)
    assert not _within(gaps), gaps


@pytest.mark.parametrize("bad", ["shape", "dtype", "layout"])
def test_iteration_refuses_a_tally_it_cannot_fill(bad):
    static, cam = _static(_doc("mirror"))
    shape = (static.trace_depth, len(shade_ops.LOBES))
    lobes = {"shape": torch.zeros(shape[::-1], dtype=torch.int32),
             "dtype": torch.zeros(shape, dtype=torch.int64),
             "layout": torch.zeros(shape[::-1], dtype=torch.int32).t()}[bad]
    with pytest.raises(ValueError, match="lobe_counts"):
        fused.fused_prim_iteration(static, RenderConfig(), cam,
                                   film_ops.new_film(static.pixel_count), 1,
                                   prng.prng_key(SEED), lobe_counts=lobes)
