"""The reference's lobes on the CPU: it reads the materials of the all-lobes
scene and still refuses what it cannot follow; it agrees with the port's
CPU path on a sphere of each lobe in the box and on the whole scene; a
planted lobe fault of the program and the bfloat16 control each fail the
same bar; and the iteration's work counts each lobe, an all-diffuse
scene's as before."""

import json

import numpy as np
import pytest
import torch

import check
import work
from conftest import BENCH
from reference import scene as ref_scene
from reference import tracer as ref_tracer
from spec import Spec

from project3_cuda_path_tracer_2025_tpu_torch.ops import bsdf
from project3_cuda_path_tracer_2025_tpu_torch.utils.vec import Vec3

ROOT = BENCH.parent
SCENES = ROOT / "scenes"
RES, SPP, SEED = 16, 4, 1234

# The bar of the mesh cells' kind, the mean gap and the share of pixels off
# (gap > check.OFF), not the largest gap: a specular path can fork on a
# last-bit difference (a refraction or a Fresnel choice taken the other
# way), and one forked path of SPP moves its pixel by up to about its whole
# value.  The bar holds two such pixels of RES * RES: a share of 2/256 and a
# mean of 2 * 0.6 / 256.  On the CPU the two sides agree bit for bit.
BAR = {"mean_gap": 5e-3, "share_off": 2 / (RES * RES)}
# Paths alive after each bounce: a forked path may move a count by one.
ALIVE_BAR = 1

LOBES = ("mirror", "transmissive", "glass", "microfacet")


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


def _port(doc: dict):
    """The port's CPU film [P, 3] and alive counts after SPP spp."""
    from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer
    from project3_cuda_path_tracer_2025_tpu_torch.scene import set_resolution
    from project3_cuda_path_tracer_2025_tpu_torch.scene.loader import scene_from_dict

    r = Renderer(set_resolution(scene_from_dict(doc, str(SCENES)), RES, RES), RenderConfig(),
                 seed=SEED, device="cpu")
    r.step_many(SPP)
    return r.image().reshape(-1, 3), r._alive_counts.tolist()


def _reference(doc: dict, dtype=torch.float32):
    """The reference's film [P, 3], alive counts and tracer, as the port's."""
    scene = check.load_scene({"scene": doc, "dir": str(SCENES)}, (RES, RES))
    tracer = check.Tracer(scene, SEED, dtype=dtype)
    n = scene.pixel_count
    film = check.reference_sums(tracer, [scene.render_camera()], [(0, np.arange(n), SPP)])[0]
    _, alive = tracer.radiance([scene.render_camera()], torch.arange(n), torch.full((n,), SPP))
    return film, alive.tolist(), tracer


def _judge(film, alive, ref_film, ref_alive) -> tuple:
    """(within the bar, the numbers, pixels equal bit for bit)."""
    numbers = check.gaps(film, ref_film, "")
    numbers["alive_gap"] = int(np.max(np.abs(np.subtract(alive, ref_alive))))
    within = (numbers["mean_gap"] <= BAR["mean_gap"] and numbers["share_off"] <= BAR["share_off"]
              and numbers["alive_gap"] <= ALIVE_BAR)
    return within, numbers, int((np.asarray(film) == ref_film).all(axis=1).sum())


def test_reference_reads_the_lobes():
    scene = check.load_scene({"scene": _doc(), "dir": str(SCENES)})
    by_name = dict(zip(_doc()["Materials"], scene.materials))
    assert {k: m.lobe for k, m in by_name.items()} == {
        "light": "diffuse", "diffuse_white": "diffuse", "diffuse_red": "diffuse",
        "diffuse_green": "diffuse", "glass": "glass", "mirror": "mirror",
        "transmissive": "transmissive", "microfacet": "microfacet"}
    assert scene.lobes == set(ref_scene.LOBES)
    assert (by_name["glass"].ior, by_name["microfacet"].roughness,
            by_name["microfacet"].metallic) == (1.5, 0.3, 0.5)
    assert by_name["light"].emittance == 5.0


def test_reference_still_refuses_what_it_cannot_follow():
    doc = _doc("mirror")
    doc["Materials"]["diffuse_white"]["ROUGHNESS"] = 0.2  # "Diffuse" ignores it
    scene = ref_scene.load(doc, str(SCENES))
    assert scene.lobes == {"diffuse", "mirror"}
    doc["Materials"]["mirror"]["TYPE"] = "Velvet"
    with pytest.raises(NotImplementedError, match="Velvet"):
        ref_scene.load(doc, str(SCENES))
    textured = json.loads((SCENES / "cornell_mesh_textured_local.json").read_text())
    with pytest.raises(NotImplementedError):
        ref_scene.load(textured, str(SCENES))


@pytest.mark.parametrize("lobe", LOBES + (None,))
def test_reference_agrees_with_the_port_on_each_lobe(lobe, capsys):
    """A sphere of each lobe in the box, and the whole all-lobes scene."""
    doc = _doc(lobe)
    film, alive = _port(doc)
    ref_film, ref_alive, tracer = _reference(doc)
    within, numbers, equal = _judge(film, alive, ref_film, ref_alive)
    with capsys.disabled():
        print(f"\n{lobe or 'all lobes'}: {equal} of {RES * RES} pixels equal bit for bit, "
              f"{numbers}")
    assert within, numbers
    assert film.sum() > 0
    scattered = tracer.lobe_counts(tracer.scene.render_camera(), SPP)
    for name in LOBES if lobe is None else (lobe,):
        assert sum(scattered[name]) > 0, (name, scattered)


# -- faults planted in the program's lobes ------------------------------------

def glass_always_refracts(monkeypatch):
    """Glass without its Fresnel choice: every path refracts."""
    transmit = bsdf.sample_f_specular_transmission

    def glass(albedo, normal, wo, ior, u_choice, baby_eps):
        trans, _ = transmit(albedo, normal, wo, ior, baby_eps)
        return trans._replace(f=albedo)
    monkeypatch.setattr(bsdf, "sample_f_glass", glass)


def mirror_keeps_colour(monkeypatch):
    """A mirror that leaves the path's colour as it was (no albedo)."""
    reflect = bsdf.sample_f_specular_reflection

    def mirror(albedo, normal, wo):
        s = reflect(albedo, normal, wo)
        one = torch.ones_like(s.pdf)
        return s._replace(f=Vec3(one, one, one))
    monkeypatch.setattr(bsdf, "sample_f_specular_reflection", mirror)


def transmissive_eta_inverted(monkeypatch):
    """Refraction with eta = IOR where the path enters (1/IOR leaving)."""
    transmit = bsdf.sample_f_specular_transmission

    def trans(albedo, normal, wo, ior, baby_eps):
        return transmit(albedo, normal, wo, 1.0 / ior, baby_eps)
    monkeypatch.setattr(bsdf, "sample_f_specular_transmission", trans)


def microfacet_f0_fixed(monkeypatch):
    """Cook-Torrance with F0 fixed at 0.04 (metallic taken as 0)."""
    cook_torrance = bsdf.sample_f_cook_torrance

    def micro(albedo, normal, wo, roughness, metallic, *uniforms):
        return cook_torrance(albedo, normal, wo, roughness, torch.zeros_like(metallic),
                             *uniforms)
    monkeypatch.setattr(bsdf, "sample_f_cook_torrance", micro)


FAULTS = {"glass": glass_always_refracts, "mirror": mirror_keeps_colour,
          "transmissive": transmissive_eta_inverted, "microfacet": microfacet_f0_fixed}


@pytest.mark.parametrize("whole", [False, True], ids=["one lobe", "all lobes"])
@pytest.mark.parametrize("lobe", LOBES)
def test_lobe_fault_fails_the_bar(lobe, whole, monkeypatch):
    doc = _doc(None if whole else lobe)
    ref_film, ref_alive, _ = _reference(doc)
    FAULTS[lobe](monkeypatch)
    film, alive = _port(doc)
    within, numbers, _ = _judge(film, alive, ref_film, ref_alive)
    assert not within, (lobe, numbers)


@pytest.mark.parametrize("lobe", LOBES + (None,))
def test_bfloat16_control_fails_the_bar(lobe):
    """The reference in bfloat16 in the program's place (``control.py``'s
    control), at the same size."""
    doc = _doc(lobe)
    low_film, low_alive, _ = _reference(doc, torch.bfloat16)
    ref_film, ref_alive, _ = _reference(doc)
    within, numbers, _ = _judge(low_film, low_alive, ref_film, ref_alive)
    assert not within, numbers


def test_transmissive_meets_no_total_internal_reflection():
    """Why no fault of the total internal reflection can show: the normal is
    turned toward the ray before the scatter, so a path always enters with
    eta = 1/IOR < 1, and glm::refract's k = 1 - eta^2 (1 - cos^2) stays
    above 0.  Leaving (the normal turned away), the same test finds it."""
    g = torch.Generator().manual_seed(5)
    unit = lambda v: v / v.norm(dim=0)
    d, n = unit(torch.randn(3, 20000, generator=g)), unit(torch.randn(3, 20000, generator=g))
    n = torch.where((d * n).sum(0) > 0, -n, n)  # toward the ray, as the tracer turns it
    ior = torch.full((20000,), 1.5)
    _, tir = ref_tracer._transmit(tuple(d), tuple(n), ior)
    assert not tir.any()
    _, tir = ref_tracer._transmit(tuple(d), tuple(-n), ior)
    assert tir.float().mean() > 0.2


# -- the iteration's work by lobe ----------------------------------------------

def _todays_work(pixels, boxes, spheres, alive) -> tuple:
    live_before = [pixels] + list(alive[:-1])
    return (pixels * 24 + len(alive) * 4,
            pixels * 45 + sum(live_before) * (25 + boxes * 78 + spheres * 60 + 100))


def test_iteration_work_of_an_all_diffuse_scene_is_unchanged():
    """For the same inputs, the formula the work had before it counted
    lobes; with the reference's counts of ``cornell`` (all diffuse) too."""
    rng = np.random.default_rng(3)
    for _ in range(20):
        pixels = int(rng.integers(1, 10**6))
        boxes, spheres = (int(x) for x in rng.integers(0, 9, 2))
        alive = sorted((int(a) for a in rng.integers(0, pixels + 1, 8)), reverse=True)
        assert work.iteration_work(pixels, boxes, spheres, alive) == \
            _todays_work(pixels, boxes, spheres, alive)

    cfg = Spec.load().config("cornell")
    scene = check.load_scene(cfg, (RES, RES))
    tracer = check.Tracer(scene, SEED)
    assert scene.lobes == {"diffuse"} and not tracer.lobes
    counts = tracer.lobe_counts(scene.render_camera(), SPP)
    assert all(sum(c) == 0 for name, c in counts.items() if name != "diffuse")
    _, alive = tracer.radiance([scene.render_camera()], torch.arange(RES * RES),
                               torch.full((RES * RES,), SPP))
    boxes = sum(p.kind == ref_scene.CUBE for p in scene.prims)
    args = (RES * RES, boxes, len(scene.prims) - boxes, alive.tolist())
    assert work.iteration_work(*args, counts) == work.iteration_work(*args) == _todays_work(*args)


def test_iteration_work_counts_each_lobe_by_hand():
    # 4 pixels, 2 boxes and 1 sphere, alive after each of 3 bounces: 3, 1, 0;
    # scattered: 2 off the mirror and 1 through glass at bounce 0, 1 off the
    # microfacet at bounce 1, the rest diffuse.
    lobes = {"diffuse": [0, 0, 0], "mirror": [2, 0, 0], "glass": [1, 0, 0],
             "transmissive": [0, 0, 0], "microfacet": [0, 1, 0]}
    nbytes, ops = work.iteration_work(4, 2, 1, [3, 1, 0], lobes)
    base = _todays_work(4, 2, 1, [3, 1, 0])
    assert nbytes == base[0]
    assert ops == base[1] + 2 * (work.OPS_MIRROR - 100) + (work.OPS_GLASS - 100) \
        + (work.OPS_MICROFACET - 100)


def test_lobe_counts_are_the_scattered_paths():
    """Every lobe of the all-lobes scene scatters paths; at each bounce but
    the last, the paths scattered are the paths alive after it."""
    _, ref_alive, tracer = _reference(_doc())
    counts = tracer.lobe_counts(tracer.scene.render_camera(), SPP)
    assert all(sum(counts[name]) > 0 for name in ref_scene.LOBES)
    per_bounce = [sum(counts[name][d] for name in ref_scene.LOBES)
                  for d in range(tracer.scene.depth)]
    assert per_bounce[:-1] == ref_alive[:-1]
