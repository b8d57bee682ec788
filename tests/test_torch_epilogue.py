"""The epilogue variants of the port (``lb_asc_intersect``,
``epilogue_mono_intersect``; kernels ``ptt_lb_asc_kernel`` and
``ptt_epilogue_mono_kernel``) against the JAX script's own kernels.

On CPU tensors the wrappers run their plain versions (``lb_asc_plain``,
``epilogue_mono_plain``); the JAX side runs the kernels of
``scripts/profile_epilogue.py`` (copied verbatim into
``tests/epilogue_jax_ref.py``, the copy checked against the script's text
here) in Pallas interpret mode on the same rays, tables and plan.  Cases:
the mid-bounce population the port's script captures on the 5-tile and the
20-tile mesh scenes at 24x24 (576 rays, three ray blocks), and the two-tile
mesh whose every hit ties across tiles (``torch_compare.tie_mesh``).

Tolerance: none.  ``tri`` is exact and ``t`` is exact (``==`` on float32, so
-0.0 equals 0.0): both sides evaluate every candidate pair with the same
float32 operations in the same order, and a strict "<" over tiles taken in
ascending id keeps the lowest id at the minimum on both.  The "mm" flavors
are timing floors with wrong results by design: the least ``det`` numerator
over the visited tiles, the lowest lane at it.  They are held to the JAX
script's ``lb_mm`` and ``mono_call("mm")`` on the same three cases, and to
their definition written out in numpy on a tiny case.
"""

import ast
import importlib.util
import inspect
import pathlib
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import epilogue_jax_ref as jref
from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer
from project3_cuda_path_tracer_2025_tpu_torch.ops import intersect_mxu as mxu
from project3_cuda_path_tracer_2025_tpu_torch.scene import load_scene, set_resolution
from project3_cuda_path_tracer_2025_tpu_torch.utils.vec import Vec3
from test_torch_mesh_planned import traversal_case
from torch_compare import TIE_TRIS

REPO = pathlib.Path(__file__).resolve().parent.parent
EPS = 1e-5


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_profile_epilogue", REPO / "scripts" / "torch_profile_epilogue.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _case(name):
    """(tables, ro, rd, live, tl) of the port, sorted as the script sorts."""
    if name == "tie":
        c = traversal_case("tie")
        ro, rd, active, tl = c["t"]
        tab = c["pt"]
        live = active & mxu.root_hit_mask(tab, ro, rd, tl)
        return tab, ro, rd, live, tl
    tpe = _script()
    cfg = RenderConfig(mesh_intersector="mxu", ray_sorting="off")
    scene = set_resolution(load_scene(str(REPO / "scenes" / f"cornell_mesh_{name}.json")), 24, 24)
    r = Renderer(scene, cfg, device="cpu")
    paths, tl, live = tpe.capture_population(r, cfg, bounce0=False)
    return r.dev.mxu_mesh, paths.origin, paths.direction, live, tl


@pytest.fixture(scope="module", params=["5k", "20k", "tie"])
def case(request):
    tab, ro, rd, live, tl = _case(request.param)
    ct = tab.tile_aabb.shape[0]
    pr = mxu.plan_rays(tab, ro, rd, live, tl)
    plan = mxu.plan_with_prefix(tab.tile_aabb, *pr)
    asc = mxu.ascending_plan(plan, ct)
    stack = lambda v: torch.stack(list(v), dim=1).numpy()
    n = tl.shape[0]
    rayf, tlim = jref.ray_features(stack(pr.os)[:n], stack(rd), live.numpy(), tl.numpy(),
                                   pr.tl.shape[0])
    jax_fns = jref.build(tab.features.numpy(), tab.tile_aabb.numpy(), tlim, asc.ids.numpy(),
                         asc.cnt.numpy(), EPS)
    return dict(name=request.param, tab=tab, rays=(ro, rd, live, tl), plan=plan, asc=asc, ct=ct,
                rayf=jnp.asarray(rayf), jax=jax_fns, n=n)


def _jax(case, variant):
    t, tri = case["jax"][variant](case["rayf"])
    return np.asarray(t)[:case["n"], 0], np.asarray(tri)[:case["n"], 0]


def _assert_equal(got, want, min_hits):
    np.testing.assert_array_equal(got[1].numpy(), want[1])  # tri: exact
    np.testing.assert_array_equal(got[0].numpy(), want[0])  # t: exact
    assert int((got[1] >= 0).sum()) >= min_hits


def test_copied_sources_match_the_script():
    """Each function of ``epilogue_jax_ref.COPIED`` is, text for text, the
    function of the same name inside the script's ``main()``."""
    src = (REPO / "scripts" / "profile_epilogue.py").read_text()
    main = next(n for n in ast.parse(src).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    script = {n.name: ast.get_source_segment(src, n) for n in main.body
              if isinstance(n, ast.FunctionDef)}
    ref_src = textwrap.dedent(inspect.getsource(jref.build))
    build = ast.parse(ref_src).body[0]
    copied = {n.name: ast.get_source_segment(ref_src, n) for n in build.body
              if isinstance(n, ast.FunctionDef)}
    assert set(copied) == set(jref.COPIED)
    for name in jref.COPIED:
        assert textwrap.dedent(copied[name]) == textwrap.dedent(script[name]), name


def test_ascending_plan_is_the_scripts_ids_asc(case):
    """``ascending_plan`` against the script's construction (a stable
    argsort of the candidate mask), re-done here in numpy."""
    plan, ct = case["plan"], case["ct"]
    nb = plan.cnt.shape[0]
    h = plan.tlo.numpy().reshape(nb, ct) < np.inf
    hb = np.zeros((nb, ct), bool)
    hb[np.arange(nb)[:, None], plan.ids.numpy().reshape(nb, ct)] = h
    ar = np.arange(ct)[None, :]
    ids_asc = np.argsort(np.where(hb, ar, ct + ar), axis=1, kind="stable").astype(np.int32)
    np.testing.assert_array_equal(case["asc"].ids.numpy(), ids_asc.reshape(-1))
    np.testing.assert_array_equal(case["asc"].cnt.numpy(), plan.cnt.numpy())
    cand = np.take_along_axis(hb, ids_asc, axis=1)
    assert (cand == (np.arange(ct)[None, :] < plan.cnt.numpy()[:, None])).all()
    assert np.isfinite(case["asc"].tlo.numpy().reshape(nb, ct)[cand]).all()


def test_lb_asc_matches_the_jax_script_kernel(case):
    before = mxu.lb_asc_intersect.launches
    got = mxu.lb_asc_intersect(case["tab"], *case["rays"], case["asc"], EPS)
    _assert_equal(got, _jax(case, "lb_asc"), 15)
    assert mxu.lb_asc_intersect.launches == before  # CPU tensors: the plain version


@pytest.mark.parametrize("flavor,variant", [("full", "mono"), ("gate", "mono_gate")])
def test_epilogue_mono_matches_the_jax_script_kernel(case, flavor, variant):
    before = mxu.epilogue_mono_intersect.launches
    got = mxu.epilogue_mono_intersect(case["tab"], *case["rays"], EPS, flavor)
    _assert_equal(got, _jax(case, variant), 15)
    assert mxu.epilogue_mono_intersect.launches == before


def test_exact_variants_equal_the_lanebest_walk(case):
    """lb_asc, mono and mono_gate compute the function of the planned
    lane-best walk (its plain version here), ties included."""
    tab, rays = case["tab"], case["rays"]
    ref = mxu.planned_lanebest_intersect(tab, *rays, case["plan"], EPS)
    outs = {
        "lb_asc": mxu.lb_asc_plain(tab, *rays, case["asc"], EPS),
        "mono": mxu.epilogue_mono_plain(tab, *rays, EPS, "full"),
        "mono_gate": mxu.epilogue_mono_plain(tab, *rays, EPS, "gate"),
    }
    for name, (t, tri) in outs.items():
        assert torch.equal(tri, ref[1]), name
        assert torch.equal(t.view(torch.int32), ref[0].view(torch.int32)), name
    if case["name"] == "tie":
        hit = ref[1] >= 0
        assert set(ref[1][hit].tolist()) == {TIE_TRIS[0]}


@pytest.mark.parametrize("variant", ["lb_mm", "mono_mm"])
def test_mm_flavors_match_the_jax_script(case, variant):
    """The floors (plain versions on CPU tensors) against the script's
    ``lb_mm`` and ``mono_call("mm")`` in interpret mode: ``t`` and ``tri``
    exact, dead rays of a visiting block included (zeroed features: det 0,
    lane 0)."""
    tab, rays = case["tab"], case["rays"]
    if variant == "lb_mm":
        got = mxu.lb_asc_intersect(tab, *rays, case["asc"], EPS, mm_only=True)
    else:
        got = mxu.epilogue_mono_intersect(tab, *rays, EPS, "mm")
    _assert_equal(got, _jax(case, variant), 15)


def test_mm_flavors_follow_their_definition():
    """The floor flavors on a tiny case, against the definition written out
    in numpy over per-lane minimum planes, as the JAX script keeps them (the
    fused multiply-adds by ``fma32``): per ray the least ``det`` numerator
    over the visited tiles' pairs, ties to the lower lane; dead rays run
    with all-zero features; a block without a visit returns (t_limit, -1)."""
    tab, ro, rd, live, tl = _case("tie")
    n, ct = 300, tab.tile_aabb.shape[0]
    cut = lambda v: Vec3(*(x[:n].contiguous() for x in v))
    ro, rd, live, tl = cut(ro), cut(rd), live[:n].clone(), tl[:n].clone()
    live[256:] = False  # the second block: no live ray
    tl[:8] = float("-inf")  # nothing is below this limit
    plan = mxu.plan_with_prefix(tab.tile_aabb, *mxu.plan_rays(tab, ro, rd, live, tl))
    asc = mxu.ascending_plan(plan, ct)
    feat = torch.stack([torch.where(live, f, 0.0) for f in mxu._features(tab, ro, rd).feat], 1)
    coef = tab.coef.numpy()

    def det(tile):
        c = coef[tile * 1024:(tile + 1) * 1024]
        acc = np.zeros((n, 1024), np.float32)
        for col, f in enumerate(dict(mxu.MONO_COEF)["det"]):
            acc = mxu.fma32(feat[:, f][:, None], torch.from_numpy(c[None, :, col].copy()),
                            torch.from_numpy(acc)).numpy()
        return acc

    def define(visits):
        q = np.full((n, 1024), np.inf, np.float32)  # per-lane minimum over the visited tiles
        for tile in range(ct):
            rows = visits[np.arange(n) // 256, tile]
            q[rows] = np.minimum(q[rows], det(tile)[rows])
        best = q.min(axis=1)
        lane = np.where(q <= best[:, None], np.arange(1024)[None, :], 2**31 - 1).min(axis=1)
        hit = best < tl.numpy()
        return np.where(hit, best, tl.numpy()), np.where(hit, lane, -1)

    lb_visits = mxu._plan_visits(asc, ct).numpy()
    mono_visits = np.zeros((2, ct), bool)
    mono_visits[0] = True
    for got, visits in ((mxu.lb_asc_intersect(tab, ro, rd, live, tl, asc, EPS, mm_only=True),
                         lb_visits),
                        (mxu.epilogue_mono_intersect(tab, ro, rd, live, tl, EPS, "mm"),
                         mono_visits)):
        want_t, want_lane = define(visits)
        np.testing.assert_array_equal(got[1].numpy(), want_lane)
        np.testing.assert_array_equal(got[0].numpy(), want_t)
        assert (got[1][:8] == -1).all() and (got[1][256:] == -1).all()
        assert int((got[1] >= 0).sum()) > 100


def test_flavor_and_capacity_errors():
    tab, ro, rd, live, tl = _case("tie")
    with pytest.raises(ValueError, match="flavor"):
        mxu.epilogue_mono_intersect(tab, ro, rd, live, tl, EPS, "fast")
    with pytest.raises(ValueError, match="flavor"):
        mxu.epilogue_mono_plain(tab, ro, rd, live, tl, EPS, "fast")
