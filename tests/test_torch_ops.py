"""The port's ray ops against the JAX package's, stage by stage.

Each stage gets identical inputs, made from a numpy seed and handed to both
packages: box and sphere intersection, ``intersect_scene``, ``prim_t_min``,
every BSDF lobe, ``scatter_compose`` with per-lane Glass, Reflective,
Transmissive, Microfacet, diffuse and emissive parameters, and
``generate_camera_rays``.

Tolerances: ``tests/torch_compare.py``.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_2025_tpu.config import RenderConfig as JConfig
from project3_cuda_path_tracer_2025_tpu.ops import bsdf as jbsdf
from project3_cuda_path_tracer_2025_tpu.ops import camera as jcamera
from project3_cuda_path_tracer_2025_tpu.ops import intersect as jintersect
from project3_cuda_path_tracer_2025_tpu.ops import shade as jshade
from project3_cuda_path_tracer_2025_tpu.ops.rays import Intersections as JIsect
from project3_cuda_path_tracer_2025_tpu.ops.rays import PathState as JPaths
from project3_cuda_path_tracer_2025_tpu.scene import build_device_scene as j_build
from project3_cuda_path_tracer_2025_tpu.scene import camera_state as j_camera_state
from project3_cuda_path_tracer_2025_tpu.scene import derive_render_camera as j_derive
from project3_cuda_path_tracer_2025_tpu.scene import load_scene as j_load
from project3_cuda_path_tracer_2025_tpu.scene import set_resolution as j_set_res
from project3_cuda_path_tracer_2025_tpu.utils.vec import Vec3 as JVec3
from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu_torch.ops import bsdf, intersect, shade
from project3_cuda_path_tracer_2025_tpu_torch.ops import camera as camera_ops
from project3_cuda_path_tracer_2025_tpu_torch.ops.rays import Intersections, PathState
from project3_cuda_path_tracer_2025_tpu_torch.scene import (
    build_device_scene, camera_state, derive_render_camera, load_scene,
    set_resolution,
)
from project3_cuda_path_tracer_2025_tpu_torch.utils.vec import Vec3
from torch_compare import ATOL_WORLD, close, close3, pair, pair1, unit

REPO = pathlib.Path(__file__).resolve().parent.parent
SCENE = str(REPO / "scenes" / "cornell_all_lobes.json")
N = 4096
@pytest.fixture(scope="module")
def scenes():
    _, jstatic = j_build(j_load(SCENE))
    dev, static = build_device_scene(load_scene(SCENE), "cpu")
    return static, jstatic, dev


@pytest.fixture(scope="module")
def rays():
    rng = np.random.default_rng(0)
    o = np.stack([
        rng.uniform(-4.5, 4.5, N), rng.uniform(0.5, 9.5, N), rng.uniform(-4.5, 4.5, N),
    ]).astype(np.float32)
    o[:, : N // 8] = np.array([[0.0], [5.0], [10.5]], np.float32)  # from the eye
    d = unit(rng, N)
    return pair(o), pair(d)


@pytest.mark.parametrize("gi", range(10))
def test_prim_intersection(scenes, rays, gi):
    static, jstatic, _ = scenes
    g, jg = static.geoms[gi], jstatic.geoms[gi]
    assert g == jg
    (ro, jro), (rd, jrd) = rays
    fn, jfn = (
        (intersect.box_intersection, jintersect.box_intersection)
        if g.gtype == 1 else
        (intersect.sphere_intersection, jintersect.sphere_intersection)
    )
    t, p, n = fn(g, ro, rd, 1e-4)
    jt, jp, jn = jfn(jg, jro, jrd, 1e-4)
    hit = np.asarray(jt) > 0
    assert hit.any()
    close(t > 0, hit)
    close(t, jt)
    close3(p, jp, hit, atol=ATOL_WORLD)
    close3(n, jn, hit)


def test_intersect_scene_and_prim_t_min(scenes, rays):
    static, jstatic, dev = scenes
    (ro, jro), (rd, jrd) = rays
    zi = torch.zeros(N, dtype=torch.int32)
    paths = PathState(ro, rd, Vec3(*([torch.ones(N)] * 3)), zi, zi + 8)
    jpaths = JPaths(jro, jrd, JVec3(*([jnp.ones(N)] * 3)), jnp.zeros(N, jnp.int32),
                    jnp.full(N, 8, jnp.int32))
    got = intersect.intersect_scene(dev, static, paths, RenderConfig())
    want = jintersect.intersect_scene(None, jstatic, jpaths, JConfig())
    close(got.material_id, want.material_id)
    close(got.is_triangle, want.is_triangle)
    close(got.t, want.t)
    close3(got.normal, want.normal)
    close(intersect.prim_t_min(static, RenderConfig(), ro, rd),
          jintersect.prim_t_min(jstatic, JConfig(), jro, jrd))


@pytest.fixture(scope="module")
def lobe_inputs():
    rng = np.random.default_rng(1)
    n = unit(rng, N)
    wo = unit(rng, N)
    albedo = rng.uniform(0, 1, (3, N)).astype(np.float32)
    u = rng.uniform(0, 1, (3, N)).astype(np.float32)
    u[:, :4] = 0.0  # the degenerate corner of the concentric map
    ior = rng.uniform(1.1, 2.4, N).astype(np.float32)
    rough = rng.uniform(0.05, 1.0, N).astype(np.float32)
    metal = rng.uniform(0, 1, N).astype(np.float32)
    return dict(
        n=pair(n), wo=pair(wo), albedo=pair(albedo),
        u=[pair1(u[i]) for i in range(3)],
        ior=pair1(ior), rough=pair1(rough), metal=pair1(metal),
    )


def _lobe(got, want):
    close3(got.wi, want.wi)
    close3(got.f, want.f)
    close(got.pdf, want.pdf)


def test_frame_and_warps(lobe_inputs):
    (n, jn), (wo, jwo) = lobe_inputs["n"], lobe_inputs["wo"]
    (u0, ju0), (u1, ju1), _ = lobe_inputs["u"]
    for got, want in zip(bsdf.coordinate_system(n), jbsdf.coordinate_system(jn)):
        close3(got, want)
    close3(bsdf.local_to_world(n, wo), jbsdf.local_to_world(jn, jwo))
    close3(bsdf.world_to_local(n, wo), jbsdf.world_to_local(jn, jwo))
    for got, want in zip(bsdf.square_to_disk_concentric(u0, u1),
                         jbsdf.square_to_disk_concentric(ju0, ju1)):
        close(got, want)
    close3(bsdf.square_to_hemisphere_cosine(u0, u1),
           jbsdf.square_to_hemisphere_cosine(ju0, ju1))


def test_fresnel(lobe_inputs):
    (n, jn), (wo, jwo) = lobe_inputs["n"], lobe_inputs["wo"]
    (ior, jior), (metal, jmetal) = lobe_inputs["ior"], lobe_inputs["metal"]
    (a, ja) = lobe_inputs["albedo"]
    cos = (n.x * wo.x + n.y * wo.y + n.z * wo.z)
    jcos = jn.x * jwo.x + jn.y * jwo.y + jn.z * jwo.z
    close(bsdf.fresnel_dielectric_eval(cos, ior), jbsdf.fresnel_dielectric_eval(jcos, jior))
    close3(bsdf.fresnel_schlick(torch.abs(cos), a), jbsdf.fresnel_schlick(jnp.abs(jcos), ja))


def test_diffuse_mirror_transmission_glass(lobe_inputs):
    (n, jn), (wo, jwo), (a, ja) = lobe_inputs["n"], lobe_inputs["wo"], lobe_inputs["albedo"]
    (u0, ju0), (u1, ju1), (u2, ju2) = lobe_inputs["u"]
    (ior, jior) = lobe_inputs["ior"]
    _lobe(bsdf.sample_f_diffuse(a, n, u1, u2), jbsdf.sample_f_diffuse(ja, jn, ju1, ju2))
    _lobe(bsdf.sample_f_specular_reflection(a, n, wo),
          jbsdf.sample_f_specular_reflection(ja, jn, jwo))
    got, tir = bsdf.sample_f_specular_transmission(a, n, wo, ior, 1e-5)
    want, jtir = jbsdf.sample_f_specular_transmission(ja, jn, jwo, jior, 1e-5)
    assert np.asarray(jtir).any() and not np.asarray(jtir).all()
    close(tir, jtir)
    _lobe(got, want)
    _lobe(bsdf.sample_f_glass(a, n, wo, ior, u0, 1e-5),
          jbsdf.sample_f_glass(ja, jn, jwo, jior, ju0, 1e-5))


def test_cook_torrance(lobe_inputs):
    (n, jn), (wo, jwo), (a, ja) = lobe_inputs["n"], lobe_inputs["wo"], lobe_inputs["albedo"]
    (u0, ju0), (u1, ju1), (u2, ju2) = lobe_inputs["u"]
    (r, jr), (m, jm) = lobe_inputs["rough"], lobe_inputs["metal"]
    _lobe(bsdf.sample_f_cook_torrance(a, n, wo, r, m, u0, u1, u2),
          jbsdf.sample_f_cook_torrance(ja, jn, jwo, jr, jm, ju0, ju1, ju2))


def test_scatter_compose_per_lane_materials(lobe_inputs):
    """Every lane its own material: Glass, Reflective, Transmissive,
    Microfacet, Diffuse or Emitting, with hits, misses and dead paths."""
    rng = np.random.default_rng(2)
    kind = rng.integers(0, 6, N)
    refl = np.isin(kind, (0, 1)).astype(np.float32)
    refr = np.isin(kind, (0, 2)).astype(np.float32)
    rough = np.where(kind == 3, rng.uniform(0.05, 1, N), -1.0).astype(np.float32)
    metal = np.where(kind == 3, rng.uniform(0, 1, N), -1.0).astype(np.float32)
    emit = np.where(kind == 5, 5.0, 0.0).astype(np.float32)
    ior = rng.uniform(1.1, 2.0, N).astype(np.float32)
    t = rng.uniform(0.5, 8.0, N).astype(np.float32)
    t[rng.uniform(size=N) < 0.1] = -1.0
    bounces = rng.integers(0, 9, N).astype(np.int32)
    o = rng.uniform(-4, 4, (3, N)).astype(np.float32)
    color = rng.uniform(0, 1, (3, N)).astype(np.float32)

    (n, jn), (d, jd), (a, ja) = lobe_inputs["n"], lobe_inputs["wo"], lobe_inputs["albedo"]
    (o_t, o_j), (c_t, c_j) = pair(o), pair(color)
    (b_t, b_j), (t_t, t_j) = pair1(bounces), pair1(t)
    z = np.zeros(N, np.float32)
    zt, zj = torch.zeros(N), jnp.asarray(z)
    paths = PathState(o_t, d, c_t, torch.arange(N, dtype=torch.int32), b_t)
    jpaths = JPaths(o_j, jd, c_j, jnp.arange(N, dtype=jnp.int32), b_j)
    isect = Intersections(t_t, n, torch.zeros(N, dtype=torch.int32), zt, zt,
                          Vec3(zt, zt, zt), Vec3(zt, zt, zt), torch.zeros(N, dtype=torch.bool))
    jisect = JIsect(t_j, jn, jnp.zeros(N, jnp.int32), zj, zj, JVec3(zj, zj, zj),
                    JVec3(zj, zj, zj), jnp.zeros(N, bool))
    params = [pair1(x) for x in (emit, refl, refr, ior, rough, metal)]
    u = [p for p in lobe_inputs["u"]]
    got = shade.scatter_compose(
        RenderConfig(), paths, isect, n, a, *[p[0] for p in params],
        [p[0] for p in u])
    want = jshade.scatter_compose(
        JConfig(), jpaths, jisect, jn, ja, *[p[1] for p in params],
        [p[1] for p in u])
    close(got.bounces, want.bounces)
    close3(got.origin, want.origin, atol=ATOL_WORLD)
    close3(got.direction, want.direction)
    close3(got.color, want.color)


def test_generate_camera_rays():
    scene = set_resolution(load_scene(str(REPO / "scenes" / "cornell_dof.json")), 40, 24)
    jscene = j_set_res(j_load(str(REPO / "scenes" / "cornell_dof.json")), 40, 24)
    cam = camera_state(derive_render_camera(scene.state.camera))
    jcam = j_camera_state(j_derive(jscene.state.camera))
    for f in cam._fields:
        np.testing.assert_array_equal(getattr(cam, f).numpy(), np.asarray(getattr(jcam, f)))
    n = 40 * 24
    u = np.random.default_rng(3).uniform(0, 1, (4, n)).astype(np.float32)
    got = camera_ops.generate_camera_rays(cam, 40, 24, 8, torch.from_numpy(u))
    want = jcamera.generate_camera_rays(jcam, 40, 24, 8, jnp.asarray(u))
    close3(got.origin, want.origin, atol=ATOL_WORLD)
    close3(got.direction, want.direction)
    close3(got.color, want.color)
    close(got.pixel, want.pixel)
    close(got.bounces, want.bounces)


@pytest.mark.parametrize(
    "coeffs,bias",
    [((0.0, 1.0, 0.0), 0.0), ((-1.0, 0.0, 0.0), 0.5), ((0.0, 0.0, 0.0), 0.0),
     ((0.3, 0.0, -2.0), -0.25), ((1.0, -1.0, 0.0), None)],
)
def test_row_dot_folding_bit_exact(coeffs, bias):
    """``_row_dot``'s constant folding, signed zeros included: a folded
    ``0 * x`` must not turn an exact -0.0 into +0.0 (``1/d`` would flip)."""
    from project3_cuda_path_tracer_2025_tpu.utils import vec as jvec
    from project3_cuda_path_tracer_2025_tpu_torch.utils import vec

    t = np.array([[-0.0, 0.0, 1.5, -2.25, 3.0e-8, -0.0],
                  [0.0, -0.0, -1.0, 4.0, 7.5, -0.0],
                  [2.0, -0.0, 0.0, -3.5, 1.0e8, 0.0]], np.float32)
    got = vec._row_dot(coeffs, [torch.from_numpy(r.copy()) for r in t], bias)
    want = np.asarray(jvec._row_dot(coeffs, [jnp.asarray(r) for r in t], bias))
    got = np.broadcast_to(got.numpy() if isinstance(got, torch.Tensor) else got, want.shape)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
