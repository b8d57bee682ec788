"""The textured shading stages of the port against the JAX package's.

* ``resolve_attributes``: the [N, 40] attribute rows (normals 0-8, uv 9-14,
  dpdu/dpdv 15-20, material 21, v0/e1/e2 24-32) equal the JAX package's on
  the textured uv sphere, misses included.
* ``shade.textured_surface`` on seeded lanes of the bump-mapped mesh scene
  (both gather forms) and on a bump-mapped prim, whose zero tangents make
  the bump normal NaN on both sides (``vec.normalize`` has no epsilon: the
  port matches it, compared with ``equal_nan``).
* ``fused.textured_mesh_surface`` (the fused mesh bounce's surface stage)
  against the JAX package's XLA glue of ``_fused_mesh_bounce_at``'s textured
  branch around the mono kernel.
* ``fused_mesh_shade`` in modes "textured" and "precomputed" (on the CPU its
  plain version) against the JAX package's Pallas ``_mesh_bounce_kernel`` via
  ``_fused_mesh_shade`` in interpret mode, on identical inputs over three
  chained bounces of a 16x16 frame: the textured mesh scene (with the next
  bounce's t_limit and sort key) and the textured-prim scene.

Tolerances: ``tests/torch_compare.py``; the shade outputs as in
``tests/test_torch_mesh_shade.py`` (up to 1% of a bounce's lanes outside the
stage tolerance, within ``rtol=1e-3``: cos/sin and rsqrt differ in the last
bit between XLA and torch, and scattering magnifies it).  The bump normal
of a traversal's hit also carries the last-bit differences of the winner's
(u, v) (XLA contracts multiply-adds) times the height map's gradient in
texel space (256 texels per unit of uv): up to 5% of its lanes may fall
outside the stage tolerance, all within ``rtol=1e-3`` (measured: 1.5% of
the seeded rays, at most 2.6e-5 off).  Integers (bounces, materials, keys)
are equal.
"""

import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_2025_tpu.config import RenderConfig as JConfig
from project3_cuda_path_tracer_2025_tpu.ops import camera as jcamera
from project3_cuda_path_tracer_2025_tpu.ops import fused as jfused
from project3_cuda_path_tracer_2025_tpu.ops import intersect_mxu as jmxu
from project3_cuda_path_tracer_2025_tpu.ops import shade as jshade
from project3_cuda_path_tracer_2025_tpu.ops.intersect import intersect_scene as j_isect
from project3_cuda_path_tracer_2025_tpu.ops.intersect import prim_t_min as j_prim_t_min
from project3_cuda_path_tracer_2025_tpu.ops.rays import Intersections as JIsect
from project3_cuda_path_tracer_2025_tpu.ops.rays import PathState as JPaths
from project3_cuda_path_tracer_2025_tpu.scene import build_device_scene as j_build
from project3_cuda_path_tracer_2025_tpu.scene import camera_state as j_camera_state
from project3_cuda_path_tracer_2025_tpu.scene import derive_render_camera as j_derive
from project3_cuda_path_tracer_2025_tpu.scene import load_scene as j_load
from project3_cuda_path_tracer_2025_tpu.scene import set_resolution as j_set_res
from project3_cuda_path_tracer_2025_tpu.utils import prng as jprng
from project3_cuda_path_tracer_2025_tpu.utils import vec as jvec
from project3_cuda_path_tracer_2025_tpu.utils.vec import Vec3 as JVec3
from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu_torch.ops import fused, intersect_mxu
from project3_cuda_path_tracer_2025_tpu_torch.ops import shade as shade_ops
from project3_cuda_path_tracer_2025_tpu_torch.ops.intersect import prim_t_min
from project3_cuda_path_tracer_2025_tpu_torch.ops.rays import Intersections, PathState
from project3_cuda_path_tracer_2025_tpu_torch.scene import from_jax_scene
from project3_cuda_path_tracer_2025_tpu_torch.utils import prng
from project3_cuda_path_tracer_2025_tpu_torch.utils.vec import Vec3
from torch_compare import ATOL_WORLD, close, close3, pair, pair1, unit

REPO = pathlib.Path(__file__).resolve().parent.parent
RES = 16
LOOSE = dict(share=0.01, ill_rtol=1e-3)
BUMP = dict(share=0.05, ill_rtol=1e-3)
MESH_TEX = "cornell_mesh_textured_local.json"
MESH_BUMP = "cornell_mesh_textured_bump_local.json"
PRIM_TEX = "cornell_prim_textured_local.json"


def _both(path, res=RES):
    jscene = j_set_res(j_load(str(path), native_bvh=False), res, res)
    jdev, jstatic = j_build(jscene)
    dev, static = from_jax_scene(jax.tree_util.tree_map(np.asarray, jdev), jstatic)
    return dev, static, jdev, jstatic, j_camera_state(j_derive(jscene.state.camera))


@pytest.fixture(scope="module")
def mesh_scene():
    return _both(REPO / "scenes" / MESH_TEX)


def _to_port(jp: JPaths) -> PathState:
    t = lambda a: torch.from_numpy(np.array(a))
    return PathState(Vec3(*map(t, jp.origin)), Vec3(*map(t, jp.direction)),
                     Vec3(*map(t, jp.color)), t(jp.pixel), t(jp.bounces))


def _vec(jv):
    return Vec3(*(torch.from_numpy(np.array(c)) for c in jv))


def test_resolve_attributes_columns_match_jax(mesh_scene):
    dev, static, jdev, jstatic, _ = mesh_scene
    rng = np.random.default_rng(0)
    tri = rng.integers(-1, static.num_triangles, 4000).astype(np.int32)
    got = intersect_mxu.resolve_attributes(dev.mxu_mesh, static.mxu_padded_tris,
                                           torch.from_numpy(tri))
    want = jmxu.resolve_attributes(jdev.mxu_mesh, jstatic.mxu_padded_tris, jnp.asarray(tri))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    hit = tri >= 0
    tr = dev.triangles
    idx = torch.from_numpy(tri[hit]).long()
    # uv 9-14 and the material 21 are the triangle's own, in leaf order.
    np.testing.assert_array_equal(got[hit][:, 9].numpy(), tr.uv0u[idx].numpy())
    np.testing.assert_array_equal(got[hit][:, 14].numpy(), tr.uv2v[idx].numpy())
    np.testing.assert_array_equal(got[hit][:, 21].numpy(), tr.material_id[idx].numpy())
    assert (got[~hit] == 0).all()


def _random_isect(rng, n, mid_choices):
    """Seeded lanes: unit normals, uv across [-1, 2), tangents of the mesh's
    scale, misses (t = -1) among them; (port Intersections, JAX Intersections, mid)."""
    normal = pair(unit(rng, n))
    dpdu = pair((unit(rng, n) * rng.uniform(1.0, 16.0, n)).astype(np.float32))
    dpdv = pair((unit(rng, n) * rng.uniform(1.0, 8.0, n)).astype(np.float32))
    uvu = pair1(rng.uniform(-1.0, 2.0, n).astype(np.float32))
    uvv = pair1(rng.uniform(-1.0, 2.0, n).astype(np.float32))
    t = pair1(np.where(rng.random(n) > 0.1, rng.uniform(0.5, 9.0, n), -1.0).astype(np.float32))
    mid = pair1(rng.choice(mid_choices, n).astype(np.int32))
    tri = pair1(np.ones(n, bool))
    mk = lambda k, I: I(t=t[k], normal=normal[k], material_id=mid[k], uv_u=uvu[k],
                        uv_v=uvv[k], dpdu=dpdu[k], dpdv=dpdv[k], is_triangle=tri[k])
    return mk(0, Intersections), mk(1, JIsect), mid


@pytest.mark.parametrize("name", [MESH_TEX, MESH_BUMP])
def test_textured_surface_matches_jax(name):
    dev, static, jdev, jstatic, _ = _both(REPO / "scenes" / name)
    rng = np.random.default_rng(1)
    n = 3000
    isect, jisect, (mid, jmid) = _random_isect(rng, n, np.arange(static.num_materials))
    live = pair1(rng.random(n) > 0.2)
    base = Vec3(*(dev.materials.color[i][mid.long()] for i in range(3)))
    jbase = jvec.select_gather(jdev.materials.color, jmid)
    alb, nrm = shade_ops.textured_surface(dev, static, isect, mid, base, live=live[0])
    jalb, jnrm = jshade.textured_surface(jdev, jstatic, jisect, jmid, jbase, live=live[1])
    tex_lane = np.asarray([static.material_consts[m].texture_id >= 0 for m in mid.tolist()])
    assert tex_lane.sum() > 50
    close3(alb, jalb)
    close3(nrm, jnrm, **LOOSE)
    bump = np.asarray([static.material_consts[m].bump_id >= 0 for m in mid.tolist()])
    assert not np.allclose(nrm.x.numpy()[bump], isect.normal.x.numpy()[bump])
    np.testing.assert_array_equal(nrm.x.numpy()[~bump], isect.normal.x.numpy()[~bump])


def test_bump_on_a_prim_matches_jax_nan(tmp_path):
    """A bump map on an analytic prim: zero tangents, so cross(dpdu', dpdv')
    is zero and the normal is NaN on both sides."""
    scene = json.loads((REPO / "scenes" / PRIM_TEX).read_text())
    mat = scene["Materials"]["sphere_tex"]
    mat["TEXTURE"] = str(REPO / "scenes" / "textures" / "checker_albedo.bmp")
    mat["BUMP_MAP"] = str(REPO / "scenes" / "textures" / "height_bumps.bmp")
    mat["BUMP_SCALE"] = 0.5
    path = tmp_path / "prim_bump.json"
    path.write_text(json.dumps(scene))
    (tmp_path / "obj").symlink_to(REPO / "scenes" / "obj")
    dev, static, jdev, jstatic, _ = _both(path)
    rng = np.random.default_rng(2)
    n = 500
    sphere_mat = scene_mid = static.material_consts.index(
        next(m for m in static.material_consts if m.bump_id >= 0))
    isect, jisect, (mid, jmid) = _random_isect(rng, n, [0, 1, sphere_mat])
    zero = pair(np.zeros((3, n), np.float32))
    isect = isect._replace(dpdu=zero[0], dpdv=zero[0], uv_u=isect.uv_u * 0, uv_v=isect.uv_v * 0)
    jisect = jisect._replace(dpdu=zero[1], dpdv=zero[1], uv_u=jisect.uv_u * 0,
                             uv_v=jisect.uv_v * 0)
    base = Vec3(*(dev.materials.color[i][mid.long()] for i in range(3)))
    alb, nrm = shade_ops.textured_surface(dev, static, isect, mid, base)
    jalb, jnrm = jshade.textured_surface(jdev, jstatic, jisect, jmid,
                                         jvec.select_gather(jdev.materials.color, jmid))
    on = mid.numpy() == scene_mid
    assert on.sum() > 50
    for a, b in zip(nrm, jnrm):
        assert np.isnan(a.numpy()[on]).all() and np.isnan(np.asarray(b)[on]).all()
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))  # NaN == NaN here
    close3(alb, jalb)


def _jax_tex_surface(jdev, jstatic, jpaths, t_lim):
    """The JAX package's XLA glue of ``_fused_mesh_bounce_at``'s textured
    branch around its mono kernel."""
    cfg = JConfig()
    ro, rd = jpaths.origin, jpaths.direction
    mh = jmxu.mesh_intersect_mxu(
        jdev.mxu_mesh, jstatic.num_triangles, jstatic.mxu_padded_tris, ro, rd,
        jpaths.alive, t_lim, cfg.baby_epsilon, interpret=True, compute_uv=False,
        planned=True, mono=True, planned_epilogue="mono_force",
    )
    at = jmxu.resolve_attributes(jdev.mxu_mesh, jstatic.mxu_padded_tris, mh.tri)
    uu, vv = jmxu.winner_uv_from_geom(at[:, 24:27], at[:, 27:30], at[:, 30:33], mh.tri,
                                      ro, rd, cfg.baby_epsilon)
    w = 1.0 - uu - vv
    col = lambda a: JVec3(at[:, a], at[:, a + 1], at[:, a + 2])
    hit = mh.tri >= 0
    ng = jvec.normalize(col(0) * w + col(3) * uu + col(6) * vv)
    ng = jvec.where(hit, ng, JVec3.zeros(uu.shape))
    ng = jvec.where(jvec.dot(rd, ng) > 0.0, -ng, ng)
    mat = jnp.where(hit, at[:, 21].astype(jnp.int32), -1)
    im = JIsect(t=mh.t, normal=ng, material_id=mat,
                uv_u=at[:, 9] * w + at[:, 11] * uu + at[:, 13] * vv,
                uv_v=at[:, 10] * w + at[:, 12] * uu + at[:, 14] * vv,
                dpdu=col(15), dpdv=col(18), is_triangle=hit)
    mid = jnp.clip(mat, 0, jstatic.num_materials - 1)
    alb, nrm = jshade.textured_surface(jdev, jstatic, im, mid,
                                       jvec.select_gather(jdev.materials.color, mid),
                                       live=hit & jpaths.alive)
    return mh.t, jvec.where(hit, nrm, JVec3.zeros(uu.shape)), mat, alb


def _camera_paths(jstatic, jcam, ik):
    n = RES * RES
    return jcamera.generate_camera_rays(jcam, RES, RES, jstatic.trace_depth,
                                        jprng.uniforms(jprng.stage_key(ik, 0, 0), n, 4))


def test_textured_mesh_surface_matches_jax(mesh_scene):
    """Rays from a sphere around the textured uv sphere toward its middle,
    and the scene's camera rays."""
    dev, static, jdev, jstatic, jcam = mesh_scene
    cfg = RenderConfig()
    rng = np.random.default_rng(3)
    m = 1024
    c = dev.mxu_mesh.center.numpy().astype(np.float64)
    o = rng.normal(size=(m, 3))
    o = c + 4.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = c + rng.uniform(-1.0, 1.0, (m, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = o.astype(np.float32).T, d.astype(np.float32).T
    jpaths = JPaths(JVec3(*map(jnp.asarray, o)), JVec3(*map(jnp.asarray, d)),
                    JVec3(*[jnp.ones(m)] * 3), jnp.arange(m, dtype=jnp.int32),
                    jnp.where(jnp.asarray(rng.random(m)) > 0.1, 8, 0).astype(jnp.int32))
    ik = jprng.iteration_key(jax.random.PRNGKey(0), jnp.int32(1))
    hits = []
    for jp in (jpaths, _camera_paths(jstatic, jcam, ik)):
        paths = _to_port(jp)
        tl = prim_t_min(static, cfg, paths.origin, paths.direction)
        mt, mn, mm, alb = fused.textured_mesh_surface(dev, static, cfg, paths, tl)
        jt, jn, jm, jalb = _jax_tex_surface(
            jdev, jstatic, jp, j_prim_t_min(jstatic, JConfig(), jp.origin, jp.direction))
        close(mm, jm)
        hit = np.asarray(jm) >= 0
        hits.append(int(hit.sum()))
        close(mt, jt, mask=hit)
        close3(mn, jn, **BUMP)
        close3(alb, jalb, mask=hit)
    assert hits[0] > 200 and hits[1] > 5, hits


@pytest.mark.parametrize("mode,emit", [("textured", "tlim+key"), ("precomputed", "")])
def test_mesh_shade_modes_match_pallas(mode, emit):
    name = MESH_TEX if mode == "textured" else PRIM_TEX
    dev, static, jdev, jstatic, jcam = _both(REPO / "scenes" / name)
    cfg, jcfg = RenderConfig(), JConfig()
    n = RES * RES
    ik = jprng.iteration_key(jax.random.PRNGKey(0), jnp.int32(1))
    pik = prng.iteration_key(prng.prng_key(0), 1)
    jpaths = _camera_paths(jstatic, jcam, ik)
    prim_static = dataclasses.replace(static, num_triangles=0)
    jprim_static = dataclasses.replace(jstatic, num_triangles=0)
    tables = dev.mxu_mesh
    hits = 0
    for d in range(3):
        paths = _to_port(jpaths)
        if mode == "textured":
            jt, jn, jm, jalb = _jax_tex_surface(
                jdev, jstatic, jpaths,
                j_prim_t_min(jstatic, jcfg, jpaths.origin, jpaths.direction))
            hits += int((np.asarray(jm) >= 0).sum())
        else:
            ji = j_isect(jdev, jstatic, jpaths, jcfg)
            jmid = jnp.clip(ji.material_id, 0, jstatic.num_materials - 1)
            jalb, jn = jshade.textured_surface(
                jdev, jstatic, ji, jmid, jvec.select_gather(jdev.materials.color, jmid),
                live=(jpaths.bounces > 0) & (ji.t > 0.0))
            jt, jm = ji.t, ji.material_id
            tex_mat = [i for i, mc in enumerate(jstatic.material_consts) if mc.texture_id >= 0]
            hits += int(np.isin(np.asarray(jm), tex_mat).sum())
        want = jfused._fused_mesh_shade(
            jprim_static, jcfg, jpaths, jt, jn, jm, None, mesh_albedo=jalb, interpret=True,
            mode=mode, su_key=jprng.stage_key(ik, d, 1), rng_n=n, emit=emit,
            tile_aabb=jdev.mxu_mesh.tile_aabb if emit == "tlim+key" else None,
            center=jdev.mxu_mesh.center if emit == "tlim+key" else None,
        )
        got = fused.fused_mesh_shade(
            prim_static, cfg, paths, torch.from_numpy(np.array(jt)), _vec(jn),
            torch.from_numpy(np.array(jm)), prng.stage_key(pik, d, 1), n, emit,
            tables if emit else None, mode=mode, mesh_albedo=_vec(jalb),
        )
        want_p, (want_tl, want_key) = want if emit else (want, (None, None))
        got_p, (got_tl, got_key, _) = got if emit else (got, (None, None, None))
        close(got_p.bounces, want_p.bounces)
        close(got_p.pixel, want_p.pixel)
        close3(got_p.origin, want_p.origin, atol=ATOL_WORLD, **LOOSE)
        close3(got_p.direction, want_p.direction, **LOOSE)
        close3(got_p.color, want_p.color, **LOOSE)
        if emit:
            close(got_tl, want_tl, atol=ATOL_WORLD, **LOOSE)
            close(got_key, want_key)
        jpaths = want_p
    assert hits > 20  # textured lanes took part
