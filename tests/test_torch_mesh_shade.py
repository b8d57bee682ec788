"""The mesh-shade kernel's plain version against the JAX package's Pallas
``_mesh_bounce_kernel`` (via ``_fused_mesh_shade``, mode "plain", inline
RNG, interpret mode), for every ``emit`` mode.

Both sides get identical inputs on ``scenes/cornell_mesh_5k.json`` at
16x16 (the JAX scene carried across with ``from_jax_scene``): the JAX
package's camera rays, then for each of three chained bounces the mesh
surface (``fused.mesh_surface``: the mono traversal and the winner's
normal and material, itself held to the JAX package's XLA glue here) and
the shade key of that bounce.  Every output plane is compared: the path
state, and with ``emit`` the next bounce's prim t_limit and sort key.

Tolerances: ``tests/torch_compare.py`` for the path state and t_limit,
except that a bounce may have up to 1% of its lanes outside the stage
tolerance (still within ``rtol=1e-3``), as in ``tests/test_torch_fused.py``
(cos/sin and rsqrt differ in the last bit between XLA and torch, and
scattering magnifies it).  Integers (bounces, material, pixel) are equal.
The key, an integer function of the scattered ray, must be equal on every
lane: it quantizes tile entry distances and directions coarsely, so the
last-bit differences of the scattered rays do not reach it here (a key
that did differ would change only the sort order, never an image).
"""

import dataclasses
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
from project3_cuda_path_tracer_2025_tpu.ops.intersect import prim_t_min as j_prim_t_min
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
from project3_cuda_path_tracer_2025_tpu_torch.ops import fused
from project3_cuda_path_tracer_2025_tpu_torch.ops.intersect import prim_t_min
from project3_cuda_path_tracer_2025_tpu_torch.ops.rays import PathState
from project3_cuda_path_tracer_2025_tpu_torch.scene import from_jax_scene
from project3_cuda_path_tracer_2025_tpu_torch.utils import prng
from project3_cuda_path_tracer_2025_tpu_torch.utils.vec import Vec3
from torch_compare import ATOL_WORLD, close, close3

REPO = pathlib.Path(__file__).resolve().parent.parent
RES = 16
LOOSE = dict(share=0.01, ill_rtol=1e-3)


@pytest.fixture(scope="module")
def scene():
    jscene = j_set_res(j_load(str(REPO / "scenes" / "cornell_mesh_5k.json"),
                              native_bvh=False), RES, RES)
    jdev, jstatic = j_build(jscene)
    dev, static = from_jax_scene(jax.tree_util.tree_map(np.asarray, jdev), jstatic)
    jcam = j_camera_state(j_derive(jscene.state.camera))
    return dev, static, jdev, jstatic, jcam


def _to_port(jp: JPaths) -> PathState:
    t = lambda a: torch.from_numpy(np.array(a))
    return PathState(Vec3(*map(t, jp.origin)), Vec3(*map(t, jp.direction)),
                     Vec3(*map(t, jp.color)), t(jp.pixel), t(jp.bounces))


def _jax_surface(jdev, jstatic, jpaths, t_lim):
    """The JAX package's XLA glue of ``_fused_mesh_bounce_at`` (untextured
    branch) around its mono kernel."""
    cfg = JConfig()
    ro, rd = jpaths.origin, jpaths.direction
    mh = jmxu.mesh_intersect_mxu(
        jdev.mxu_mesh, jstatic.num_triangles, jstatic.mxu_padded_tris, ro, rd,
        jpaths.alive, t_lim, cfg.baby_epsilon, interpret=True, compute_uv=False,
        planned=True, mono=True, planned_epilogue="mono_force",
    )
    at = jmxu.resolve_shade_attributes(jdev.mxu_mesh, jstatic.mxu_padded_tris, mh.tri)
    uu, vv = jmxu.winner_uv_from_geom(at[:, 10:13], at[:, 13:16], at[:, 16:19], mh.tri,
                                      ro, rd, cfg.baby_epsilon)
    w = 1.0 - uu - vv
    n = jvec.normalize(JVec3(at[:, 0], at[:, 1], at[:, 2]) * w
                       + JVec3(at[:, 3], at[:, 4], at[:, 5]) * uu
                       + JVec3(at[:, 6], at[:, 7], at[:, 8]) * vv)
    hit = mh.tri >= 0
    n = jvec.where(hit, n, JVec3.zeros(uu.shape))
    return mh.t, n, jnp.where(hit, at[:, 9].astype(jnp.int32), -1)


@pytest.mark.parametrize("emit", fused.EMIT_MODES)
def test_mesh_shade_plain_matches_pallas(scene, emit):
    dev, static, jdev, jstatic, jcam = scene
    cfg, jcfg = RenderConfig(), JConfig()
    n = RES * RES
    ik = jprng.iteration_key(jax.random.PRNGKey(0), jnp.int32(1))
    pik = prng.iteration_key(prng.prng_key(0), 1)
    jpaths = jcamera.generate_camera_rays(
        jcam, RES, RES, jstatic.trace_depth, jprng.uniforms(jprng.stage_key(ik, 0, 0), n, 4))
    prim_static = dataclasses.replace(static, num_triangles=0)
    jprim_static = dataclasses.replace(jstatic, num_triangles=0)
    tables = dev.mxu_mesh
    for d in range(3):
        paths = _to_port(jpaths)
        t_lim = prim_t_min(static, cfg, paths.origin, paths.direction)
        mt, mn, mm = fused.mesh_surface(tables, static, cfg, paths, t_lim)
        jt, jn, jm = _jax_surface(jdev, jstatic, jpaths,
                                  j_prim_t_min(jstatic, jcfg, jpaths.origin, jpaths.direction))
        close(mm, jm)
        close(mt, jt, mask=np.asarray(jm) >= 0)
        close3(mn, jn)
        # Identical inputs from here on: the JAX package's surface.
        mt = torch.from_numpy(np.array(jt))
        mn = Vec3(*(torch.from_numpy(np.array(c)) for c in jn))
        mm = torch.from_numpy(np.array(jm))
        want = jfused._fused_mesh_shade(
            jprim_static, jcfg, jpaths, jt, jn, jm, None, interpret=True,
            su_key=jprng.stage_key(ik, d, 1), rng_n=n, emit=emit,
            tile_aabb=jdev.mxu_mesh.tile_aabb if emit == "tlim+key" else None,
            center=jdev.mxu_mesh.center if emit == "tlim+key" else None,
        )
        got = fused.fused_mesh_shade(
            prim_static, cfg, paths, mt, mn, mm, prng.stage_key(pik, d, 1), n, emit,
            tables.tile_aabb, tables.center,
        )
        want_p, (want_tl, want_key) = want if emit else (want, (None, None))
        got_p, (got_tl, got_key) = got if emit else (got, (None, None))
        close(got_p.bounces, want_p.bounces)
        close(got_p.pixel, want_p.pixel)
        close3(got_p.origin, want_p.origin, atol=ATOL_WORLD, **LOOSE)
        close3(got_p.direction, want_p.direction, **LOOSE)
        close3(got_p.color, want_p.color, **LOOSE)
        if emit:
            close(got_tl, want_tl, atol=ATOL_WORLD, **LOOSE)
        if emit == "tlim+key":
            close(got_key, want_key)
            assert (got_key.numpy() < (1 << 30)).sum() > 20  # live keys, not sentinels
        jpaths = want_p
