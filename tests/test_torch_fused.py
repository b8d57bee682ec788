"""The port's kernel wrappers (their plain versions, on the CPU) against
the JAX package's Pallas kernels run in interpret mode, as
``tests/test_fused.py`` runs them.

``fused_prim_bounce`` gets identical path state and uniforms on both sides
for three chained bounces; ``fused_prim_iteration`` gets the same seed and
iteration number (the port derives its stage keys itself, so this also
holds its key derivation to the JAX package's).  Both on
``scenes/cornell_all_lobes.json`` at 16x16, which reaches every lobe.
Tolerances: ``tests/torch_compare.py``, except that a bounce may have up
to 1% of its lanes outside the stage tolerance (still within ``rtol=1e-3``):
a sphere hit far from the sphere solves a badly conditioned quadratic (at
12 units from a sphere of radius 1.25 the radicand loses ~3 digits to
``|o|^2 - 0.25``), so the hit normal, and the direction scattered about it,
carry the last-bit differences of the inputs magnified.  First diverging
input, found this way: lane 169 of bounce 0 (a glass sphere hit 12.004
units away), whose hit normal differs by 6e-6 (5e-5 relative) while its
glass sample agrees exactly given the same normal; refracted, the
direction differs by 2.7e-4 relative.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_2025_tpu.config import RenderConfig as JConfig
from project3_cuda_path_tracer_2025_tpu.ops import camera as jcamera
from project3_cuda_path_tracer_2025_tpu.ops import fused as jfused
from project3_cuda_path_tracer_2025_tpu.ops.rays import PathState as JPaths
from project3_cuda_path_tracer_2025_tpu.scene import build_device_scene as j_build
from project3_cuda_path_tracer_2025_tpu.scene import camera_state as j_camera_state
from project3_cuda_path_tracer_2025_tpu.scene import derive_render_camera as j_derive
from project3_cuda_path_tracer_2025_tpu.scene import load_scene as j_load
from project3_cuda_path_tracer_2025_tpu.scene import set_resolution as j_set_res
from project3_cuda_path_tracer_2025_tpu.utils import prng as jprng
from project3_cuda_path_tracer_2025_tpu.utils.vec import Vec3 as JVec3
from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu_torch.ops import film as film_ops
from project3_cuda_path_tracer_2025_tpu_torch.ops import fused
from project3_cuda_path_tracer_2025_tpu_torch.ops.rays import PathState
from project3_cuda_path_tracer_2025_tpu_torch.scene import (
    build_device_scene, camera_state, derive_render_camera, load_scene,
    set_resolution,
)
from project3_cuda_path_tracer_2025_tpu_torch.utils import prng
from project3_cuda_path_tracer_2025_tpu_torch.utils.vec import Vec3
from torch_compare import ATOL_WORLD, assert_films_close, close, close3

REPO = pathlib.Path(__file__).resolve().parent.parent
SCENE = str(REPO / "scenes" / "cornell_all_lobes.json")
RES = 16
BOUNCE_SHARE, BOUNCE_ILL_RTOL = 0.01, 1e-3
# The sharded draw's lanes outside the stage tolerance beyond the 1%
# allowance (2 of 256 lanes), by bounce.  At bounce 1, lane 86 hits the
# microfacet sphere (radius 1) 6.75 units away at cos 0.12, the badly
# conditioned quadratic above (t differs by 9e-6 relative); lanes 147 and
# 151 graze the glass sphere (cos 0.073, 0.027; t and normal equal on both
# sides) and reflect, so the reflected direction's small component carries
# the inputs' last bits magnified (up to 4.4e-4 relative).  They are held to
# ``BOUNCE_ILL_RTOL``; every other lane to the module's allowance.
SHARDED_ILL = {1: [86, 147, 151]}


@pytest.fixture(scope="module")
def both():
    jscene = j_set_res(j_load(SCENE), RES, RES)
    scene = set_resolution(load_scene(SCENE), RES, RES)
    _, jstatic = j_build(jscene)
    _, static = build_device_scene(scene, "cpu")
    jcam = j_camera_state(j_derive(jscene.state.camera))
    cam = camera_state(derive_render_camera(scene.state.camera))
    return static, jstatic, cam, jcam


def _to_port(jp: JPaths) -> PathState:
    t = lambda a: torch.from_numpy(np.array(a))
    return PathState(
        Vec3(*map(t, jp.origin)), Vec3(*map(t, jp.direction)),
        Vec3(*map(t, jp.color)), t(jp.pixel), t(jp.bounces),
    )


@pytest.mark.parametrize("form", ["uniforms", "inline", "inline sharded"])
def test_fused_prim_bounce_matches_pallas(both, form):
    """``form`` "uniforms": the [3, n] plane, the JAX signature; "inline":
    the port draws each ray's uniforms from ``su_key`` at its pixel, as the
    JAX ``megakernel_iteration``'s ``draw3`` unsharded (pixel == index,
    ``rng_n`` == n).  "inline sharded": a shard's pixels (offset 1,000 in a
    stream of n + 2,000), the JAX kernel given ``uniforms_at(skey, pixel, 3,
    rng_n)``; the port's inline draw must give the same outputs bit for bit
    as its [3, n] form given those uniforms, and both are held to the JAX
    kernel, the lanes of ``SHARDED_ILL`` to ``BOUNCE_ILL_RTOL`` alone."""
    static, jstatic, _, jcam = both
    n = RES * RES
    ik = jprng.iteration_key(jax.random.PRNGKey(0), jnp.int32(1))
    jpaths = jcamera.generate_camera_rays(
        jcam, RES, RES, jstatic.trace_depth, jprng.uniforms(jprng.stage_key(ik, 0, 0), n, 4)
    )
    rng_n = n
    if form == "inline sharded":
        jpaths = jpaths._replace(pixel=jnp.arange(n, dtype=jnp.int32) + 1000)
        rng_n = n + 2000
    for d in range(3):
        skey = jprng.stage_key(ik, d, 1)
        key = prng.stage_key(prng.iteration_key(prng.prng_key(0), 1), d, 1)
        assert key == tuple(int(w) for w in np.asarray(skey))
        u = np.array(jprng.uniforms_at(skey, jpaths.pixel, 3, rng_n))
        if form == "uniforms":
            assert np.array_equal(u, np.array(jprng.uniforms(skey, n, 3)))
        want = jfused.fused_prim_bounce(jstatic, JConfig(), jpaths, jnp.asarray(u),
                                        interpret=True)
        paths = _to_port(jpaths)
        if form == "uniforms":
            got = fused.fused_prim_bounce(static, RenderConfig(), paths, torch.from_numpy(u))
        else:
            got = fused.fused_prim_bounce(static, RenderConfig(), paths, su_key=key,
                                          rng_n=rng_n)
        named = np.zeros(n, bool)
        if form == "inline sharded":
            given = fused.fused_prim_bounce(static, RenderConfig(), paths, torch.from_numpy(u))
            for a, b in zip((*got.origin, *got.direction, *got.color, got.bounces),
                            (*given.origin, *given.direction, *given.color, given.bounces)):
                assert torch.equal(a, b)
            named[SHARDED_ILL.get(d, [])] = True
        close(got.bounces, want.bounces)
        close(got.pixel, want.pixel)
        loose = dict(share=BOUNCE_SHARE, ill_rtol=BOUNCE_ILL_RTOL)
        for mask, kw in ((~named, loose), (named, dict(share=1.0, ill_rtol=BOUNCE_ILL_RTOL))):
            if mask.any():
                close3(got.origin, want.origin, mask, atol=ATOL_WORLD, **kw)
                close3(got.direction, want.direction, mask, **kw)
                close3(got.color, want.color, mask, **kw)
        jpaths = want  # identical inputs for the next bounce


def test_fused_prim_iteration_matches_pallas(both):
    static, jstatic, cam, jcam = both
    n, depth = RES * RES, jstatic.trace_depth
    ik = jprng.iteration_key(jax.random.PRNGKey(0), jnp.int32(1))
    cam_u = jprng.uniforms(jprng.stage_key(ik, 0, 0), n, 4)
    planes = [cam_u[0], cam_u[1], cam_u[2], cam_u[3]]
    for d in range(depth):
        su = jprng.uniforms(jprng.stage_key(ik, d, 1), n, 3)
        planes += [su[0], su[1], su[2]]
    z = jnp.zeros(n, jnp.float32)
    jfilm, jalive = jfused.fused_prim_iteration(
        jstatic, JConfig(), jfused.camera_statics(jcam), JVec3(z, z, z), tuple(planes),
        interpret=True,
    )
    assert fused.camera_statics(cam) == jfused.camera_statics(jcam)
    film, alive = fused.fused_prim_iteration(
        static, RenderConfig(), cam, film_ops.new_film(n), 1, prng.prng_key(0)
    )
    np.testing.assert_array_equal(alive.numpy(), np.asarray(jalive))
    assert_films_close(torch.stack(list(film), 1).numpy(), np.stack(jfilm, 1))
