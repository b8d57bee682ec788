"""The port's texture layer against the JAX package's.

* The procedural fixtures under ``scenes/textures/`` are what
  ``torch_compare.procedural_textures`` makes from seed 0, and both BMP
  decoders (PIL where present, the loaders' own reader otherwise, the only
  one on a machine without PIL) read them back exactly.
* ``build_device_scene`` gives the JAX package's texture tables: ``rgba``,
  ``grad``, ``packed``, ``width``, ``height`` equal element for element, and
  the same static texture fields.
* ``ops.texture``'s samplers against the JAX package's on the same seeded
  inputs: uv across [-2, 3) (the wrap, negative texel indices included),
  texture ids in and out of range (the magenta / zero fallback), dead lanes;
  both gather forms of ``sample_surface`` (two quads, and the single packed
  quad), and ``sample_height`` as the red channel.

Tolerances: the texel-space coordinate ``u * W - 0.5`` is identical on both
sides, so the gathered rows are the same and the samples agree to
``rtol=1e-5, atol=1e-6`` (``tests/torch_compare.py``; XLA may contract the
bilinear blend's multiply-adds).  Indices, fallbacks and tables are exact.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_2025_tpu.ops import texture as jtex
from project3_cuda_path_tracer_2025_tpu.scene import build_device_scene as j_build
from project3_cuda_path_tracer_2025_tpu.scene import load_scene as j_load
from project3_cuda_path_tracer_2025_tpu_torch.ops import texture as tex
from project3_cuda_path_tracer_2025_tpu_torch.scene import build_device_scene, load_scene
from project3_cuda_path_tracer_2025_tpu_torch.scene.textures import _load_bmp, load_texture
from torch_compare import TEXTURES, bmp_bytes, close, close3, procedural_textures

REPO = pathlib.Path(__file__).resolve().parent.parent
TEX_SCENES = [
    "cornell_prim_textured_local.json",
    "cornell_mesh_textured_local.json",
    "cornell_mesh_textured_bump_local.json",
]


def test_texture_fixtures_are_the_generator_output():
    made = procedural_textures(0)
    assert sorted(made) == sorted(TEXTURES)
    for name, img in made.items():
        path = REPO / "scenes" / "textures" / name
        assert path.read_bytes() == bmp_bytes(img), name
        assert img.shape == (256, 256, 3)
        rgba = _load_bmp(str(path))
        np.testing.assert_array_equal(rgba[..., :3], img)
        assert (rgba[..., 3] == 255).all()
        np.testing.assert_array_equal(load_texture(str(path)).data, rgba)


@pytest.mark.parametrize("name", TEX_SCENES)
def test_texture_tables_match_jax(name):
    path = str(REPO / "scenes" / name)
    jdev, jstatic = j_build(j_load(path, native_bvh=False))
    dev, static = build_device_scene(load_scene(path), "cpu")
    for f in ("num_textures", "tex_wmax", "tex_hmax", "tex_dims", "prim_textured"):
        assert getattr(static, f) == getattr(jstatic, f), f
    assert static.material_consts == jstatic.material_consts
    assert static.num_textures >= 1
    for f in ("rgba", "grad", "packed", "width", "height"):
        a, b = getattr(dev.textures, f).numpy(), np.asarray(getattr(jdev.textures, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.fixture(scope="module")
def tables():
    """Both packages' tables of the two fixtures (ids 0 and 1)."""
    path = str(REPO / "scenes" / "cornell_mesh_textured_bump_local.json")
    jdev, jstatic = j_build(j_load(path, native_bvh=False))
    dev, static = build_device_scene(load_scene(path), "cpu")
    return dev.textures, static, jdev.textures


def _lanes(seed, n, num_textures):
    rng = np.random.default_rng(seed)
    u = rng.uniform(-2.0, 3.0, n).astype(np.float32)
    v = rng.uniform(-2.0, 3.0, n).astype(np.float32)
    u[:8] = [0.0, 1.0, -1.0, 0.5 / 256, 1.5 / 256, -0.5 / 256, 255.5 / 256, 2.0]
    tid = rng.integers(-2, num_textures + 2, n).astype(np.int32)
    bid = rng.integers(-1, num_textures + 1, n).astype(np.int32)
    live = rng.random(n) > 0.2
    return u, v, tid, bid, live


def _dims(tid, static):
    """Per-lane (width, height) of the clipped ids, as textured_surface's
    select chains give them."""
    dims = np.asarray(static.tex_dims, np.int32)
    c = np.clip(tid, 0, static.num_textures - 1)
    return dims[c, 0], dims[c, 1]


@pytest.mark.parametrize("single_quad", [False, True])
def test_sample_surface_matches_jax(tables, single_quad):
    tt, static, jt = tables
    n = 3000
    u, v, tid, bid, live = _lanes(0, n, static.num_textures)
    if single_quad:  # the precondition: a lane's ids agree where both are valid
        both = (tid >= 0) & (tid < static.num_textures) & (bid >= 0) & (bid < static.num_textures)
        bid = np.where(both, tid, bid)
    twt, tht = _dims(tid, static)
    twb, thb = _dims(bid, static)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    args = (static.num_textures, static.tex_wmax, static.tex_hmax)
    got = tex.sample_surface(tt, *args, t(tid), t(bid), t(u), t(v), t(twt), t(tht), t(twb),
                             t(thb), live=t(live), single_quad=single_quad)
    want = jtex.sample_surface(jt, *args, jnp.asarray(tid), jnp.asarray(bid), jnp.asarray(u),
                               jnp.asarray(v), jnp.asarray(twt), jnp.asarray(tht),
                               jnp.asarray(twb), jnp.asarray(thb), live=jnp.asarray(live),
                               single_quad=single_quad)
    close3(got[0], want[0])
    close(got[1], want[1])
    close(got[2], want[2])
    valid_t = (tid >= 0) & (tid < static.num_textures)
    np.testing.assert_array_equal(got[0].x.numpy()[~valid_t], 1.0)  # magenta
    np.testing.assert_array_equal(got[0].y.numpy()[~valid_t], 0.0)
    np.testing.assert_array_equal(got[0].z.numpy()[~valid_t], 1.0)
    valid_b = (bid >= 0) & (bid < static.num_textures)
    np.testing.assert_array_equal(got[1].numpy()[~valid_b], 0.0)
    assert np.abs(got[1].numpy()[valid_b & live]).max() > 0


def test_single_quad_reproduces_the_float_stack(tables):
    """The packed rows' u8 / 255 albedo equals the f32 stack's bit for bit,
    and their 10-bit gradients the grad table's to 1e-6."""
    tt, static, _ = tables
    n = 2000
    u, v, tid, _, live = _lanes(1, n, static.num_textures)
    tid = np.clip(tid, 0, static.num_textures - 1)
    tw, th = _dims(tid, static)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    args = (tt, static.num_textures, static.tex_wmax, static.tex_hmax, t(tid), t(tid), t(u),
            t(v), t(tw), t(th), t(tw), t(th))
    one = tex.sample_surface(*args, live=t(live), single_quad=True)
    two = tex.sample_surface(*args, live=t(live), single_quad=False)
    for a, b in zip(one[0], two[0]):
        assert torch.equal(a, b)
    np.testing.assert_allclose(one[1].numpy(), two[1].numpy(), atol=1e-6)
    np.testing.assert_allclose(one[2].numpy(), two[2].numpy(), atol=1e-6)


def test_sample_texture_and_height_match_jax(tables):
    tt, static, jt = tables
    n = 2000
    u, v, tid, _, _ = _lanes(2, n, static.num_textures)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    args = (static.num_textures, static.tex_wmax, static.tex_hmax)
    got = tex.sample_texture(tt, *args, t(tid), t(u), t(v))
    want = jtex.sample_texture(jt, *args, jnp.asarray(tid), jnp.asarray(u), jnp.asarray(v))
    close3(got, want)
    h = tex.sample_height(tt, *args, t(tid), t(u), t(v))
    close(h, jtex.sample_height(jt, *args, jnp.asarray(tid), jnp.asarray(u), jnp.asarray(v)))
    valid = (tid >= 0) & (tid < static.num_textures)
    assert torch.equal(h[torch.from_numpy(valid)], got.x[torch.from_numpy(valid)])  # red
    np.testing.assert_array_equal(h.numpy()[~valid], 0.0)
    np.testing.assert_array_equal(got.y.numpy()[~valid], 0.0)  # magenta's green


def test_bilinear_wrap_is_floored(tables):
    """uv just below 0 wraps to the far texel (torch.remainder, like
    jnp.mod); a truncating fmod would index out of the texture."""
    tt, static, _ = tables
    (i00, i01, _, _), fx, _ = tex._bilinear_prep(
        torch.zeros(2, dtype=torch.int32), torch.tensor([-0.25 / 256, 0.25 / 256]),
        torch.tensor([0.5, 0.5]), torch.full((2,), 256, dtype=torch.int32),
        torch.full((2,), 256, dtype=torch.int32), static.tex_wmax, static.tex_hmax)
    assert (i00 % static.tex_wmax).tolist() == [255, 255]
    assert (i01 % static.tex_wmax).tolist() == [0, 0]
