"""Texture sampling: bilinear, wrap addressing, normalized coords.

Parity with the reference's CUDA texture objects (``src/pathtrace.cu:110-131``:
``cudaFilterModeLinear`` + ``cudaAddressModeWrap`` + normalized float reads)
and its samplers (``sampleTexture``/``sampleHeight``, ``:505-519``), as the
JAX package's ``ops/texture.py`` implements them:

* albedo/height lookups flip v: ``tex2D(u, 1 - v)``;
* out-of-range texture ids return magenta (1, 0, 1) / height 0;
* bump height is the ``.x`` (red) channel.

CUDA's linear filter samples at (u*W - 0.5, v*H - 0.5) texel space; the same
convention is used here with full float weights (CUDA quantizes the fraction
to 9 bits).  A bilinear sample is four row gathers from the texel row tables
(``scene.device.TextureTable``).  The wrap is a floored modulo
(``torch.remainder``, like ``jnp.mod``), so negative texel indices wrap to
the far edge.  Torch ops on the card as on the CPU: in the JAX package this
is XLA, outside every Pallas kernel.
"""

from __future__ import annotations

import torch

from ..scene.device import TextureTable
from ..utils.vec import Vec3


def _bilinear_prep(
    tex_id: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
    tw: torch.Tensor,  # per-lane true width (i32)
    th: torch.Tensor,
    wmax: int,
    hmax: int,
):
    """Corner row indices + fractional weights for one bilinear-wrap sample.

    Returns ``((i00, i01, i10, i11), fx, fy)`` where iYX indexes the flat
    row table (Y = 0/1 texel row, X = 0/1 texel column)."""
    x = u * tw.to(torch.float32) - 0.5
    y = v * th.to(torch.float32) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0i = x0.to(torch.int32)
    y0i = y0.to(torch.int32)

    x0w = torch.remainder(x0i, tw)
    x1w = torch.remainder(x0i + 1, tw)
    y0w = torch.remainder(y0i, th)
    y1w = torch.remainder(y0i + 1, th)

    base = tex_id * (wmax * hmax)
    idx = lambda yy, xx: base + yy * wmax + xx
    return (
        (idx(y0w, x0w), idx(y0w, x1w), idx(y1w, x0w), idx(y1w, x1w)),
        fx,
        fy,
    )


def _bilinear_combine(r00, r01, r10, r11, fx, fy):
    top = r00 * (1.0 - fx) + r01 * fx
    bot = r10 * (1.0 - fx) + r11 * fx
    return top * (1.0 - fy) + bot * fy


def _bilinear_rows(
    rgba: torch.Tensor,  # [NT * Hmax * Wmax, 4]
    tex_id: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
    tw: torch.Tensor,
    th: torch.Tensor,
    wmax: int,
    hmax: int,
) -> torch.Tensor:
    """Bilinear-wrap sample -> [N, 4] RGBA rows."""
    (i00, i01, i10, i11), fx, fy = _bilinear_prep(tex_id, u, v, tw, th, wmax, hmax)
    g = lambda i: rgba[i.long()]
    return _bilinear_combine(g(i00), g(i01), g(i10), g(i11), fx, fy)


def sample_surface(
    tex: TextureTable,
    num_textures: int,
    wmax: int,
    hmax: int,
    tex_id: torch.Tensor,  # i32 per lane (may be out of range)
    bump_id: torch.Tensor,
    uv_u: torch.Tensor,
    uv_v: torch.Tensor,
    tw_t: torch.Tensor,  # texture dims per lane (albedo)
    th_t: torch.Tensor,
    tw_b: torch.Tensor,  # bump dims per lane
    th_b: torch.Tensor,
    live: torch.Tensor = None,  # lanes whose result is consumed
    single_quad: bool = False,  # no material has distinct texture/bump ids
):
    """The shading path's texture traffic in texel-quad gathers: one
    bilinear RGBA sample (albedo) and one bilinear sample of the
    height-difference table (bump gradients), or, with ``single_quad``, one
    quad of the packed rows that serves both.  Dead and missed lanes
    (``live`` False) gather texel row 0.

    Returns ``(tex_rgb: Vec3, dh_du_raw, dh_dv_raw)`` where the raw
    gradients are per-texel differences (divide by du/dv for per-uv)."""
    valid_t = (tex_id >= 0) & (tex_id < num_textures)
    valid_b = (bump_id >= 0) & (bump_id < num_textures)
    top = max(num_textures - 1, 0)
    tid = torch.clamp(tex_id, 0, top)
    bid = torch.clamp(bump_id, 0, top)

    qa, fxa, fya = _bilinear_prep(tid, uv_u, 1.0 - uv_v, tw_t, th_t, wmax, hmax)
    qb, fxb, fyb = _bilinear_prep(bid, uv_u, 1.0 - uv_v, tw_b, th_b, wmax, hmax)
    n = uv_u.shape[0]
    if single_quad and tex.packed is not None:
        # One quad serves albedo and gradients: for a lane with both valid
        # the ids (hence indices) coincide by the single_quad precondition;
        # otherwise the unused output is masked.
        q = tuple(torch.where(valid_b, ib, ia) for ia, ib in zip(qa, qb))
        if live is not None:
            q = tuple(torch.where(live & (valid_t | valid_b), i, 0) for i in q)
        rows = tex.packed[torch.cat(q).long()]  # [4N, 2] i32
        w0, w1 = rows[:, 0], rows[:, 1]
        # u8 / 255 (a division, not a multiplication by 1/255) reproduces the
        # f32 stack exactly.
        alb4 = torch.stack(
            [(w0 & 0xFF).to(torch.float32), ((w0 >> 8) & 0xFF).to(torch.float32),
             ((w0 >> 16) & 0xFF).to(torch.float32)], dim=1,
        ) / 255.0
        grd4 = torch.stack(
            [((w1 & 0x3FF) - 256).to(torch.float32),
             (((w1 >> 10) & 0x3FF) - 256).to(torch.float32)], dim=1,
        ) / 255.0
    else:
        if live is not None:
            qa = tuple(torch.where(live & valid_t, i, 0) for i in qa)
            qb = tuple(torch.where(live & valid_b, i, 0) for i in qb)
        alb4 = tex.rgba[torch.cat(qa).long()]  # [4N, 4]
        grd4 = tex.grad[torch.cat(qb).long()]  # [4N, 2]
    ra = [alb4[c * n: (c + 1) * n] for c in range(4)]
    rg = [grd4[c * n: (c + 1) * n] for c in range(4)]
    alb = _bilinear_combine(ra[0], ra[1], ra[2], ra[3], fxa, fya)
    grd = _bilinear_combine(rg[0], rg[1], rg[2], rg[3], fxb, fyb)

    tex_rgb = Vec3(
        torch.where(valid_t, alb[:, 0], 1.0),
        torch.where(valid_t, alb[:, 1], 0.0),
        torch.where(valid_t, alb[:, 2], 1.0),
    )
    dh_du_raw = torch.where(valid_b, grd[:, 0], 0.0)
    dh_dv_raw = torch.where(valid_b, grd[:, 1], 0.0)
    return tex_rgb, dh_du_raw, dh_dv_raw


def sample_texture(
    tex: TextureTable,
    num_textures: int,
    wmax: int,
    hmax: int,
    tex_id: torch.Tensor,  # i32 per lane (may be out of range)
    uv_u: torch.Tensor,
    uv_v: torch.Tensor,
) -> Vec3:
    """RGB sample at (u, 1-v); magenta for invalid ids (``sampleTexture``,
    ``src/pathtrace.cu:505-512``)."""
    valid = (tex_id >= 0) & (tex_id < num_textures)
    tid = torch.clamp(tex_id, 0, max(num_textures - 1, 0))
    tw = tex.width[tid.long()]
    th = tex.height[tid.long()]
    rows = _bilinear_rows(tex.rgba, tid, uv_u, 1.0 - uv_v, tw, th, wmax, hmax)
    return Vec3(
        torch.where(valid, rows[:, 0], 1.0),
        torch.where(valid, rows[:, 1], 0.0),
        torch.where(valid, rows[:, 2], 1.0),
    )


def sample_height(
    tex: TextureTable,
    num_textures: int,
    wmax: int,
    hmax: int,
    tex_id: torch.Tensor,
    uv_u: torch.Tensor,
    uv_v: torch.Tensor,
) -> torch.Tensor:
    """Height = red channel at (u, 1-v); 0 for invalid ids (``sampleHeight``,
    ``src/pathtrace.cu:515-519``)."""
    valid = (tex_id >= 0) & (tex_id < num_textures)
    tid = torch.clamp(tex_id, 0, max(num_textures - 1, 0))
    tw = tex.width[tid.long()]
    th = tex.height[tid.long()]
    rows = _bilinear_rows(tex.rgba, tid, uv_u, 1.0 - uv_v, tw, th, wmax, hmax)
    return torch.where(valid, rows[:, 0], 0.0)
