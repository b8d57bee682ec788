"""The JAX kernels of ``scripts/profile_epilogue.py`` for the tests of the
port's epilogue variants (``tests/test_torch_epilogue.py``).

The script defines its variant kernels (``lb_asc_kernel``, ``mono_kernel``)
and their ``pallas_call`` wrappers as closures inside ``main()``, where a
test cannot reach them.  ``build`` below holds a verbatim copy of those
functions (``COPIED``), closed over the same names the script gives them;
``test_copied_sources_match_the_script`` compares each copy with the
script's source text, so the copy cannot drift.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from project3_cuda_path_tracer_2025_tpu.ops import intersect_mxu as m

COPIED = ("mt_hit", "resolve", "lb_asc_kernel", "mono_kernel", "call_planned", "lb_asc",
          "lb_mm", "mono_call")


def ray_features(os_, d, live, tl, n_pad):
    """The script's ``build_rayf`` in numpy float32 (each product and
    difference rounded on its own): recentred origins ``os_`` [n, 3],
    directions ``d`` [n, 3], ``live`` [n] bool, ``tl`` [n] -> (rayf [n_pad,
    16], tlim [n_pad, 1])."""
    n = os_.shape[0]
    pad = lambda x, f=0.0: np.concatenate([x, np.full((n_pad - n,), f, np.float32)])
    osx, osy, osz = (pad(os_[:, a].astype(np.float32)) for a in range(3))
    dxp, dyp, dzp = (pad(d[:, a].astype(np.float32)) for a in range(3))
    one = pad(live.astype(np.float32))
    zero = np.zeros_like(one)
    rayf = np.stack(
        [
            dxp * one, dyp * one, dzp * one,
            (osy * dzp - osz * dyp) * one,
            (osz * dxp - osx * dzp) * one,
            (osx * dyp - osy * dxp) * one,
            osx * one, osy * one, osz * one,
            one, zero, zero, zero, zero, zero, zero,
        ],
        axis=1,
    ).astype(np.float32)
    return rayf, pad(tl.astype(np.float32), np.float32(3.4e38))[:, None]


def build(features, tile_aabb, tlim, ids_asc, cnt, eps, interpret=True):
    """The script's variants over the given tables, padded t_limits [n_pad,
    1] and ascending plan: name -> function of ``rayf`` [n_pad, 16] giving
    (t [n_pad, 1], tri [n_pad, 1])."""
    R, T, NF = m.RAY_TILE, m.TRI_TILE, m.NUM_F
    feat, aabb = jnp.asarray(features), jnp.asarray(tile_aabb)
    tlim, ids_asc, cnt = jnp.asarray(tlim), jnp.asarray(ids_asc), jnp.asarray(cnt)
    ct = aabb.shape[0]
    n_pad = tlim.shape[0]
    nb = n_pad // R
    eps_succ = float(np.nextafter(np.float32(eps), np.float32(np.inf)))
    grid = (nb,)
    out_shape = (
        jax.ShapeDtypeStruct((n_pad, 1), jnp.float32),
        jax.ShapeDtypeStruct((n_pad, 1), jnp.int32),
    )
    vm = functools.partial(pl.BlockSpec, memory_space=pltpu.VMEM)

    def mt_hit(rayf, feat_block, t_lo, t_hi):
        """The shared MT quad epilogue -> (hit, tt). Expression-identical
        to _walk_quad_epilogue (bit-identity; see that docstring)."""
        quad = jnp.dot(rayf, feat_block, preferred_element_type=jnp.float32)
        det = quad[:, 0 * T : 1 * T]
        u_num = quad[:, 1 * T : 2 * T]
        v_num = quad[:, 2 * T : 3 * T]
        t_num = quad[:, 3 * T : 4 * T]
        det_ok = jnp.abs(det) >= eps
        inv_det = 1.0 / jnp.where(det_ok, det, 1.0)
        tt = t_num * inv_det
        s = jnp.where(det < 0.0, -1.0, 1.0)
        us = u_num * s
        vs = v_num * s
        da = det * s
        hit = (
            det_ok
            & (us >= 0.0)
            & (vs >= 0.0)
            & (us + vs <= da)
            & (tt >= t_lo)
            & (tt <= t_hi)
        )
        return hit, tt

    def resolve(lane_t, lane_tile, tlim, lane):
        row_min = jnp.min(lane_t, axis=1, keepdims=True)
        hitrow = row_min < tlim
        tri_lane = lane_tile * T + lane
        masked = jnp.where(
            lane_t <= row_min, tri_lane, jnp.int32(0x7FFFFFFF)
        )
        tri = jnp.min(masked, axis=1, keepdims=True)
        return (
            jnp.where(hitrow, row_min, tlim),
            jnp.where(hitrow, tri, -1),
        )

    def lb_asc_kernel(
        mm_only, ids_ref, cnt_ref, rayf_ref, tlim_ref, feat_ref, aabb_ref,
        out_t_ref, out_tri_ref,
    ):
        b = pl.program_id(0)
        rayf = rayf_ref[:]
        o = rayf[:, 6:9]
        dvec = rayf[:, 0:3]
        inv = 1.0 / jnp.where(dvec == 0.0, 1e-20, dvec)
        lane = jax.lax.broadcasted_iota(jnp.int32, (R, T), 1)
        tlim = tlim_ref[:]

        def body(t, carry):
            lane_t, lane_tile = carry
            tile_id = ids_ref[b * ct + t]
            cols = pl.ds(pl.multiple_of(tile_id * (4 * T), 4 * T), 4 * T)
            if mm_only:
                quad = jnp.dot(
                    rayf, feat_ref[:, cols],
                    preferred_element_type=jnp.float32,
                )
                return (
                    jnp.minimum(lane_t, quad[:, 0:T]),
                    lane_tile,
                )
            row = aabb_ref[pl.ds(tile_id, 1), :]
            member, s_tlo, s_thi = m._member_slab(row, o, inv, tlim)
            t_lo = jnp.where(member, jnp.maximum(s_tlo, eps_succ), jnp.inf)
            t_hi = jnp.where(member, s_thi, -jnp.inf)
            hit, tt = mt_hit(rayf, feat_ref[:, cols], t_lo, t_hi)
            cand = jnp.where(hit, tt, jnp.inf)
            upd = cand < lane_t
            return (
                jnp.where(upd, cand, lane_t),
                jnp.where(upd, tile_id, lane_tile),
            )

        lane_t, lane_tile = jax.lax.fori_loop(
            0, cnt_ref[b], body,
            (
                jnp.full((R, T), jnp.inf, jnp.float32),
                jnp.full((R, T), jnp.int32(1 << 30), jnp.int32),
            ),
        )
        out_t_ref[:], out_tri_ref[:] = resolve(lane_t, lane_tile, tlim, lane)

    def mono_kernel(
        flavor, rayf_ref, tlim_ref, feat_ref, aabb_ref, out_t_ref,
        out_tri_ref,
    ):
        rayf = rayf_ref[:]
        o = rayf[:, 6:9]
        dvec = rayf[:, 0:3]
        inv = 1.0 / jnp.where(dvec == 0.0, 1e-20, dvec)
        lane = jax.lax.broadcasted_iota(jnp.int32, (R, T), 1)
        tlim = tlim_ref[:]
        live_col = rayf[:, 9:10] > 0.0

        @pl.when(jnp.any(live_col))
        def _():
            lane_t = jnp.full((R, T), jnp.inf, jnp.float32)
            lane_tile = jnp.full((R, T), jnp.int32(1 << 30), jnp.int32)
            for c in range(ct):
                row = aabb_ref[c : c + 1, :]
                member, s_tlo, s_thi = m._member_slab(row, o, inv, tlim)
                t_lo = jnp.where(
                    member, jnp.maximum(s_tlo, eps_succ), jnp.inf
                )
                t_hi = jnp.where(member, s_thi, -jnp.inf)

                def tile_eval(lane_t, lane_tile, t_lo=t_lo, t_hi=t_hi, c=c):
                    if flavor == "mm":
                        quad = jnp.dot(
                            rayf, feat_ref[:, c * 4 * T : (c + 1) * 4 * T],
                            preferred_element_type=jnp.float32,
                        )
                        return jnp.minimum(lane_t, quad[:, 0:T]), lane_tile
                    hit, tt = mt_hit(
                        rayf, feat_ref[:, c * 4 * T : (c + 1) * 4 * T],
                        t_lo, t_hi,
                    )
                    cand = jnp.where(hit, tt, jnp.inf)
                    upd = cand < lane_t
                    return (
                        jnp.where(upd, cand, lane_t),
                        jnp.where(upd, jnp.int32(c), lane_tile),
                    )

                if flavor == "gate":
                    lane_t, lane_tile = jax.lax.cond(
                        jnp.any(member & live_col),
                        lambda args, te=tile_eval: te(*args),
                        lambda args: args,
                        (lane_t, lane_tile),
                    )
                else:
                    lane_t, lane_tile = tile_eval(lane_t, lane_tile)
            out_t_ref[:], out_tri_ref[:] = resolve(
                lane_t, lane_tile, tlim, lane
            )

        @pl.when(jnp.logical_not(jnp.any(live_col)))
        def _():
            out_t_ref[:] = tlim_ref[:]
            out_tri_ref[:] = jnp.full((R, 1), -1, jnp.int32)

    def call_planned(kern, nsp, *operands):
        grid_spec = pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=nsp,
            grid=grid,
            in_specs=[
                vm((R, NF), lambda i, *_: (i, 0)),
                vm((R, 1), lambda i, *_: (i, 0)),
                vm(feat.shape, lambda i, *_: (0, 0)),
                vm(aabb.shape, lambda i, *_: (0, 0)),
            ],
            out_specs=(
                vm((R, 1), lambda i, *_: (i, 0)),
                vm((R, 1), lambda i, *_: (i, 0)),
            ),
        )
        return pl.pallas_call(
            kern, grid_spec=grid_spec, out_shape=out_shape,
            interpret=interpret,
        )(*operands)

    def lb_asc(rf):
        return call_planned(
            functools.partial(lb_asc_kernel, False),
            2, ids_asc, cnt, rf, tlim, feat, aabb,
        )

    def lb_mm(rf):
        return call_planned(
            functools.partial(lb_asc_kernel, True),
            2, ids_asc, cnt, rf, tlim, feat, aabb,
        )

    def mono_call(flavor):
        def f(rf):
            return pl.pallas_call(
                functools.partial(mono_kernel, flavor),
                grid=grid,
                in_specs=[
                    vm((R, NF), lambda i: (i, 0)),
                    vm((R, 1), lambda i: (i, 0)),
                    vm(feat.shape, lambda i: (0, 0)),
                    vm(aabb.shape, lambda i: (0, 0)),
                ],
                out_specs=(
                    vm((R, 1), lambda i: (i, 0)),
                    vm((R, 1), lambda i: (i, 0)),
                ),
                out_shape=out_shape,
                interpret=interpret,
            )(rf, tlim, feat, aabb)

        return f

    return {
        "lb_asc": lb_asc, "lb_mm": lb_mm, "mono": mono_call("full"),
        "mono_gate": mono_call("gate"), "mono_mm": mono_call("mm"),
    }
