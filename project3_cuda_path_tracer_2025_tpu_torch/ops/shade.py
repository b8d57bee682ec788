"""Shading: texture/bump lookup + BSDF scatter, one dense masked pass over
all rays.

Parity with ``kernShadeMaterialProper`` (``src/pathtrace.cu:521-621``) +
``scatterRay`` (``src/interactions.cu:438-542``):

* entry skip for terminated paths (keeps their final color),
* miss -> color = 0, terminate,
* texture albedo override before the emissive test,
* emissive -> color *= albedo * emittance, terminate,
* bump-map shading-normal perturbation (forward-difference heightfield,
  ``src/pathtrace.cu:579-607``),
* material dispatch priority: glass > mirror > transmissive > microfacet >
  diffuse (``src/interactions.cu:455-528``),
* ray-offset epsilons: BABY_EPSILON along the normal for diffuse/mirror,
  LARGER_EPSILON along the new direction for glass/transmissive/microfacet,
* paths that exhaust their bounces keep (and later deposit) their throughput
  -- a deliberate reference behavior kept for image parity.

Every lane evaluates every lobe the scene uses and selects by mask, as in
the JAX package; the kernels in ``csrc/prim_path.cuh`` branch per ray to the
one lobe it selects, which computes the same values.  Texture sampling and
the bump normal (``textured_surface``) stay torch on the card, as they are
XLA in the JAX package.
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from ..scene.device import DeviceScene, SceneStatic
from ..utils import vec
from ..utils.vec import Vec3, f32
from . import bsdf, texture
from .rays import Intersections, PathState


# The lobes of ``scatterRay`` in the order it tests them: a material scatters
# by the first it selects (``lobe_masks``), else by the diffuse.  The columns
# of a lobe tally (``lobe_tally``, ``csrc/prim_path.cuh``'s ``PTT_LOBE_*``).
LOBES = ("glass", "mirror", "transmissive", "microfacet", "diffuse")


def lobes_present(static: SceneStatic) -> tuple:
    """Static per-scene lobe presence (glass, mirror, trans, micro): lobe
    families no material uses are skipped entirely."""
    ms = static.material_consts
    glass = any(m.has_reflective > 0 and m.has_refractive > 0 for m in ms)
    mirror = any(m.has_reflective > 0 for m in ms)
    trans = any(m.has_refractive > 0 for m in ms)
    micro = any(m.roughness >= 0 and m.metallic >= 0 for m in ms)
    return (glass, mirror, trans, micro)


def shade_fake(
    dev: DeviceScene,
    static: SceneStatic,
    paths: PathState,
    isect: Intersections,
    uniforms: torch.Tensor,
    cfg: RenderConfig,
) -> PathState:
    """The reference's demo shader (``shadeFakeMaterial``,
    ``src/pathtrace.cu:459-502``): rasterizer-style pseudo-lighting with
    multiplicative noise; no BSDF, no scattering, no bounce decrement."""
    mats = dev.materials
    hit = isect.t > 0.0
    mid = torch.clamp(isect.material_id, 0, static.num_materials - 1).long()
    mat_color = vec.select_gather(mats.color, mid)
    emittance = mats.emittance[mid]

    light_term = vec.dot(isect.normal, Vec3(0.0, 1.0, 0.0))
    lit = mat_color * (light_term * 0.3) + mat_color * ((1.0 - isect.t * 0.02) * 0.7)
    noise = uniforms[0]
    emissive = emittance > 0.0
    shaded = vec.where(emissive, mat_color * emittance, lit * noise)

    zero = torch.zeros_like(hit, dtype=torch.float32)
    color = vec.where(hit, paths.color * shaded, Vec3(zero, zero, zero))
    return PathState(
        origin=paths.origin,
        direction=paths.direction,
        color=color,
        pixel=paths.pixel,
        bounces=paths.bounces,
    )


def textured_surface(
    dev: DeviceScene,
    static: SceneStatic,
    isect: Intersections,
    mid: torch.Tensor,  # clipped material id per lane
    albedo: Vec3,  # base (material-color) albedo per lane
    live: torch.Tensor = None,  # lanes whose shade result is consumed
):
    """Texture albedo override + bump-map shading normal for one lane set.

    Shared by the unfused ``shade``, the fused mesh bounce's surface stage
    and the textured-prim bounce (the same formulas, so the integrators
    agree bit for bit).  Dead lanes (``live`` False) gather texel row 0.
    Returns ``(albedo, shading_normal)``.  A bump map on a surface with zero
    tangents (an analytic prim) normalizes a zero vector, as the JAX package
    does (``vec.normalize`` has no epsilon)."""
    ms = static.material_consts
    device = mid.device

    # Python scalars, not device tensors: building a tensor from a host value
    # per select would be a synchronizing host-to-device copy.
    def chain(get, dtype=torch.float32):
        out = torch.full(mid.shape, get(ms[0]), dtype=dtype, device=device)
        for i in range(1, len(ms)):
            out = torch.where(mid == i, get(ms[i]), out)
        return out

    # Per-lane texture and bump ids, bump scale and texture dims as constant
    # select chains (materials and texture dims are static).
    tex_id = chain(lambda m: m.texture_id, torch.int32)
    bump_id = chain(lambda m: m.bump_id, torch.int32)
    scale = chain(lambda m: f32(m.bump_scale))

    dims = static.tex_dims or ((1, 1),)

    def dim_chain(idv, axis):
        out = torch.full(idv.shape, dims[0][axis], dtype=torch.int32, device=device)
        for i in range(1, len(dims)):
            out = torch.where(idv == i, dims[i][axis], out)
        return out

    nt = static.num_textures
    tid = torch.clamp(tex_id, 0, max(nt - 1, 0))
    bid = torch.clamp(bump_id, 0, max(nt - 1, 0))
    tw_t, th_t = dim_chain(tid, 0), dim_chain(tid, 1)
    tw_b, th_b = dim_chain(bid, 0), dim_chain(bid, 1)
    du = 1.0 / tw_b.to(torch.float32)
    dv = 1.0 / th_b.to(torch.float32)

    # Texel-quad gather(s): albedo + precomputed bump gradients
    # (src/pathtrace.cu:549-553 texture override; :579-607 bump heights).
    # When no material pairs a texture with a different bump map (static
    # per scene), both come from one packed-row gather.
    single_quad = all(
        m.texture_id < 0 or m.bump_id < 0 or m.texture_id == m.bump_id for m in ms
    )
    tex_rgb, gdu_raw, gdv_raw = texture.sample_surface(
        dev.textures, nt, static.tex_wmax, static.tex_hmax,
        tex_id, bump_id, isect.uv_u, isect.uv_v,
        tw_t, th_t, tw_b, th_b, live=live, single_quad=single_quad,
    )
    albedo = vec.where(tex_id >= 0, tex_rgb, albedo)

    # Shading normal: bump-map perturbation.
    ng = isect.normal
    has_bump = bump_id >= 0
    dhdu = gdu_raw / du
    dhdv = gdv_raw / dv
    dpdu_p = isect.dpdu + ng * (scale * dhdu)
    dpdv_p = isect.dpdv + ng * (scale * dhdv)
    sn = vec.normalize(vec.cross(dpdu_p, dpdv_p))
    sn = vec.where(vec.dot(sn, ng) < 0.0, -sn, sn)
    shading_normal = vec.where(has_bump, sn, ng)
    return albedo, shading_normal


def shade(
    dev: DeviceScene,
    static: SceneStatic,
    paths: PathState,
    isect: Intersections,
    uniforms: torch.Tensor,  # [3, N] U[0,1)
    cfg: RenderConfig,
) -> PathState:
    if cfg.shader == "fake":
        return shade_fake(dev, static, paths, isect, uniforms, cfg)
    mats = dev.materials
    mid = torch.clamp(isect.material_id, 0, static.num_materials - 1).long()
    albedo = vec.select_gather(mats.color, mid)
    shading_normal = isect.normal
    if static.num_textures > 0:
        albedo, shading_normal = textured_surface(
            dev, static, isect, mid, albedo, live=paths.alive & (isect.t > 0.0)
        )
    return scatter_compose(
        cfg,
        paths,
        isect,
        shading_normal,
        albedo,
        mats.emittance[mid],
        mats.has_reflective[mid],
        mats.has_refractive[mid],
        mats.ior[mid],
        mats.roughness[mid],
        mats.metallic[mid],
        uniforms,
        lobes=lobes_present(static),
    )


def lobe_masks(has_refl: torch.Tensor, has_refr: torch.Tensor, roughness: torch.Tensor,
               metallic: torch.Tensor, lobes: tuple) -> tuple:
    """(is_glass, is_mirror, is_trans, is_micro): the lobe each lane's
    material selects, at most one (diffuse where none); a lobe that
    ``lobes`` (``lobes_present``) leaves out is never selected."""
    lobe_glass, lobe_mirror, lobe_trans, lobe_micro = lobes
    false = torch.zeros_like(has_refl, dtype=torch.bool)
    is_glass = (has_refr > 0.0) & (has_refl > 0.0) if lobe_glass else false
    is_mirror = ((has_refl > 0.0) & ~is_glass) if lobe_mirror else false
    is_trans = (
        (has_refr > 0.0) & ~is_glass & ~is_mirror if lobe_trans else false
    )
    is_micro = (
        (roughness >= 0.0) & (metallic >= 0.0)
        & ~is_glass & ~is_mirror & ~is_trans
        if lobe_micro
        else false
    )
    return is_glass, is_mirror, is_trans, is_micro


def lobe_tally(paths: PathState, isect: Intersections, emittance: torch.Tensor,
               has_refl: torch.Tensor, has_refr: torch.Tensor, roughness: torch.Tensor,
               metallic: torch.Tensor, lobes: tuple) -> torch.Tensor:
    """[len(LOBES)] int32: the lanes each lobe scatters in this bounce
    (``scatter_compose``'s scatter mask; a miss, a light or a path already
    done scatters none)."""
    scatters = (paths.bounces > 0) & (isect.t > 0.0) & ~(emittance > 0.0)
    masks = lobe_masks(has_refl, has_refr, roughness, metallic, lobes)
    diffuse = ~(masks[0] | masks[1] | masks[2] | masks[3])
    return torch.stack([torch.sum(scatters & m, dtype=torch.int32)
                        for m in (*masks, diffuse)])


def scatter_compose(
    cfg: RenderConfig,
    paths: PathState,
    isect: Intersections,
    shading_normal: Vec3,
    albedo: Vec3,
    emittance: torch.Tensor,
    has_refl: torch.Tensor,
    has_refr: torch.Tensor,
    ior: torch.Tensor,
    roughness: torch.Tensor,
    metallic: torch.Tensor,
    uniforms,  # indexable: uniforms[0..2], each shaped like paths fields
    lobes: tuple = (True, True, True, True),  # (glass, mirror, trans, micro)
) -> PathState:
    """scatterRay + terminal-state composition with material parameters
    already resolved per lane.

    ``lobes`` disables lobe families no material in the scene uses: an
    all-diffuse scene then pays for the diffuse lobe only.  Semantics are
    unchanged -- a disabled lobe's selection mask would be all-False."""
    lobe_glass, lobe_mirror, lobe_trans, lobe_micro = lobes
    was_alive = paths.bounces > 0
    hit = isect.t > 0.0

    # ---- scatter: evaluate present lobes, select by material flags --------
    wo_ray = paths.direction  # reference passes the raw ray direction as wo
    normal = shading_normal
    u_choice = uniforms[0]
    xi0 = uniforms[1]
    xi1 = uniforms[2]

    is_glass, is_mirror, is_trans, is_micro = lobe_masks(
        has_refl, has_refr, roughness, metallic, lobes
    )

    diffuse = bsdf.sample_f_diffuse(albedo, normal, xi0, xi1)

    # New direction (normalized, as scatterRay does for every branch) and
    # throughput multiplier per branch.
    wi = diffuse.wi
    if lobe_micro:
        wo_world = -vec.normalize(wo_ray)
        micro = bsdf.sample_f_cook_torrance(
            albedo, normal, wo_world, roughness, metallic, u_choice, xi0, xi1
        )
        wi = vec.where(is_micro, micro.wi, wi)
    if lobe_trans:
        trans, _ = bsdf.sample_f_specular_transmission(
            albedo, normal, wo_ray, ior, cfg.baby_epsilon
        )
        wi = vec.where(is_trans, trans.wi, wi)
    if lobe_mirror:
        mirror = bsdf.sample_f_specular_reflection(albedo, normal, wo_ray)
        wi = vec.where(is_mirror, mirror.wi, wi)
    if lobe_glass:
        glass = bsdf.sample_f_glass(
            albedo, normal, wo_ray, ior, u_choice, cfg.baby_epsilon
        )
        wi = vec.where(is_glass, glass.wi, wi)
    new_dir = vec.normalize(wi)

    cos_theta = torch.clamp_min(vec.dot(normal, new_dir), 0.0)
    zero = torch.zeros_like(cos_theta)
    # pdf == 0 can occur when the cosine sample lands exactly on the
    # hemisphere rim (a uniform can be 0); the reference divides regardless.
    # Guard to keep the film finite.
    diffuse_pdf_ok = diffuse.pdf > 0.0
    diffuse_mult = vec.where(
        diffuse_pdf_ok,
        diffuse.f * (cos_theta / torch.where(diffuse_pdf_ok, diffuse.pdf, 1.0)),
        Vec3(zero, zero, zero),
    )
    mult = diffuse_mult
    if lobe_micro:
        one = torch.ones_like(cos_theta)
        micro_mult = vec.where(
            micro.pdf > 0.0,
            micro.f * (cos_theta / torch.where(micro.pdf > 0.0, micro.pdf, 1.0)),
            Vec3(one, one, one),  # pdf<=0: color as-is
        )
        mult = vec.where(is_micro, micro_mult, mult)
    if lobe_trans:
        mult = vec.where(is_trans, trans.f, mult)
    if lobe_mirror:
        mult = vec.where(is_mirror, mirror.f, mult)
    if lobe_glass:
        mult = vec.where(is_glass, glass.f, mult)

    # New origin: epsilon offset differs per branch (interactions.cu:458-533).
    intersect_pt = paths.origin + paths.direction * isect.t
    off_normal = intersect_pt + normal * f32(cfg.baby_epsilon)  # diffuse, mirror
    off_dir = intersect_pt + new_dir * f32(cfg.larger_epsilon)  # glass/trans/micro
    new_origin = vec.where(is_glass | is_trans | is_micro, off_dir, off_normal)

    # ---- compose final updates -------------------------------------------
    emissive = emittance > 0.0
    scatter_mask = was_alive & hit & ~emissive
    emit_mask = was_alive & hit & emissive
    miss_mask = was_alive & ~hit

    color = paths.color
    color = vec.where(emit_mask, color * (albedo * emittance), color)
    color = vec.where(miss_mask, Vec3(zero, zero, zero), color)
    color = vec.where(scatter_mask, color * mult, color)

    bounces = paths.bounces
    bounces = torch.where(emit_mask | miss_mask, 0, bounces)
    bounces = torch.where(scatter_mask, bounces - 1, bounces)

    origin = vec.where(scatter_mask, new_origin, paths.origin)
    direction = vec.where(scatter_mask, new_dir, paths.direction)

    return PathState(
        origin=origin,
        direction=direction,
        color=color,
        pixel=paths.pixel,
        bounces=bounces,
    )
