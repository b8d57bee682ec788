"""BSDF sampling library.

Exact-math parity with ``src/interactions.cu`` / ``src/interactions.h``:
cosine-weighted diffuse via concentric disk (``squareToDiskConcentric``
``:49-75``, ``squareToHemisphereCosine`` ``:77-81``), perfect mirror
(``:111-118``), specular transmission with glm::refract + TIR sentinel
(``:146-168``), Fresnel-dielectric glass (``:173-235``), and Cook-Torrance
GGX/Trowbridge-Reitz microfacet (``:238-435``).

Every function is a dense tensor op over [N] lanes, the JAX package's
``ops/bsdf.py`` operation for operation; ``csrc/prim_path.cuh`` spells the
same arithmetic per ray.  The per-material selection happens in
``ops.shade``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import vec
from ..utils.mathutil import INV_PI, PI, PI_OVER_FOUR, PI_OVER_TWO, TWO_PI
from ..utils.vec import Vec3, f32

# ``x / PI`` is ``x * (1/PI)`` with the reciprocal taken in float32: XLA
# rewrites a division by a constant that way, and so does PyTorch on CUDA
# for a division by a scalar.  Spelled out, it rounds the same on the CPU,
# on the card and in the kernels.
RCP_PI = float(np.float32(1.0) / np.float32(PI))


def _pow5(x):
    """``x ** 5`` as ``lax.integer_pow`` evaluates it: x * ((x*x) * (x*x))."""
    x2 = x * x
    return x * (x2 * x2)


# ---------------------------------------------------------------------------
# Local frame (interactions.h:14-32)
# ---------------------------------------------------------------------------

def coordinate_system(n: Vec3) -> tuple[Vec3, Vec3]:
    """Tangent/bitangent basis from a normal (interactions.h:14-20)."""
    use_x = torch.abs(n.x) > torch.abs(n.y)
    inv_a = 1.0 / torch.sqrt(
        torch.where(use_x, n.x * n.x + n.z * n.z, n.y * n.y + n.z * n.z)
    )
    zero = torch.zeros_like(n.x)
    tan = Vec3(
        torch.where(use_x, -n.z * inv_a, zero),
        torch.where(use_x, zero, n.z * inv_a),
        torch.where(use_x, n.x * inv_a, -n.y * inv_a),
    )
    bit = vec.cross(n, tan)
    return tan, bit


def local_to_world(n: Vec3, w_local: Vec3) -> Vec3:
    """mat3(tan, bit, nor) * w (interactions.h:22-27)."""
    tan, bit = coordinate_system(n)
    return tan * w_local.x + bit * w_local.y + n * w_local.z


def world_to_local(n: Vec3, w_world: Vec3) -> Vec3:
    """Transpose of local_to_world (interactions.h:30-32)."""
    tan, bit = coordinate_system(n)
    return Vec3(vec.dot(tan, w_world), vec.dot(bit, w_world), vec.dot(n, w_world))


# ---------------------------------------------------------------------------
# Warping (interactions.cu:49-85)
# ---------------------------------------------------------------------------

def square_to_disk_concentric(xi0, xi1) -> tuple[torch.Tensor, torch.Tensor]:
    a = 2.0 * xi0 - 1.0
    b = 2.0 * xi1 - 1.0
    a_wins = (a * a) > (b * b)
    safe_a = torch.where(a == 0.0, 1.0, a)
    safe_b = torch.where(b == 0.0, 1.0, b)
    radius = torch.where(a_wins, a, b)
    theta = torch.where(
        a_wins,
        PI_OVER_FOUR * (b / safe_a),
        PI_OVER_TWO - PI_OVER_FOUR * (a / safe_b),
    )
    # Degenerate center: the reference guards xi == (0,0); a == b == 0
    # (where its b/a would be 0/0) is guarded too, to keep the film finite.
    center = (a == 0.0) & (b == 0.0)
    x = torch.where(center, 0.0, radius * torch.cos(theta))
    y = torch.where(center, 0.0, radius * torch.sin(theta))
    return x, y


def square_to_hemisphere_cosine(xi0, xi1) -> Vec3:
    dx, dy = square_to_disk_concentric(xi0, xi1)
    z = torch.sqrt(torch.clamp_min(1.0 - dx * dx - dy * dy, 0.0))
    return Vec3(dx, dy, z)


def hemisphere_cosine_pdf(w_local: Vec3) -> torch.Tensor:
    return w_local.z * RCP_PI


# ---------------------------------------------------------------------------
# Fresnel (interactions.cu:173-201)
# ---------------------------------------------------------------------------

def fresnel_dielectric_eval(cos_theta_i, ior):
    """FresnelDielectricEval (interactions.cu:173-194)."""
    cos_i = torch.clamp(cos_theta_i, -1.0, 1.0)
    swap = cos_i > 0.0
    one = torch.ones_like(cos_i)
    eta_i = torch.where(swap, ior, one)
    eta_t = torch.where(swap, one, ior)
    cos_i = torch.abs(cos_i)

    sin_i = torch.sqrt(torch.clamp_min(1.0 - cos_i * cos_i, 0.0))
    sin_t = eta_i / eta_t * sin_i
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin_t * sin_t, 0.0))
    r_parl = (eta_t * cos_i - eta_i * cos_t) / (eta_t * cos_i + eta_i * cos_t)
    r_perp = (eta_i * cos_i - eta_t * cos_t) / (eta_i * cos_i + eta_t * cos_t)
    return (r_parl * r_parl + r_perp * r_perp) * 0.5


def fresnel_schlick(cos_theta, f0: Vec3) -> Vec3:
    """F0 + (1 - F0) * (1 - cos)^5 (interactions.cu:197-201)."""
    p = _pow5(1.0 - cos_theta)
    return f0 + (1.0 - f0) * p


# ---------------------------------------------------------------------------
# Lobe samplers. Each returns what scatterRay needs to apply the bounce.
# ---------------------------------------------------------------------------

class LobeSample(NamedTuple):
    wi: Vec3  # new world direction (normalized by the caller, as scatterRay does)
    f: Vec3  # bsdf value (meaning varies by lobe, as in the reference)
    pdf: torch.Tensor


def sample_f_diffuse(albedo: Vec3, normal: Vec3, xi0, xi1) -> LobeSample:
    """sampleFDiffuse (interactions.cu:92-108)."""
    wi_local = square_to_hemisphere_cosine(xi0, xi1)
    wi = vec.normalize(local_to_world(normal, wi_local))
    pdf = hemisphere_cosine_pdf(wi_local)
    return LobeSample(wi=wi, f=albedo * INV_PI, pdf=pdf)


def sample_f_specular_reflection(albedo: Vec3, normal: Vec3, wo: Vec3) -> LobeSample:
    """sampleFSpecularRefl (interactions.cu:111-118); wo = incoming ray dir."""
    wi = vec.reflect(wo, normal)
    return LobeSample(wi=wi, f=albedo, pdf=torch.ones_like(wi.x))


def sample_f_specular_transmission(
    albedo: Vec3, normal: Vec3, wo: Vec3, ior, baby_eps: float
) -> tuple[LobeSample, torch.Tensor]:
    """sampleFSpecularTrans (interactions.cu:146-168).

    Returns (sample, tir_mask); on TIR the reference reflects and returns a
    BLACK bsdf (vec3(0)).
    """
    entering = vec.dot(wo, normal) < 0.0
    eta = torch.where(entering, 1.0 / ior, ior)
    out_normal = vec.where(entering, normal, -normal)
    wt = vec.refract(vec.normalize(wo), vec.normalize(out_normal), eta)
    tir = vec.length(wt) < f32(baby_eps)
    wi = vec.where(tir, vec.reflect(wo, normal), wt)
    zero = torch.zeros_like(wi.x)
    f = vec.where(tir, Vec3(zero, zero, zero), albedo)
    return LobeSample(wi=wi, f=f, pdf=torch.ones_like(wi.x)), tir


def sample_f_glass(
    albedo: Vec3, normal: Vec3, wo: Vec3, ior, u_choice, baby_eps: float
) -> LobeSample:
    """sampleFGlass (interactions.cu:204-235): Fresnel Russian-roulette
    between mirror reflection and transmission; TIR also reflects.  The
    returned bsdf is albedo in every branch."""
    cos_theta = vec.dot(wo, normal)
    fresnel = fresnel_dielectric_eval(cos_theta, ior)
    trans, tir = sample_f_specular_transmission(albedo, normal, wo, ior, baby_eps)
    reflect_mask = (u_choice < fresnel) | tir
    wi = vec.where(reflect_mask, vec.reflect(wo, normal), trans.wi)
    return LobeSample(wi=wi, f=albedo, pdf=torch.ones_like(wi.x))


# ---------------------------------------------------------------------------
# Cook-Torrance microfacet (interactions.cu:238-435)
# ---------------------------------------------------------------------------

def _trowbridge_reitz_d(wh: Vec3, roughness) -> torch.Tensor:
    """TrowbridgeReitzD (interactions.cu:266-281); isotropic so the Cos2Phi /
    Sin2Phi terms collapse to tan2/roughness^2."""
    cos2 = wh.z * wh.z
    sin2 = torch.clamp_min(1.0 - cos2, 0.0)
    # tan2 = sin2/cos2; cos2 == 0 -> inf -> reference returns 0.
    safe_cos2 = torch.where(cos2 == 0.0, 1.0, cos2)
    tan2 = sin2 / safe_cos2
    cos4 = cos2 * cos2
    r2 = roughness * roughness
    e = tan2 / r2
    d = 1.0 / (PI * r2 * cos4 * (1.0 + e) * (1.0 + e))
    return torch.where(cos2 == 0.0, 0.0, d)


def _lambda(w: Vec3, roughness) -> torch.Tensor:
    """lambda (interactions.cu:283-295)."""
    cos2 = w.z * w.z
    sin2 = torch.clamp_min(1.0 - cos2, 0.0)
    safe_cos = torch.where(cos2 == 0.0, 1.0, torch.abs(w.z))
    abs_tan = torch.sqrt(sin2) / safe_cos
    rt = roughness * abs_tan
    lam = (-1.0 + torch.sqrt(1.0 + rt * rt)) * 0.5
    return torch.where(cos2 == 0.0, 0.0, lam)  # isinf(tan) -> 0


def _trowbridge_reitz_g(wo: Vec3, wi: Vec3, roughness) -> torch.Tensor:
    return 1.0 / (1.0 + _lambda(wo, roughness) + _lambda(wi, roughness))


def _sample_wh(wo_local: Vec3, roughness, xi0, xi1) -> Vec3:
    """sampleWH (interactions.cu:238-264)."""
    phi = TWO_PI * xi1
    denom = torch.clamp_min(1.0 - xi0, f32(1e-12))
    tan2 = roughness * roughness * xi0 / denom
    cos_t = 1.0 / torch.sqrt(1.0 + tan2)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    wh = Vec3(sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t)
    same_hemi = (wo_local.z * wh.z) > 0.0
    return vec.where(same_hemi, wh, -wh)


def _f_microfacet_refl(
    albedo: Vec3, wo: Vec3, wi: Vec3, roughness, metallic
) -> Vec3:
    """fMicrofacetRefl (interactions.cu:314-348); all in the local frame."""
    cos_o = torch.abs(wo.z)
    cos_i = torch.abs(wi.z)
    wh = wi + wo
    wh_len = vec.length(wh)
    degenerate = (cos_i == 0.0) | (cos_o == 0.0) | (wh_len == 0.0)
    wh = wh / torch.where(wh_len == 0.0, 1.0, wh_len)

    f0 = vec.lerp(Vec3(0.04, 0.04, 0.04), albedo, metallic)
    f = fresnel_schlick(vec.dot(wi, wh), f0)
    d = _trowbridge_reitz_d(wh, roughness)
    g = _trowbridge_reitz_g(wo, wi, roughness)
    denom = torch.where(degenerate, 1.0, 4.0 * cos_i * cos_o)
    spec = f * (d * g / denom)
    zero = torch.zeros_like(wo.x)
    return vec.where(degenerate, Vec3(zero, zero, zero), spec)


def sample_f_cook_torrance(
    albedo: Vec3,
    normal: Vec3,
    wo_world: Vec3,  # -ray.direction, normalized
    roughness,
    metallic,
    u_choice,
    xi0,
    xi1,
) -> LobeSample:
    """sampleFCookTorrance (interactions.cu:383-435): Fresnel-weighted lobe
    choice between the GGX specular lobe and cosine diffuse."""
    f0 = vec.lerp(Vec3(0.04, 0.04, 0.04), albedo, metallic)
    cos_theta = torch.clamp(vec.dot(normal, wo_world), 0.0, 1.0)
    f = fresnel_schlick(cos_theta, f0)
    f_prob = torch.clamp(vec.max_component(f), 0.0, 1.0)
    choose_spec = u_choice < f_prob

    # --- specular lobe (sampleFMicrofacetRefl, interactions.cu:350-380) ----
    wo_local = world_to_local(normal, wo_world)
    wh = _sample_wh(wo_local, roughness, xi0, xi1)
    wh = vec.where(wh.z < 0.0, -wh, wh)
    wi_local = vec.reflect(-wo_local, wh)
    wi_spec = vec.normalize(local_to_world(normal, wi_local))
    dot_wo_wh = torch.clamp_min(vec.dot(wo_local, wh), f32(1e-6))
    pdf_spec = _trowbridge_reitz_d(wh, roughness) * torch.abs(wh.z) / (4.0 * dot_wo_wh)
    bsdf_spec = _f_microfacet_refl(albedo, wo_local, wi_local, roughness, metallic)

    # --- diffuse lobe ------------------------------------------------------
    diff = sample_f_diffuse(albedo, normal, xi0, xi1)

    wi = vec.where(choose_spec, wi_spec, diff.wi)
    bsdf = vec.where(choose_spec, bsdf_spec * f, diff.f * (1.0 - f))
    pdf = torch.where(choose_spec, f_prob * pdf_spec, (1.0 - f_prob) * diff.pdf)
    return LobeSample(wi=wi, f=bsdf, pdf=pdf)
