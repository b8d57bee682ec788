"""The plain reference path tracer: what the port must compute, written
again in plain PyTorch from the reference tracer's description.

One path per (pixel, iteration) row: Threefry-2x32 draws keyed by the seed,
the iteration, the depth and the stage (the JAX package's stream layout,
which the port keeps); a jittered pinhole or thin-lens camera ray; then
``depth`` bounces of nearest hit over boxes, spheres and triangles, the
normal turned toward the ray, and an emitter's end or the scatter of
``scatterRay`` (``src/interactions.cu:438-542``): glass (a Fresnel
choice between mirror and refraction), mirror, transmissive (refraction,
total internal reflection reflecting), Cook-Torrance (a Schlick choice
between a GGX specular lobe and the diffuse one) or cosine-weighted
diffuse, in that priority.  A lobe is evaluated only where some material
of the scene uses it, so an all-diffuse scene runs the diffuse lobe alone.
A path that runs out of bounces keeps its throughput, and every path's
final colour is added to its pixel once an iteration.

``dtype`` is the precision of every geometric and shading operation; the
draws are made in float32 and rounded to it, and colours come back in
float32.  float32 is the reference; a lower precision is the control that
the comparison must refuse.  Nothing here reads anything the program made.

``walk_counts`` traces one whole-frame iteration and counts, at each
bounce, the least work of any box-bounded walk over the scene's meshes
(``MeshIndex.walk_count``); ``lobe_counts`` traces one and counts, at each
bounce, the paths each lobe scatters.
"""

from __future__ import annotations

import numpy as np
import torch

from . import scene as scene_mod
from .mesh import MeshIndex

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

PI = 3.1415926535897932384626422832795028841971
TWO_PI = 6.2831853071795864769252867665590057683943
PI_OVER_FOUR = 0.78539816339744831
PI_OVER_TWO = 1.57079632679489662
INV_PI = 0.31830988618379067154
RCP_PI = float(np.float32(1.0) / np.float32(PI))
BABY_EPSILON = 1e-5
LARGER_EPSILON = 1e-3
RAY_EPSILON = 1e-4
DIFFUSE = scene_mod.LOBES.index("diffuse")


def f32(c: float) -> float:
    return float(np.float32(c))


def threefry(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds; ints or int64 tensors holding uint32."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) & M32) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def seed_key(seed: int) -> tuple:
    """The key of a 32-bit signed seed."""
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit in 32 signed bits")
    return (0, seed & M32)


def _fold(key, data):
    return threefry(key[0], key[1], 0 * key[1], data)


def uniforms(key, counters: torch.Tensor) -> torch.Tensor:
    """U[0, 1) in float32 at int64 ``counters`` under per-row keys."""
    y0, y1 = threefry(key[0], key[1], torch.zeros_like(counters), counters & M32)
    mant = (((y0 ^ y1) >> 9) | 0x3F800000).to(torch.int32)
    return torch.clamp_min(mant.view(torch.float32) - 1.0, 0.0)


def _camera_row(cam) -> list:
    """A camera as 16 numbers: position, view, up, right, pixel lengths,
    aperture, focal distance (rounded to float32 where the table is made)."""
    return [*cam.position, *cam.view, *cam.up, *cam.right, *cam.pixel_length,
            cam.aperture, cam.focal_dist]


# -- vectors as (x, y, z) tuples of tensors ----------------------------------

def _add(a, b):
    return tuple(p + q for p, q in zip(a, b))


def _sub(a, b):
    return tuple(p - q for p, q in zip(a, b))


def _scale(a, s):
    return tuple(p * s for p in a)


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def _unit(a):
    inv = 1.0 / torch.sqrt(_dot(a, a))
    return _scale(a, inv)


def _where(mask, a, b):
    return tuple(torch.where(mask, p, q) for p, q in zip(a, b))


def _row(coeffs, terms, bias=None):
    """sum(c * t) over float constants: zero terms dropped, +-1 passed
    through, constants rounded to float32, the bias added last."""
    acc = None
    for c, t in zip(coeffs, terms):
        if c == 0.0:
            continue
        term = t if c == 1.0 else (-t if c == -1.0 else t * f32(c))
        acc = term if acc is None else acc + term
    if bias is not None and bias != 0.0:
        acc = f32(bias) if acc is None else acc + f32(bias)
    return torch.zeros_like(terms[0]) if acc is None else acc


def _point(m, p):
    return tuple(_row(m[i][:3], p, m[i][3]) for i in range(3))


def _vector(m, v):
    return tuple(_row(m[i][:3], v) for i in range(3))


class Tracer:
    """Paths of one scene under one seed, on ``device`` in ``dtype``."""

    def __init__(self, scene: scene_mod.Scene, seed: int, device="cpu",
                 dtype=torch.float32, max_rows: int = 1 << 21):
        self.scene = scene
        self.key = seed_key(seed)
        self.device = torch.device(device)
        self.dtype = dtype
        self.max_rows = max_rows
        self.meshes = [MeshIndex(m, self.device, dtype) for m in scene.meshes]
        self.colors = [tuple(f32(c) for c in m.color) for m in scene.materials]
        self.emittance = [f32(m.emittance) for m in scene.materials]
        self.params = [[f32(getattr(m, k)) for m in scene.materials]
                       for k in ("ior", "roughness", "metallic")]
        self.lobe_of = [scene_mod.LOBES.index(m.lobe) for m in scene.materials]
        self.lobes = [lobe for lobe in scene_mod.LOBES[:DIFFUSE] if lobe in scene.lobes]
        self.walk = None  # a bounce's [rays, pairs, [entered [T] a mesh]] in walk_counts
        self.tally = None  # a bounce's scatters by lobe in lobe_counts

    # -- keys ------------------------------------------------------------------
    def _keys(self, iterations: torch.Tensor):
        """(camera key, [shade key of each depth]) of each row's iteration."""
        its, inverse = torch.unique(iterations, return_inverse=True)
        base = (torch.full_like(its, self.key[0]), torch.full_like(its, self.key[1]))
        ik = _fold(base, its)

        def stage(d, s):
            k = _fold(_fold(ik, torch.full_like(its, d)), torch.full_like(its, s))
            return (k[0][inverse], k[1][inverse])

        return stage(0, 0), [stage(d, 1) for d in range(self.scene.depth)]

    # -- rendering -------------------------------------------------------------
    def radiance(self, cameras: list, pixels: torch.Tensor, iterations: torch.Tensor,
                 camera_index: torch.Tensor = None):
        """Final colour [R, 3] (float32) of each row's path, and the number
        of rows still alive after each bounce [depth].  Row i renders pixel
        ``pixels[i]`` of iteration ``iterations[i]`` through
        ``cameras[camera_index[i]]`` (the first camera by default)."""
        if camera_index is None:
            camera_index = torch.zeros_like(pixels)
        table = torch.tensor([_camera_row(c) for c in cameras], dtype=torch.float32)
        table = table.to(self.device, self.dtype)
        out, alive = [], torch.zeros(self.scene.depth, dtype=torch.int64)
        for s in range(0, pixels.numel(), self.max_rows):
            sl = slice(s, s + self.max_rows)
            c, a = self._radiance(table[camera_index[sl].to(self.device)],
                                  pixels[sl].to(self.device), iterations[sl].to(self.device))
            out.append(c)
            alive += a
        return torch.cat(out).cpu(), alive

    def _radiance(self, cam, pixels, iterations):
        sc, dt = self.scene, self.dtype
        n = sc.pixel_count
        cam_key, shade_keys = self._keys(iterations)
        pix = pixels.to(torch.int64)
        u = [uniforms(cam_key, j * n + pix).to(dt) for j in range(4)]
        origin, direction = self._camera_rays(cam, pix, u)
        rows = pix.numel()
        color = tuple(torch.ones(rows, dtype=dt, device=self.device) for _ in range(3))
        bounces = torch.full((rows,), sc.depth, dtype=torch.int32, device=self.device)
        alive = []
        for d in range(sc.depth):
            live = torch.nonzero(bounces > 0).flatten()
            if live.numel():
                key = (shade_keys[d][0][live], shade_keys[d][1][live])
                su = [uniforms(key, j * n + pix[live]).to(dt) for j in range(3)]
                o = tuple(v[live] for v in origin)
                w = tuple(v[live] for v in direction)
                col = tuple(v[live] for v in color)
                o2, w2, col2, b2 = self._bounce(o, w, col, bounces[live], su, d)
                for full, part in zip(origin + direction + color, o2 + w2 + col2):
                    full[live] = part
                bounces[live] = b2
            alive.append((bounces > 0).sum())
        rgb = torch.stack([c.to(torch.float32) for c in color], dim=1)
        return rgb.cpu(), torch.stack(alive).cpu()

    def _camera_rays(self, cam, pix, u):
        """Jittered rays of per-row cameras ``cam`` [R, 16] (``_camera_row``)."""
        sc = self.scene
        col = lambda i: cam[:, i]
        pos, view, up, right = ((col(i), col(i + 1), col(i + 2)) for i in (0, 3, 6, 9))
        x = (pix % sc.width).to(self.dtype)
        y = torch.div(pix, sc.width, rounding_mode="floor").to(self.dtype)
        sx = col(12) * (x + u[0] - sc.width * 0.5)
        sy = col(13) * (y + u[1] - sc.height * 0.5)
        point = tuple(view[i] - right[i] * sx - up[i] * sy for i in range(3))
        direction = _unit(point)
        focal = tuple(pos[i] + direction[i] * col(15) for i in range(3))
        r = col(14) * torch.sqrt(u[2])
        theta = TWO_PI * u[3]
        origin = (pos[0] + r * torch.cos(theta), pos[1] + r * torch.sin(theta), pos[2].clone())
        return origin, _unit(_sub(focal, origin))

    def _bounce(self, ro, rd, color, bounces, su, depth):
        t, normal, mat = self._nearest(ro, rd, depth)
        hit = t > 0.0
        flip = _dot(rd, normal) > 0.0
        normal = _where(flip, tuple(-c for c in normal), normal)

        albedo = tuple(self._per_material(mat, [c[i] for c in self.colors]) for i in range(3))
        emit = self._per_material(mat, self.emittance)

        # Cosine-weighted hemisphere sample by the concentric disk.
        a, b = 2.0 * su[1] - 1.0, 2.0 * su[2] - 1.0
        a_wins = (a * a) > (b * b)
        radius = torch.where(a_wins, a, b)
        phi = torch.where(
            a_wins, PI_OVER_FOUR * (b / torch.where(a == 0.0, 1.0, a)),
            PI_OVER_TWO - PI_OVER_FOUR * (a / torch.where(b == 0.0, 1.0, b)))
        center = (a == 0.0) & (b == 0.0)
        dx = torch.where(center, 0.0, radius * torch.cos(phi))
        dy = torch.where(center, 0.0, radius * torch.sin(phi))
        dz = torch.sqrt(torch.clamp_min(1.0 - dx * dx - dy * dy, 0.0))
        tan, bit = self._frame(normal)
        wi = _unit(_add(_add(_scale(tan, dx), _scale(bit, dy)), _scale(normal, dz)))
        pdf = dz * RCP_PI
        new_dir = _unit(wi)
        cos_theta = torch.clamp_min(_dot(normal, new_dir), 0.0)
        ok = pdf > 0.0
        ratio = cos_theta / torch.where(ok, pdf, 1.0)
        mult = tuple(torch.where(ok, (c * INV_PI) * ratio, 0.0) for c in albedo)

        point = _add(ro, _scale(rd, t))
        new_origin = _add(point, _scale(normal, f32(BABY_EPSILON)))

        emissive = emit > 0.0
        scatter = hit & ~emissive
        if self.lobes or self.tally is not None:
            lobe = torch.full_like(mat, DIFFUSE)
            for i, index in enumerate(self.lobe_of):
                lobe = torch.where(mat == i, index, lobe)
            if self.lobes:
                new_dir, mult, new_origin = self._lobe_scatter(
                    lobe, mat, rd, normal, (tan, bit), albedo, su, point,
                    (wi, pdf), (new_dir, mult, new_origin))
            if self.tally is not None:
                for i, name in enumerate(scene_mod.LOBES):
                    self.tally[depth][name] += int((scatter & (lobe == i)).sum())
        ends = ~hit | emissive
        zero = torch.zeros_like(t)
        color = _where(hit & emissive, tuple(c * (al * emit) for c, al in zip(color, albedo)),
                       color)
        color = _where(~hit, (zero, zero, zero), color)
        color = _where(scatter, tuple(c * m for c, m in zip(color, mult)), color)
        bounces = torch.where(ends, 0, torch.where(scatter, bounces - 1, bounces))
        return (_where(scatter, new_origin, ro), _where(scatter, new_dir, rd), color,
                bounces)

    def _lobe_scatter(self, lobe, mat, rd, normal, frame, albedo, su, point, diffuse_sample,
                      diffuse):
        """(new direction, throughput multiplier, new origin): the diffuse
        lobe's ``diffuse``, with each lane of another lobe of the scene
        given that lobe's.  ``diffuse_sample``: the diffuse lobe's unit
        direction and pdf, which Cook-Torrance's diffuse side takes."""
        new_dir, mult, new_origin = diffuse
        ior, rough, metal = (self._per_material(mat, v) for v in self.params)
        for name in self.lobes:
            if name == "microfacet":
                d, f = _cook_torrance(albedo, normal, frame, _scale(_unit(rd), -1.0), rough,
                                      metal, su, diffuse_sample)
            else:
                if name == "glass":
                    wi, f = _glass(rd, normal, ior, su[0]), albedo
                elif name == "mirror":
                    wi, f = _reflect(rd, normal), albedo
                else:
                    wi, tir = _transmit(rd, normal, ior)
                    f = tuple(torch.where(tir, 0.0, c) for c in albedo)
                d = _unit(wi)
            # Off the surface by BABY_EPSILON along the normal for the mirror,
            # by LARGER_EPSILON along the new direction for the rest.
            origin = (_add(point, _scale(normal, f32(BABY_EPSILON))) if name == "mirror"
                      else _add(point, _scale(d, f32(LARGER_EPSILON))))
            sel = lobe == scene_mod.LOBES.index(name)
            new_dir, mult, new_origin = (_where(sel, d, new_dir), _where(sel, f, mult),
                                         _where(sel, origin, new_origin))
        return new_dir, mult, new_origin

    @staticmethod
    def _frame(n):
        use_x = torch.abs(n[0]) > torch.abs(n[1])
        inv_a = 1.0 / torch.sqrt(torch.where(use_x, n[0] * n[0] + n[2] * n[2],
                                             n[1] * n[1] + n[2] * n[2]))
        zero = torch.zeros_like(n[0])
        tan = (torch.where(use_x, -n[2] * inv_a, zero), torch.where(use_x, zero, n[2] * inv_a),
               torch.where(use_x, n[0] * inv_a, -n[1] * inv_a))
        return tan, _cross(n, tan)

    def _per_material(self, mat, values):
        out = torch.full(mat.shape, values[0], dtype=self.dtype, device=mat.device)
        for i in range(1, len(values)):
            out = torch.where(mat == i, values[i], out)
        return out

    def lobe_counts(self, camera, iteration: int) -> dict:
        """For each lobe of ``scene.LOBES``: the paths it scatters at each
        bounce of iteration ``iteration`` over the whole frame through
        ``camera`` (a path that misses or ends on a light scatters none)."""
        n = self.scene.pixel_count
        self.tally = [dict.fromkeys(scene_mod.LOBES, 0) for _ in range(self.scene.depth)]
        try:
            self.radiance([camera], torch.arange(n), torch.full((n,), iteration))
            tally = self.tally
        finally:
            self.tally = None
        return {name: [b[name] for b in tally] for name in scene_mod.LOBES}

    # -- intersection ------------------------------------------------------------
    def walk_counts(self, camera, iteration: int) -> list:
        """For each bounce of iteration ``iteration`` over the whole frame
        through ``camera``: [rays alive before it, (ray, triangle) pairs
        whose triangle's own box the ray's segment up to its nearest hit
        enters, distinct triangles entered]."""
        n = self.scene.pixel_count
        self.walk = [[0, 0, [torch.zeros(m.triangles, dtype=torch.bool, device=self.device)
                             for m in self.meshes]] for _ in range(self.scene.depth)]
        try:
            self.radiance([camera], torch.arange(n), torch.full((n,), iteration))
            walk = self.walk
        finally:
            self.walk = None
        return [[rays, pairs, sum(int(m.sum()) for m in seen)] for rays, pairs, seen in walk]

    def _nearest(self, ro, rd, depth):
        """(t [-1: miss], normal toward nowhere in particular, material)."""
        big = torch.finfo(self.dtype).max
        t_min = torch.full_like(ro[0], big)
        hit_any = torch.zeros_like(ro[0], dtype=torch.bool)
        zero = torch.zeros_like(ro[0])
        normal = (zero, zero, zero)
        mat = torch.zeros_like(ro[0], dtype=torch.int32)
        for p in self.scene.prims:
            t, nrm = (_box if p.kind == scene_mod.CUBE else _sphere)(p, ro, rd)
            closer = (t > 0.0) & (t < t_min)
            t_min = torch.where(closer, t, t_min)
            hit_any = hit_any | closer
            normal = _where(closer, nrm, normal)
            mat = torch.where(closer, p.material, mat)
        for index in self.meshes:
            t, nrm = index.nearest(ro, rd, t_min)
            closer = t < t_min
            t_min = torch.where(closer, t, t_min)
            hit_any = hit_any | closer
            normal = _where(closer, nrm, normal)
            mat = torch.where(closer, index.material, mat)
        if self.walk is not None:
            row = self.walk[depth]
            row[0] += ro[0].numel()
            row[1] += sum(index.walk_count(ro, rd, t_min, seen)
                          for index, seen in zip(self.meshes, row[2]))
        return torch.where(hit_any, t_min, -1.0), normal, mat


def _box(p, ro, rd):
    """Unit cube [-0.5, 0.5]^3 in object space: slab test; t is the world
    distance to the hit point set back by the ray epsilon."""
    qo = _point(p.inverse, ro)
    qd = _unit(_vector(p.inverse, rd))
    tmin = torch.full_like(qo[0], -1e38)
    tmax = torch.full_like(qo[0], 1e38)
    zero = torch.zeros_like(qo[0])
    nmin = nmax = (zero, zero, zero)
    for axis in range(3):
        inv = 1.0 / qd[axis]
        t1 = (-0.5 - qo[axis]) * inv
        t2 = (0.5 - qo[axis]) * inv
        ta, tb = torch.minimum(t1, t2), torch.maximum(t1, t2)
        sign = torch.where(t2 < t1, 1.0, -1.0).to(qo[0].dtype)
        n = tuple(sign if i == axis else zero for i in range(3))
        up_min = (ta > 0) & (ta > tmin)
        tmin = torch.where(up_min, ta, tmin)
        nmin = _where(up_min, n, nmin)
        up_max = tb < tmax
        tmax = torch.where(up_max, tb, tmax)
        nmax = _where(up_max, n, nmax)
    hit = (tmax >= tmin) & (tmax > 0)
    inside = tmin <= 0
    t_obj = torch.where(inside, tmax, tmin)
    n_obj = _where(inside, nmax, nmin)
    world = _point(p.transform, _add(qo, _scale(qd, t_obj - f32(RAY_EPSILON))))
    normal = _unit(_vector(p.inv_transpose, n_obj))
    t = torch.sqrt(_dot(_sub(ro, world), _sub(ro, world)))
    return torch.where(hit, t, -1.0), normal


def _sphere(p, ro, rd):
    """Sphere of radius 0.5 in object space."""
    o = _point(p.inverse, ro)
    d = _unit(_vector(p.inverse, rd))
    vd = _dot(o, d)
    radicand = vd * vd - (_dot(o, o) - 0.25)
    sq = torch.sqrt(torch.clamp_min(radicand, 0.0))
    t1, t2 = -vd + sq, -vd - sq
    both_neg = (t1 < 0) & (t2 < 0)
    both_pos = (t1 > 0) & (t2 > 0)
    t_obj = torch.where(both_pos, torch.minimum(t1, t2), torch.maximum(t1, t2))
    hit = (radicand >= 0) & ~both_neg
    local = _add(o, _scale(d, t_obj - f32(RAY_EPSILON)))
    world = _point(p.transform, local)
    normal = _unit(_vector(p.inv_transpose, local))
    t = torch.sqrt(_dot(_sub(ro, world), _sub(ro, world)))
    return torch.where(hit, t, -1.0), normal


# -- the lobes of scatterRay besides the diffuse (src/interactions.cu) ----------

def _reflect(i, n):
    """glm::reflect: i - 2 dot(n, i) n."""
    d = _dot(n, i)
    return _sub(i, _scale(n, 2.0 * d))


def _refract(i, n, eta):
    """glm::refract: the zero vector under total internal reflection."""
    cosi = _dot(n, i)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    kc = torch.sqrt(torch.clamp_min(k, 0.0))
    out = _sub(_scale(i, eta), _scale(n, eta * cosi + kc))
    return tuple(torch.where(k < 0.0, 0.0, c) for c in out)


def _transmit(wo, n, ior):
    """sampleFSpecularTrans (:146-168): refraction with eta 1/IOR entering
    and IOR leaving; under total internal reflection (a refracted vector
    shorter than BABY_EPSILON) a reflection, whose colour is black.
    (direction, reflected)."""
    entering = _dot(wo, n) < 0.0
    eta = torch.where(entering, 1.0 / ior, ior)
    toward = _where(entering, n, _scale(n, -1.0))
    wt = _refract(_unit(wo), _unit(toward), eta)
    tir = torch.sqrt(_dot(wt, wt)) < f32(BABY_EPSILON)
    return _where(tir, _reflect(wo, n), wt), tir


def _fresnel_dielectric(cos_theta_i, ior):
    """FresnelDielectricEval (:173-194): the reflected share of unpolarised
    light, the indices swapped where the cosine is positive."""
    cos_i = torch.clamp(cos_theta_i, -1.0, 1.0)
    swap = cos_i > 0.0
    one = torch.ones_like(cos_i)
    eta_i, eta_t = torch.where(swap, ior, one), torch.where(swap, one, ior)
    cos_i = torch.abs(cos_i)
    sin_i = torch.sqrt(torch.clamp_min(1.0 - cos_i * cos_i, 0.0))
    sin_t = eta_i / eta_t * sin_i
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin_t * sin_t, 0.0))
    r_parl = (eta_t * cos_i - eta_i * cos_t) / (eta_t * cos_i + eta_i * cos_t)
    r_perp = (eta_i * cos_i - eta_t * cos_t) / (eta_i * cos_i + eta_t * cos_t)
    return (r_parl * r_parl + r_perp * r_perp) * 0.5


def _glass(wo, n, ior, u):
    """sampleFGlass (:204-235): the mirror where the bounce's first uniform
    falls under the Fresnel share or the refraction is total, else the
    refraction."""
    fresnel = _fresnel_dielectric(_dot(wo, n), ior)
    wt, tir = _transmit(wo, n, ior)
    return _where((u < fresnel) | tir, _reflect(wo, n), wt)


def _pow5(x):
    x2 = x * x
    return x * (x2 * x2)


def _schlick(cos_theta, f0):
    """Fresnel-Schlick (:197-201): F0 + (1 - F0) (1 - cos)^5."""
    p = _pow5(1.0 - cos_theta)
    return tuple(c + (1.0 - c) * p for c in f0)


def _ggx_d(wh, roughness):
    """TrowbridgeReitzD (:266-281), isotropic; 0 where cos(theta) is 0."""
    cos2 = wh[2] * wh[2]
    sin2 = torch.clamp_min(1.0 - cos2, 0.0)
    tan2 = sin2 / torch.where(cos2 == 0.0, 1.0, cos2)
    cos4 = cos2 * cos2
    r2 = roughness * roughness
    e = tan2 / r2
    d = 1.0 / (PI * r2 * cos4 * (1.0 + e) * (1.0 + e))
    return torch.where(cos2 == 0.0, 0.0, d)


def _ggx_lambda(w, roughness):
    """lambda (:283-295); 0 where tan(theta) is infinite."""
    cos2 = w[2] * w[2]
    sin2 = torch.clamp_min(1.0 - cos2, 0.0)
    abs_tan = torch.sqrt(sin2) / torch.where(cos2 == 0.0, 1.0, torch.abs(w[2]))
    rt = roughness * abs_tan
    lam = (-1.0 + torch.sqrt(1.0 + rt * rt)) * 0.5
    return torch.where(cos2 == 0.0, 0.0, lam)


def _sample_wh(wo, roughness, xi0, xi1):
    """sampleWH (:238-264): a GGX half vector on wo's side, local frame."""
    phi = TWO_PI * xi1
    tan2 = roughness * roughness * xi0 / torch.clamp_min(1.0 - xi0, f32(1e-12))
    cos_t = 1.0 / torch.sqrt(1.0 + tan2)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    wh = (sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t)
    return _where(wo[2] * wh[2] > 0.0, wh, _scale(wh, -1.0))


def _f0(albedo, metallic):
    """mix(0.04, albedo, metallic)."""
    return tuple(0.04 + (c - 0.04) * metallic for c in albedo)


def _microfacet_eval(albedo, wo, wi, roughness, metallic):
    """fMicrofacetRefl (:314-348), local frame: F D G / (4 cos_i cos_o),
    0 where either cosine or the half vector is 0."""
    cos_o, cos_i = torch.abs(wo[2]), torch.abs(wi[2])
    wh = _add(wi, wo)
    wh_len = torch.sqrt(_dot(wh, wh))
    degenerate = (cos_i == 0.0) | (cos_o == 0.0) | (wh_len == 0.0)
    wh = tuple(c / torch.where(wh_len == 0.0, 1.0, wh_len) for c in wh)
    f = _schlick(_dot(wi, wh), _f0(albedo, metallic))
    d = _ggx_d(wh, roughness)
    g = 1.0 / (1.0 + _ggx_lambda(wo, roughness) + _ggx_lambda(wi, roughness))
    denom = torch.where(degenerate, 1.0, 4.0 * cos_i * cos_o)
    return tuple(torch.where(degenerate, 0.0, c * (d * g / denom)) for c in f)


def _cook_torrance(albedo, n, frame, wo, roughness, metallic, su, diffuse_sample):
    """sampleFCookTorrance (:383-435): the GGX specular lobe where the first
    uniform falls under the largest channel of Schlick's F at wo, else the
    diffuse lobe's sample; each weighted by its share of F.  ``wo``: the
    unit direction back along the ray; ``diffuse_sample``: the diffuse
    lobe's unit direction and pdf from the second and third uniforms.
    (unit direction, throughput f cos / pdf; where the pdf is not above 0,
    1: the colour is kept)."""
    f = _schlick(torch.clamp(_dot(n, wo), 0.0, 1.0), _f0(albedo, metallic))
    f_prob = torch.clamp(torch.maximum(f[0], torch.maximum(f[1], f[2])), 0.0, 1.0)
    specular = su[0] < f_prob

    tan, bit = frame
    wo_local = (_dot(tan, wo), _dot(bit, wo), _dot(n, wo))
    wh = _sample_wh(wo_local, roughness, su[1], su[2])
    wh = _where(wh[2] < 0.0, _scale(wh, -1.0), wh)
    wi_local = _reflect(_scale(wo_local, -1.0), wh)
    wi_spec = _unit(_add(_add(_scale(tan, wi_local[0]), _scale(bit, wi_local[1])),
                         _scale(n, wi_local[2])))
    cos_wh = torch.clamp_min(_dot(wo_local, wh), f32(1e-6))
    pdf_spec = _ggx_d(wh, roughness) * torch.abs(wh[2]) / (4.0 * cos_wh)
    f_spec = _microfacet_eval(albedo, wo_local, wi_local, roughness, metallic)

    wi_diff, pdf_diff = diffuse_sample
    f_diff = tuple((c * INV_PI) * (1.0 - fc) for c, fc in zip(albedo, f))
    d = _unit(_where(specular, wi_spec, wi_diff))
    bsdf = _where(specular, tuple(s * fc for s, fc in zip(f_spec, f)), f_diff)
    pdf = torch.where(specular, f_prob * pdf_spec, (1.0 - f_prob) * pdf_diff)
    ok = pdf > 0.0
    ratio = torch.clamp_min(_dot(n, d), 0.0) / torch.where(ok, pdf, 1.0)
    return d, tuple(torch.where(ok, c * ratio, 1.0) for c in bsdf)
