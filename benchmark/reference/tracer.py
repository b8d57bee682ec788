"""The plain reference path tracer: what the port must compute, written
again in plain PyTorch from the reference tracer's description.

One path per (pixel, iteration) row: Threefry-2x32 draws keyed by the seed,
the iteration, the depth and the stage (the JAX package's stream layout,
which the port keeps); a jittered pinhole or thin-lens camera ray; then
``depth`` bounces of nearest hit over boxes, spheres and triangles, the
normal turned toward the ray, and a cosine-weighted diffuse scatter or an
emitter's end.  A path that runs out of bounces keeps its throughput, and
every path's final colour is added to its pixel once an iteration.

``dtype`` is the precision of every geometric and shading operation; the
draws are made in float32 and rounded to it, and colours come back in
float32.  float32 is the reference; a lower precision is the control that
the comparison must refuse.  Nothing here reads anything the program made.

``walk_counts`` traces one whole-frame iteration and counts, at each
bounce, the least work of any box-bounded walk over the scene's meshes
(``MeshIndex.walk_count``).
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
RAY_EPSILON = 1e-4


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
        self.walk = None  # a bounce's [rays, pairs, [entered [T] a mesh]] in walk_counts

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
        ends = ~hit | emissive
        zero = torch.zeros_like(t)
        color = _where(hit & emissive, tuple(c * (al * emit) for c, al in zip(color, albedo)),
                       color)
        color = _where(~hit, (zero, zero, zero), color)
        color = _where(scatter, tuple(c * m for c, m in zip(color, mult)), color)
        bounces = torch.where(ends, 0, torch.where(scatter, bounces - 1, bounces))
        return (_where(scatter, new_origin, ro), _where(scatter, new_dir, rd), color,
                bounces)

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
