"""Test inputs made with numpy and torch alone (no JAX), so that the tests
that run on the card, where JAX is not installed, can build them too."""

import numpy as np
import torch


TIE_TRIS = (5, 1024 + 7)  # the two copies of the shared triangle


def tie_mesh(rng, n):
    """Two tiles that hold the same triangle (ids 5 and 1031), so every ray
    that hits it has an exact tie across tiles, and whose boxes make the
    plan visit tile 1 first: tile 1 reaches back toward the rays' origins,
    tile 0 away from them.  The lower id must win.  Returns (pos [2048, 3,
    3], origins, directions, t_limit) float32; the other triangles lie off
    the rays' paths."""
    pos = np.zeros((2048, 3, 3), np.float32)
    small = np.array([[0.0, 0.0, 0.0], [0.3, 0.0, 0.0], [0.0, 0.3, 0.0]], np.float32)
    u = rng.random((2048, 1, 3)).astype(np.float32)
    pos[:1024] = small + np.array([40.0, -1.0, 0.0], np.float32) + u[:1024] * [1.0, 2.0, 3.0]
    pos[1024:] = small + np.array([20.0, -1.0, -4.0], np.float32) + u[1024:] * [1.0, 2.0, 4.0]
    shared = np.array([[-1.0, -1.0, 0.0], [3.0, -1.0, 0.0], [-1.0, 3.0, 0.0]], np.float32)
    pos[list(TIE_TRIS)] = shared
    o = np.concatenate([rng.uniform(-0.8, 0.8, (n, 2)), np.full((n, 1), -5.0)], 1)
    d = np.concatenate([rng.uniform(-0.05, 0.05, (n, 2)), np.ones((n, 1))], 1)
    d[: n // 4, :2] = 0.0  # straight down the axis: the hit is exactly t = 5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lim = np.where(rng.random(n) > 0.3, 3.4e38, rng.uniform(4.0, 6.0, n))
    lim[: n // 16] = 5.0  # a hit exactly at t_limit loses to it
    return pos, o.astype(np.float32), d.astype(np.float32), lim.astype(np.float32)


def pad_to_supers(tables, super_tiles=8, tri_tile=1024):
    """``tables`` (the port's ``MXUMeshTables``) padded to whole super-tiles
    as ``build_mxu_tables`` pads them with ``PTT_STREAM_SUPER`` on:
    never-hit tiles of zero coefficient rows and inverted boxes."""
    ct = tables.tile_aabb.shape[0]
    extra = -ct % super_tiles
    never = tables.tile_aabb.new_tensor([1e30] * 3 + [-1e30] * 3 + [0.0] * 2).expand(extra, 8)
    return tables._replace(
        tile_aabb=torch.cat([tables.tile_aabb, never]).contiguous(),
        coef=torch.cat([tables.coef, tables.coef.new_zeros(
            (extra * tri_tile, tables.coef.shape[1]))]).contiguous())


def _scaled_prim(gtype, material_id, center, scale):
    """A ``GeomConst`` of a unit cube or sphere scaled by ``scale`` about
    ``center`` (no rotation): its transform, inverse and inverse transpose."""
    from project3_cuda_path_tracer_2025_tpu_torch.scene.device import GeomConst

    m = np.diag([scale, scale, scale, 1.0])
    m[:3, 3] = center
    inv = np.linalg.inv(m)
    rows = lambda a: tuple(tuple(float(v) for v in r) for r in a)
    return GeomConst(int(gtype), material_id, rows(m), rows(inv), rows(inv.T))


def winner_case(static, rng, n=1024):
    """Rays for the mesh shade's carried prim winner, around the Cornell box
    of ``static`` (a mesh scene's; materials 2 and 3 are its red and green).
    Three prims join the box's: a sphere (material 2), the same sphere again
    (material 3: every ray that hits it ties at equal t, and the lower
    index must win), and a cube of half-size 1.  The rays, a quarter each:
    aimed at the sphere pair; starting inside the cube (its test takes the
    exit); starting outside a face of the cube within ``ray_eps`` of it in
    its own space and entering it (t_obj < ray_eps: the hit lies behind the
    origin and t is still positive); leaving the open front of the box (no
    prim hit).  Every fifth lane carries a made-up mesh hit (a random
    triangle of the mesh at t = 0.05), every seventh is dead.  Returns
    (prim_static, paths, mesh_t, mesh_tri): the shade's mode "plain"
    inputs, which resolve the surface from ``mesh_tri``; the sphere pair are
    prims ``len(static.geoms)`` and one after it."""
    import dataclasses

    from project3_cuda_path_tracer_2025_tpu_torch.ops.rays import PathState
    from project3_cuda_path_tracer_2025_tpu_torch.scene.types import GeomType
    from project3_cuda_path_tracer_2025_tpu_torch.utils.vec import Vec3

    sphere_c, cube_c = np.array([1.0, 3.0, 0.0]), np.array([-2.0, 6.0, 1.0])
    extra = (_scaled_prim(GeomType.SPHERE, 2, sphere_c, 2.0),
             _scaled_prim(GeomType.SPHERE, 3, sphere_c, 2.0),
             _scaled_prim(GeomType.CUBE, 1, cube_c, 2.0))
    prim_static = dataclasses.replace(static, geoms=tuple(static.geoms) + extra,
                                      num_triangles=0)
    q = n // 4
    o = np.empty((n, 3))
    d = np.empty((n, 3))
    # aimed at the sphere pair from the camera's side
    o[:q] = [0.0, 5.0, 10.0]
    d[:q] = sphere_c + rng.uniform(-0.8, 0.8, (q, 3)) - o[:q]
    # inside the cube
    o[q:2 * q] = cube_c + rng.uniform(-0.9, 0.9, (q, 3))
    d[q:2 * q] = rng.normal(size=(q, 3))
    # within ray_eps (1e-4 in the cube's space, 2e-4 in the world) of its
    # face x = -1, entering it
    o[2 * q:3 * q] = np.stack([np.full(q, -1.0 + 2.0 * 0.4e-4), cube_c[1] + rng.uniform(
        -0.8, 0.8, q), cube_c[2] + rng.uniform(-0.8, 0.8, q)], 1)
    d[2 * q:3 * q] = np.stack([-np.ones(q), rng.uniform(-0.3, 0.3, q),
                               rng.uniform(-0.3, 0.3, q)], 1)
    # out of the open front: no prim
    o[3 * q:] = [0.0, 5.0, 20.0] + rng.uniform(-1.0, 1.0, (n - 3 * q, 3))
    d[3 * q:] = np.stack([rng.uniform(-0.2, 0.2, n - 3 * q), rng.uniform(-0.2, 0.2, n - 3 * q),
                          np.ones(n - 3 * q)], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    idx = torch.arange(n, dtype=torch.int32)
    paths = PathState(
        origin=Vec3(*(f(o[:, i]) for i in range(3))),
        direction=Vec3(*(f(d[:, i]) for i in range(3))),
        color=Vec3(*(torch.ones(n) for _ in range(3))),
        pixel=idx,
        bounces=torch.where(idx % 7 == 3, 0, 8).to(torch.int32),
    )
    hit = idx % 5 == 1
    tri = torch.from_numpy(rng.integers(0, static.num_triangles, n).astype(np.int32))
    mesh_t = torch.where(hit, 0.05, 0.0).float()
    mesh_tri = torch.where(hit, tri, -1).to(torch.int32)
    return prim_static, paths, mesh_t, mesh_tri


def key_case(ct, center, rng, n=4096):
    """Rays for the coherence key over ``ct`` random tile boxes (recentred
    frame, within 2 of ``center``, a world point), an eighth each: aimed at
    the boxes from 5 away; the same with one or two direction components
    exactly 0 (the slab's 1e-20 stand-in); aimed away from the boxes (the
    root misses); starting on tile 0's lower x face and running in its
    plane (grazing); starting among the boxes; dead (``bounces`` 0) but
    aimed at them; and the rest aimed at them again.  Returns (tables,
    paths, t_lim): ``tables`` holds the key's inputs of an
    ``MXUMeshTables`` -- tile_aabb [ct, 8], center [3] (``center`` rounded
    to quarter units) and root_box [8], the envelope of the boxes; t_lim is
    FLT_MAX on three rays in ten and between 1 and 8 on the others."""
    import types

    from project3_cuda_path_tracer_2025_tpu_torch.ops.intersect import FLT_MAX
    from project3_cuda_path_tracer_2025_tpu_torch.ops.rays import PathState
    from project3_cuda_path_tracer_2025_tpu_torch.utils.vec import Vec3

    # Quarter units for the centre and 1/256 for tile 0's corner, so that
    # the grazing origins recentre onto the face exactly.
    c = np.round(np.asarray(center, np.float64) * 4.0) / 4.0
    lo = rng.uniform(-2.0, 2.0, (ct, 3))
    lo[0] = np.round(lo[0] * 256.0) / 256.0
    hi = lo + rng.uniform(0.05, 0.6, (ct, 3))
    aabb = np.zeros((ct, 8), np.float32)
    aabb[:, 0:3], aabb[:, 3:6] = lo, hi
    e = n // 8
    part = lambda k: slice(k * e, (k + 1) * e)
    o = rng.normal(size=(n, 3))
    o = 5.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = rng.uniform(-1.5, 1.5, (n, 3)) - o
    flat = d[part(1)]
    flat[:, 0] = 0.0
    flat[::2, 2] = 0.0
    d[part(1)] = np.where(np.abs(flat).sum(1, keepdims=True) > 0, flat, [0.0, 1.0, 0.0])
    d[part(2)] = o[part(2)]
    o[part(3)] = np.stack([np.full(e, lo[0, 0]), rng.uniform(lo[0, 1], hi[0, 1], e),
                           rng.uniform(lo[0, 2], hi[0, 2], e)], 1)
    d[part(3)] = np.stack([np.zeros(e), rng.normal(size=e), rng.normal(size=e)], 1)
    o[part(4)] = rng.uniform(-2.0, 2.0, (e, 3))
    d[part(4)] = rng.normal(size=(e, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o += c
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    bounces = np.full(n, 5, np.int32)
    bounces[part(5)] = 0
    tl = np.where(rng.random(n) < 0.3, FLT_MAX, rng.uniform(1.0, 8.0, n))
    paths = PathState(
        origin=Vec3(*(f(o[:, i]) for i in range(3))),
        direction=Vec3(*(f(d[:, i]) for i in range(3))),
        color=Vec3(*(torch.ones(n) for _ in range(3))),
        pixel=torch.arange(n, dtype=torch.int32),
        bounces=torch.from_numpy(bounces),
    )
    box = np.zeros(8, np.float32)
    box[0:3], box[3:6] = aabb[:, 0:3].min(0), aabb[:, 3:6].max(0)
    tables = types.SimpleNamespace(tile_aabb=f(aabb), center=f(c), root_box=f(box))
    return tables, paths, f(tl)


def prepass_case(ct):
    """Synthetic plan inputs over ``ct`` boxes (recentred frame): 6 blocks
    of 256 rays with a third of them live and a tenth axis-aligned; block 1
    dead, block 2 live only in its last lane (aimed at tile 0's centre),
    block 3 all live; ray 0 of block 4 starts on tile 0's lower x face,
    heading in.  Returns (tile_aabb, os, d, live, tl), the arguments of
    ``plan_prepass`` (tensors on the CPU; Vec3 of the port's utils)."""
    from project3_cuda_path_tracer_2025_tpu_torch.utils.vec import Vec3

    rng = np.random.default_rng(ct)
    nb = 6
    n = nb * 256
    lo = rng.uniform(-1.0, 1.0, (ct, 3))
    hi = lo + rng.uniform(0.02, 0.4, (ct, 3))
    aabb = np.zeros((ct, 8), np.float32)
    aabb[:, 0:3], aabb[:, 3:6] = lo, hi
    o = rng.uniform(-2.0, 2.0, (n, 3))
    d = rng.normal(size=(n, 3))
    d[rng.random(n) < 0.1, 0] = 0.0
    live = rng.random(n) < 0.35
    tl = rng.uniform(0.5, 6.0, n)
    tl[rng.random(n) < 0.1] = 3.4e38
    blk = lambda b: slice(b * 256, (b + 1) * 256)
    live[blk(1)] = False
    live[blk(2)] = False
    last = 2 * 256 + 255
    live[last], o[last], tl[last] = True, (4.0, 4.0, 4.0), 3.4e38
    d[last] = (lo[0] + hi[0]) / 2 - o[last]
    live[blk(3)] = True
    face = 4 * 256
    live[face], tl[face] = True, 3.4e38
    o[face] = (lo[0, 0], (lo[0, 1] + hi[0, 1]) / 2, (lo[0, 2] + hi[0, 2]) / 2)
    d[face] = (1.0, 0.1, -0.05)
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return (t(aabb), Vec3(*(t(o[:, i]) for i in range(3))), Vec3(*(t(d[:, i]) for i in range(3))),
            torch.from_numpy(live), t(tl))


SIGNED_ZERO_LANE = 5  # the lane whose det is -0 in ``signed_zero_case``


def signed_zero_case(tables, n=600):
    """Inputs of the floor flavors where det is -0 on one lane and +0 on the
    others: ``tables`` (the port's ``MXUMeshTables``, e.g. the tie mesh's)
    with every coefficient row zero but lane ``SIGNED_ZERO_LANE``'s first
    two det coefficients of each tile, 1e-45 (the least denormal), and n rays
    whose direction components are all negative, x and y below 0.5 in
    magnitude, so that each of that lane's det products underflows to -0
    (and the third, d_z times 0, is -0) while a zero row's chain sums to +0.  The floors' fold takes
    the two zeros as equal and goes to lane 0, a minimum of the raw ordered
    bits to the -0 lane.  The first block's rays are live, the second's dead
    (all-zero features: +0 on every lane), the third holds the last 88.
    Returns (tables, ro, rd, live, tl, plan): ``plan`` visits every tile in
    ascending id for every block, as an ``ascending_plan`` whose rows hold
    every tile."""
    from project3_cuda_path_tracer_2025_tpu_torch.ops.intersect_mxu import TilePlan
    from project3_cuda_path_tracer_2025_tpu_torch.utils.vec import Vec3

    device = tables.coef.device
    ct = tables.tile_aabb.shape[0]
    coef = torch.zeros_like(tables.coef).view(ct, 1024, -1)
    coef[:, SIGNED_ZERO_LANE, 0:2] = 1e-45
    rng = np.random.default_rng(45)
    o = np.concatenate([rng.uniform(-0.5, 0.5, (n, 2)), np.full((n, 1), 5.0)], 1)
    d = -np.concatenate([rng.uniform(0.1, 0.4, (n, 2)), np.ones((n, 1))], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    live = np.ones(n, bool)
    live[256:512] = False
    nb = -(-n // 256)
    col = lambda a: Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, i], np.float32)).to(device)
                           for i in range(3)))
    plan = TilePlan(torch.arange(ct, dtype=torch.int32, device=device).repeat(nb),
                    torch.zeros(nb * ct, dtype=torch.float32, device=device),
                    torch.full((nb,), ct, dtype=torch.int32, device=device))
    return (tables._replace(coef=coef.reshape(tables.coef.shape).contiguous()), col(o), col(d),
            torch.from_numpy(live).to(device), torch.full((n,), 50.0, device=device), plan)


def assert_bins_equal(got, want):
    """Two ``PacketBins`` bit for bit: ``src``, ``vt``, ``dst`` (or both
    None) and ``overflow``."""
    assert torch.equal(got.src.cpu(), want.src.cpu()), "src"
    assert torch.equal(got.vt.cpu(), want.vt.cpu()), "vt"
    assert (got.dst is None) == (want.dst is None), "dst"
    if want.dst is not None:
        assert torch.equal(got.dst.cpu(), want.dst.cpu()), "dst"
    assert bool(got.overflow) == bool(want.overflow), "overflow"
