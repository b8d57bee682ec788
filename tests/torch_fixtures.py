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
