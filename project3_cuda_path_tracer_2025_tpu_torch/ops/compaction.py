"""Wavefront state management: stream compaction + material sort.

The reference shrinks its live-path buffer with ``thrust::stable_partition``
(``src/pathtrace.cu:750-757``) and optionally groups work with
``thrust::stable_sort_by_key`` on material id (``:730-735``).  As in the JAX
package (``ops/compaction.py``), both are *permutations* of the full N-slot
state:

* ``compact_paths``: stable front-pack of the live rays (scan ranks, the
  scan kernel on the card) + a live count; trailing slots are all dead.
* ``sort_paths_by_material``: stable sort of (paths, intersections) by
  material id.

The megakernel's fused mesh bounce shares ``permute_path_state``: its
persistent coherence sort applies one permutation to the whole bounce state
and never scatters back (the film scatter-adds by pixel id).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils.vec import Vec3
from . import scan as scan_ops
from .rays import Intersections, PathState


def permute_path_state(paths: PathState, perm: torch.Tensor, extra: tuple = ()):
    """Apply ``perm`` to every field of ``paths`` and to each tensor of
    ``extra``: ``out[i] = in[perm[i]]``.  Returns ``(paths, extras)``.

    One gather per field.  The JAX package's packed form (``packed=True``:
    one [N, 9+E+2] row gather with the integers carried as floats) gives
    the same rows and values; it exists for the TPU's gather costs
    (``PTT_PACKED_PERMUTE``, on the do-not-port list)."""
    g = lambda a: a[perm]
    out = PathState(
        origin=Vec3(*map(g, paths.origin)),
        direction=Vec3(*map(g, paths.direction)),
        color=Vec3(*map(g, paths.color)),
        pixel=g(paths.pixel),
        bounces=g(paths.bounces),
    )
    return out, tuple(g(e) for e in extra)


def permute_intersections(isect: Intersections, perm: torch.Tensor) -> Intersections:
    """Apply ``perm`` to every field of ``isect``.  Plain indexing moves the
    values bit for bit; the JAX package packs the fields into one bitcast
    int32 row gather behind an optimization barrier, which it needs to keep
    XLA from re-fusing across the repack."""
    g = lambda a: a[perm]
    return Intersections(
        t=g(isect.t),
        normal=Vec3(*map(g, isect.normal)),
        material_id=g(isect.material_id),
        uv_u=g(isect.uv_u),
        uv_v=g(isect.uv_v),
        dpdu=Vec3(*map(g, isect.dpdu)),
        dpdv=Vec3(*map(g, isect.dpdv)),
        is_triangle=g(isect.is_triangle),
    )


def front_pack_permutation(alive: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable partition permutation: live lanes first (original order), dead
    lanes after (original order).  Returns (perm, live_count), both on the
    device.  Built on ``ops.scan.compact_indices`` (the scan kernel on the
    card, the torch oracle on the CPU and below one tile)."""
    n = alive.shape[0]
    dest, live_count = scan_ops.compact_indices(alive)
    perm = torch.empty((n,), dtype=torch.int32, device=alive.device)
    perm[dest.long()] = torch.arange(n, dtype=torch.int32, device=alive.device)
    return perm, live_count


def compact_paths(paths: PathState) -> Tuple[PathState, torch.Tensor]:
    """thrust::stable_partition(PathAlive) equivalent (permutes, never
    drops: the film still reads all N slots)."""
    perm, live = front_pack_permutation(paths.alive)
    return permute_path_state(paths, perm)[0], live


def sort_paths_by_material(
    paths: PathState, isect: Intersections
) -> Tuple[PathState, Intersections]:
    """thrust::stable_sort_by_key(CompareMat) equivalent: stable sort of
    (paths, intersections) by material id.  Missed and terminated rays keep
    the reference's key (a miss holds material 0, as its per-bounce memset
    leaves it)."""
    order = torch.argsort(isect.material_id, stable=True)
    return permute_path_state(paths, order)[0], permute_intersections(isect, order)
