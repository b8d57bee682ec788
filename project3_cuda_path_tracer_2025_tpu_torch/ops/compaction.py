"""Permutations of the path state.

The JAX package's ``ops/compaction.py`` holds the wavefront integrator's
stream compaction and material sort (``ROADMAP.md``, Queue 1: wavefront).
The megakernel's fused mesh bounce needs only its shared permute: the
persistent coherence sort applies one permutation to the whole bounce state
and never scatters back (the film scatter-adds by pixel id at the end of
the iteration).
"""

from __future__ import annotations

import torch

from ..utils.vec import Vec3
from .rays import PathState


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
