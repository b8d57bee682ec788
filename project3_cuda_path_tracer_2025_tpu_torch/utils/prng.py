"""Counter-based RNG, bit-exact with the JAX package's ``utils/prng.py``.

``jax.random`` with the (default) partitionable Threefry layout reduces to
one function, Threefry-2x32 at counter ``(hi, lo)``:

* ``PRNGKey(seed)`` is the key ``(0, seed)``;
* ``fold_in(key, data)`` is the key ``threefry(key, (0, data))``;
* ``uniform(key, (k, n))`` draws element ``(j, i)`` from the bits
  ``b0 ^ b1`` of ``threefry(key, (0, j * n + i))``, then sets them as the
  mantissa of a float in [1, 2) and subtracts 1.

So the port draws the same ``(iteration, pixel, depth)`` streams as the JAX
package, bit for bit, and the kernels in ``csrc/prim_path.cuh`` draw them
inline from the same keys.

A key is a ``(k0, k1)`` tuple of Python ints in [0, 2**32).  The vectorised
hash runs on int64 tensors masked to 32 bits, because PyTorch's CPU build has
no uint32 add or shift; the card's kernels use ``uint32_t``.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """The standard Threefry-2x32 (5 x 4 rounds, key injection every 4
    rounds).  Works on Python ints and on int64 tensors holding uint32
    values alike; returns ``(y0, y1)``."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) & _M32) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> tuple:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit in int32")
    return (0, seed & _M32)


def fold_in(key: tuple, data: int) -> tuple:
    """``jax.random.fold_in(key, data)`` for a 32-bit ``data``."""
    return threefry2x32(key[0], key[1], 0, int(data) & _M32)


def iteration_key(base_key: tuple, iteration: int) -> tuple:
    """Key for one full spp iteration."""
    return fold_in(base_key, iteration)


def stage_key(iter_key: tuple, depth: int, stage: int) -> tuple:
    """Key for one kernel stage at one bounce depth (0 = camera raygen,
    1 = shading)."""
    return fold_in(fold_in(iter_key, depth), stage)


def threefry_bits_inline(k0, k1, flat: torch.Tensor) -> torch.Tensor:
    """Random bits at counter ``(0, flat)``: ``b0 ^ b1``, as an int64
    tensor of uint32 values.  ``flat`` is any integer tensor; it wraps to
    32 bits as the JAX package's uint32 arithmetic does."""
    flat = flat.to(torch.int64) & _M32
    y0, y1 = threefry2x32(int(k0), int(k1), torch.zeros_like(flat), flat)
    return y0 ^ y1


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 random bits -> U[0,1) float32, as ``jax.random.uniform``."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    u = mant.view(torch.float32) - 1.0
    return torch.clamp_min(u, 0.0)


def uniforms_at(key: tuple, idx: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """The rows ``uniforms(key, n, k)[:, idx]`` without the gather: draw
    ``j`` at pixel ``i`` is a pure function of its flat counter ``j*n + i``."""
    idx = idx.to(torch.int64)
    return torch.stack(
        [bits_to_uniform(threefry_bits_inline(key[0], key[1], j * n + idx))
         for j in range(k)]
    )


def uniforms(key: tuple, n: int, k: int, device="cpu", base: int = 0,
             rng_n: int = None) -> torch.Tensor:
    """Draw ``k`` independent U[0,1) rows of length ``n`` -> ``[k, n]``: the
    columns ``[base, base + n)`` of ``jax.random.uniform``'s ``[k, rng_n]``
    rows (``rng_n`` defaults to ``n``; a block of pixels of a sharded or
    chunked frame draws its slice of the whole frame's stream).

    On a CUDA device the draw is the Threefry kernel of ``csrc``
    (``ops.fused.kernel_uniforms``), bit-identical to the plain version
    that runs everywhere else."""
    device = torch.device(device)
    if device.type == "cuda":
        from ..ops.fused import kernel_uniforms

        return kernel_uniforms(key, n, k, device, base=base, rng_n=rng_n)
    rng_n = n if rng_n is None else rng_n
    return uniforms_at(key, base + torch.arange(n, device=device), k, rng_n)
