"""The port's RNG against ``jax.random``, bit for bit.

Every comparison between the port and the JAX package rests on the two
drawing the same ``(iteration, pixel, depth)`` streams, so keys, uniform
rows, per-pixel draws and the inline Threefry must be identical, not close.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_2025_tpu.utils import prng as jprng
from project3_cuda_path_tracer_2025_tpu_torch.utils import prng


def _jkey(key) -> tuple:
    kd = np.asarray(jax.random.key_data(key)).astype(np.uint32)
    return (int(kd[0]), int(kd[1]))


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 - 1, -7])
def test_prng_key_matches(seed):
    assert prng.prng_key(seed) == _jkey(jax.random.PRNGKey(seed))


def test_iteration_and_stage_keys_match():
    base = jax.random.PRNGKey(3)
    for it in (1, 2, 77, 5000):
        ik = jprng.iteration_key(base, jnp.int32(it))
        assert prng.iteration_key(prng.prng_key(3), it) == _jkey(ik)
        for depth in (0, 1, 7):
            for stage in (0, 1):
                want = _jkey(jprng.stage_key(ik, depth, stage))
                got = prng.stage_key(_jkey(ik), depth, stage)
                assert got == want, (it, depth, stage)


@pytest.mark.parametrize("n,k", [(1024, 3), (777, 4)])
def test_uniforms_bit_exact(n, k):
    jkey = jprng.stage_key(jprng.iteration_key(jax.random.PRNGKey(0), jnp.int32(5)), 2, 1)
    want = np.asarray(jprng.uniforms(jkey, n, k))
    got = prng.uniforms(_jkey(jkey), n, k).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_uniforms_at_bit_exact_under_permutation():
    jkey = jax.random.PRNGKey(11)
    n, k = 640, 4
    idx = np.random.default_rng(5).permutation(n).astype(np.int32)
    want = np.asarray(jprng.uniforms_at(jkey, jnp.asarray(idx), k, n))
    got = prng.uniforms_at(_jkey(jkey), torch.from_numpy(idx), k, n).numpy()
    np.testing.assert_array_equal(got, want)


def test_threefry_bits_inline_bit_exact():
    jkey = jax.random.key(20260819)
    kd = jax.random.key_data(jkey)
    flat = np.random.default_rng(3).integers(0, 2**32, 4096, dtype=np.uint64)
    want = np.asarray(
        jprng.threefry_bits_inline(kd[0], kd[1], jnp.asarray(flat.astype(np.uint32)))
    )
    k0, k1 = _jkey(jkey)
    got = prng.threefry_bits_inline(k0, k1, torch.from_numpy(flat.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    want_u = np.asarray(jprng.bits_to_uniform(jnp.asarray(want)))
    np.testing.assert_array_equal(prng.bits_to_uniform(got).numpy(), want_u)


def test_uniforms_edge_bits():
    """bits_to_uniform at the extremes: all-zero and all-one mantissas."""
    bits = np.array([0, 511, 512, 2**32 - 1, 2**31], np.uint32)
    want = np.asarray(jprng.bits_to_uniform(jnp.asarray(bits)))
    got = prng.bits_to_uniform(torch.from_numpy(bits.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)
