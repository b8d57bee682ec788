"""The port's scan library (``ops/scan.py``) against the JAX package's.

* The torch oracles and the Hillis-Steele flavours against ``ops/scan.py``'s
  jnp ones, on integers (equal).
* The whole-array scan (``scan_flat``: on CPU tensors its plain version,
  and the two kernels of ``csrc/scan.cu`` built for the host,
  ``tests/scan_host.cpp``) against the JAX package's ``_scan_pallas_f32``
  with its Pallas tile kernel in interpret mode, inclusive and exclusive,
  on float32 and int32 inputs (the JAX side scans the int32 inputs in
  float32 and rounds back, as its ``exclusive_scan`` does), over several
  tiles and a ragged end: integer values equal, floats within ``rtol=1e-5,
  atol=1e-3`` (the TPU kernel sums a row by a matmul, the port by running
  sums; the prefixes reach ~2e4).
* ``compact_indices``, ``compact`` and ``radix_sort_permutation`` against the
  JAX package's (permutations and counts equal) and the radix sort against a
  stable ``torch.argsort``.
* The kernel path's guards: integer inputs past 2^24 raise ``ValueError``
  as in the JAX package, and the kernel wrapper refuses a tensor that is
  neither on the CPU nor on a CUDA device.  (The kernel itself runs on the
  card: ``tests/test_torch_cuda.py``.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_2025_tpu.ops import scan as jscan
from project3_cuda_path_tracer_2025_tpu_torch.ops import scan
from test_torch_kernel_body import SCAN_HARNESS, host_scan
from torch_compare import build_host


@pytest.mark.parametrize("n", [1, 2, 7, 128, 1000, 4097])
def test_oracles_match_jax(n):
    x = np.random.default_rng(n).integers(0, 5, n).astype(np.int32)
    t, j = torch.from_numpy(x), jnp.asarray(x)
    for ours, theirs in ((scan.exclusive_scan_jnp, jscan.exclusive_scan_jnp),
                         (scan.inclusive_scan_jnp, jscan.inclusive_scan_jnp),
                         (scan.inclusive_scan_naive, jscan.inclusive_scan_naive),
                         (scan.exclusive_scan_naive, jscan.exclusive_scan_naive)):
        got = ours(t)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(theirs(j)))
    # exclusive_scan / inclusive_scan on the CPU: the oracle path.
    np.testing.assert_array_equal(scan.exclusive_scan(t).numpy(), np.cumsum(x) - x)
    np.testing.assert_array_equal(scan.inclusive_scan(t).numpy(), np.cumsum(x))


@pytest.fixture
def jax_tiled(monkeypatch):
    """The JAX package's tiled scan with its Pallas kernel interpreted."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def interpreted(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    return jscan._scan_pallas_f32


@pytest.fixture(scope="module")
def scan_lib(tmp_path_factory):
    import ctypes

    lib = build_host(tmp_path_factory, SCAN_HARNESS, "libscan_host.so")
    lib.ptt_host_scan.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int32,
                                                          ctypes.c_int32]
    return lib


@pytest.mark.parametrize("kind", ["flags", "ints", "floats", "flags-int32", "ints-int32"])
def test_tiled_scan_matches_pallas(jax_tiled, scan_lib, kind):
    rng = np.random.default_rng(7)
    n = scan.TILE * 2 + 777
    values, _, dtype = kind.partition("-")
    x = {"flags": lambda: (rng.random(n) > 0.5).astype(np.float32),
         "ints": lambda: rng.integers(0, 3, n).astype(np.float32),
         "floats": lambda: rng.random(n).astype(np.float32)}[values]()
    xt = torch.from_numpy(x.astype(dtype or "float32"))
    for inclusive in (False, True):
        want = np.asarray(jax_tiled(jnp.asarray(x), inclusive=inclusive))
        if dtype:
            want = np.round(want).astype(np.int32)
        ref = np.cumsum(x.astype(np.float64)) - (0 if inclusive else x)
        for got in (scan.scan_flat(xt, inclusive), host_scan(scan_lib, xt, inclusive)[0]):
            assert got.dtype == xt.dtype
            if values == "floats":
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)
                np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-3)
            else:
                np.testing.assert_array_equal(got.numpy(), want)
                np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("n", [500, scan.TILE + 3])
def test_compact_matches_jax(n):
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 100, n).astype(np.int32)
    flags = rng.random(n) > 0.6
    dest, count = scan.compact_indices(torch.from_numpy(flags))
    jdest, jcount = jscan.compact_indices(jnp.asarray(flags))
    np.testing.assert_array_equal(dest.numpy(), np.asarray(jdest))
    assert int(count) == int(jcount) == flags.sum()
    packed, count = scan.compact(torch.from_numpy(vals), torch.from_numpy(flags))
    jpacked, _ = jscan.compact(jnp.asarray(vals), jnp.asarray(flags))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    np.testing.assert_array_equal(packed.numpy()[: flags.sum()], vals[flags])
    np.testing.assert_array_equal(packed.numpy()[flags.sum():], vals[~flags])


@pytest.mark.parametrize("num_bits,high", [(6, 37), (31, 2**31 - 1)])
def test_radix_sort_matches_jax_and_argsort(num_bits, high):
    keys = np.random.default_rng(num_bits).integers(0, high, 700).astype(np.int32)
    perm = scan.radix_sort_permutation(torch.from_numpy(keys), num_bits=num_bits)
    assert perm.dtype == torch.int32
    jperm = jscan.radix_sort_permutation(jnp.asarray(keys), num_bits=num_bits)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    stable = torch.argsort(torch.from_numpy(keys), stable=True)
    np.testing.assert_array_equal(perm.numpy(), stable.numpy())


def test_kernel_path_guards():
    big = torch.empty(2**24 + 1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="2\\^24"):
        scan.exclusive_scan(big)
    with pytest.raises(ValueError, match="2\\^24"):
        scan.inclusive_scan(big)
    # floats and the explicit opt-out take no guard; short inputs never
    # reach the kernel
    assert scan._kernel_ok(torch.empty(2**24 + 1, device="meta"), True)
    assert not scan._kernel_ok(big, False)
    assert not scan._kernel_ok(torch.empty(scan.TILE - 1, device="meta"), True)
    with pytest.raises(ValueError, match="CUDA"):
        scan.scan_flat(torch.empty(scan.TILE, device="meta"), True)
