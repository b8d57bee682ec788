"""Scan / compact / radix-sort primitives (a CUDA kernel + torch oracles).

Port of the JAX package's ``ops/scan.py``, the rebuild of the reference's
GPU-primitives library (``stream_compaction/``: Blelloch scan
``efficient.cu:18-105``, compact = map-to-bool -> scan -> scatter
``efficient.cu:163-224``, 32-pass LSB radix sort ``radix.cu:20-133``).  The
wavefront integrator's stream compaction (``ops.compaction``) is built on
the same scan.

The JAX package scans [128, 128] float32 tiles with a triangular matmul in
a Pallas kernel (``_scan_tile_kernel``) and adds the row offsets in jnp.
Here ``scan_flat`` launches the hand-written CUDA kernels of ``csrc/scan.cu``
on the flat int32 or float32 array: the tile totals, then each tile's scan
with its carry folded in, written straight into the output (two launches,
no pad, no dtype trip, no host read).  Integer inputs are scanned in int32,
exactly; the kernel path still refuses integer inputs beyond N = 2^24, as
the JAX package does (its float32 scan is exact only that far).  Below
``TILE`` elements and on the CPU the plain ``torch.cumsum`` path runs
(``_kernel_ok``), as the JAX package takes its jnp path there.
"""

from __future__ import annotations

import torch

from . import kernels

TILE = 128 * 128  # the JAX package's [128, 128] tile: shorter inputs take cumsum
KERNEL_TILE = 2048  # elements per block of csrc/scan.cu (PTT_SCAN_TILE)
KERNEL_THREADS = 256  # threads per block (PTT_SCAN_THREADS)
KERNEL_DTYPES = (torch.int32, torch.float32)  # the kernels' dtype codes 0 and 1

# The JAX package's float32 accumulation is exact only while every prefix
# sum stays <= 2^24: for 0/1 flags, N <= 2^24 (a 4096 x 4096 film).  The
# kernel path keeps its refusal of longer integer inputs.
_F32_EXACT_N = 1 << 24


# ---------------------------------------------------------------------------
# torch oracles (also the small-N and CPU path); named as in the JAX package
# ---------------------------------------------------------------------------

def exclusive_scan_jnp(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0, dtype=x.dtype) - x


def inclusive_scan_jnp(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0, dtype=x.dtype)


def inclusive_scan_naive(x: torch.Tensor) -> torch.Tensor:
    """Hillis-Steele scan: ceil(log2 n) doubling passes, each adding the
    array to itself shifted by the pass offset (the reference's
    ``stream_compaction/naive.cu:17-74``)."""
    n = x.shape[0]
    offset = 1
    while offset < n:
        x = x + torch.nn.functional.pad(x[: n - offset], (offset, 0))
        offset *= 2
    return x


def exclusive_scan_naive(x: torch.Tensor) -> torch.Tensor:
    """Exclusive Hillis-Steele scan (shift-right of the inclusive result,
    the reference's ``naive.cu`` final shift)."""
    return torch.nn.functional.pad(inclusive_scan_naive(x)[:-1], (1, 0))


# ---------------------------------------------------------------------------
# The whole-array scan kernel (replaces ops/scan.py::_scan_tile_kernel and
# the jnp of _scan_pallas_f32 around it)
# ---------------------------------------------------------------------------

def scan_flat_plain(x: torch.Tensor, inclusive: bool) -> torch.Tensor:
    """The plain PyTorch version of ``scan_flat``: the prefix sum of ``x``
    [N] in its own dtype."""
    return inclusive_scan_jnp(x) if inclusive else exclusive_scan_jnp(x)


def check_flat(x: torch.Tensor) -> None:
    """What the kernels take: a contiguous [N] int32 or float32 CUDA tensor."""
    if x.device.type != "cuda":
        raise ValueError(f"scan_flat: the kernel takes CUDA tensors, got {x.device}")
    if x.dim() != 1 or x.dtype not in KERNEL_DTYPES or not x.is_contiguous():
        raise ValueError(f"scan_flat: expected a contiguous [N] int32 or float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")


def scan_flat(x: torch.Tensor, inclusive: bool) -> torch.Tensor:
    """The inclusive or exclusive prefix sum of ``x`` [N] (int32, exact; or
    float32) in its dtype.  CUDA tensors launch ``csrc/scan.cu`` (the tile
    totals, then the scan with the carries; one launch for N <= 2,048);
    CPU tensors run ``scan_flat_plain``."""
    if x.device.type == "cpu":
        return scan_flat_plain(x, inclusive)
    check_flat(x)
    n = x.shape[0]
    tiles = (n + KERNEL_TILE - 1) // KERNEL_TILE
    buf = torch.empty((n + tiles,), dtype=x.dtype, device=x.device)  # the output, then the totals
    lib = kernels.load("scan")
    code = lib.lib.ptt_launch_scan(x.data_ptr(), buf.data_ptr(),
                                   buf.data_ptr() + n * x.element_size(), n,
                                   KERNEL_DTYPES.index(x.dtype), int(inclusive),
                                   kernels.stream_handle(x.device))
    lib.check(code, "scan_flat")
    scan_flat.launches += 1
    return buf[:n]


scan_flat.launches = 0


def _kernel_ok(x: torch.Tensor, use_kernel: bool) -> bool:
    if not use_kernel or x.shape[0] < TILE or x.device.type == "cpu":
        return False
    if not torch.is_floating_point(x) and x.shape[0] > _F32_EXACT_N:
        raise ValueError(
            f"the float32 kernel scan is exact only up to N = 2^24 for integer "
            f"inputs; got N = {x.shape[0]}.  Pass use_kernel=False."
        )
    return True


def _scan(x: torch.Tensor, use_kernel: bool, inclusive: bool) -> torch.Tensor:
    if not _kernel_ok(x, use_kernel):
        return scan_flat_plain(x, inclusive)
    floating = torch.is_floating_point(x)  # floats give the JAX package's float32 result
    out = scan_flat(x.to(torch.float32 if floating else torch.int32).contiguous(), inclusive)
    return out if floating else out.to(x.dtype)


def exclusive_scan(x: torch.Tensor, use_kernel: bool = True) -> torch.Tensor:
    """Exclusive prefix sum (``StreamCompaction::Efficient::scan`` parity)."""
    return _scan(x, use_kernel, inclusive=False)


def inclusive_scan(x: torch.Tensor, use_kernel: bool = True) -> torch.Tensor:
    return _scan(x, use_kernel, inclusive=True)


# ---------------------------------------------------------------------------
# Compact (map-to-bool -> scan -> scatter), Efficient::compact parity
# ---------------------------------------------------------------------------

def compact_indices(flags: torch.Tensor, use_kernel: bool = True):
    """Returns (dest, count): dest[i] is the output slot of element i when
    flags[i], else its slot in the rejected tail (stable both sides: a
    stable-partition permutation, the thrust::stable_partition semantics of
    the render loop).  ``count`` stays on the device."""
    f = flags.to(torch.int32)
    keep_rank = exclusive_scan(f, use_kernel)
    count = keep_rank[-1] + f[-1]
    drop_rank = exclusive_scan(1 - f, use_kernel)
    dest = torch.where(flags, keep_rank, count + drop_rank)
    return dest, count


def compact(values: torch.Tensor, flags: torch.Tensor, use_kernel: bool = True):
    """Front-pack values by flags (stable); returns (packed, count).
    Rejected elements appear after the packed prefix."""
    dest, count = compact_indices(flags, use_kernel)
    out = torch.zeros_like(values)
    out[dest.long()] = values
    return out, count


# ---------------------------------------------------------------------------
# Radix sort: LSB passes of stable partition-by-bit (Radix::radixSort parity)
# ---------------------------------------------------------------------------

def radix_sort_permutation(
    keys: torch.Tensor, num_bits: int = 32, use_kernel: bool = True
) -> torch.Tensor:
    """Stable ascending sort permutation of non-negative int32 keys via
    ``num_bits`` LSB -> MSB split passes, each a scan-driven stable partition
    (the reference does 32 fixed passes; pass the key domain's bit width,
    e.g. 6 for material ids < 64)."""
    n = keys.shape[0]
    perm = torch.arange(n, dtype=torch.int32, device=keys.device)
    k = keys.to(torch.int32)
    for bit in range(num_bits):
        zero = ((k >> bit) & 1) == 0
        dest, _ = compact_indices(zero, use_kernel)
        d = dest.long()
        new_perm, new_k = torch.empty_like(perm), torch.empty_like(k)
        new_perm[d] = perm
        new_k[d] = k
        perm, k = new_perm, new_k
    return perm
