"""Scan / compact / radix-sort primitives (a CUDA kernel + torch oracles).

Port of the JAX package's ``ops/scan.py``, the rebuild of the reference's
GPU-primitives library (``stream_compaction/``: Blelloch scan
``efficient.cu:18-105``, compact = map-to-bool -> scan -> scatter
``efficient.cu:163-224``, 32-pass LSB radix sort ``radix.cu:20-133``).  The
wavefront integrator's stream compaction (``ops.compaction``) is built on
the same scan.

The JAX package scans [128, 128] float32 tiles with a triangular matmul in
a Pallas kernel (``_scan_tile_kernel``).  Here ``scan_tiles`` launches the
hand-written CUDA kernel ``csrc/scan.cu`` (one warp per 128-lane row,
shuffle scan), and torch adds the row offsets (an exclusive scan of the row
totals) as jnp does there.  Inputs are scanned in float32, which is exact
for integer values while every prefix stays <= 2^24: the kernel path refuses
longer integer inputs, as the JAX package does.  Below ``TILE`` elements and
on the CPU the plain ``torch.cumsum`` path runs (``_kernel_ok``).
"""

from __future__ import annotations

import torch

from . import kernels

LANES = 128
SUBLANES = 128  # rows per tile of the JAX kernel (the padding unit)
TILE = LANES * SUBLANES
KERNEL_ROWS_PER_BLOCK = 8  # csrc/scan.cu: PTT_SCAN_WARPS

# The float32 accumulation is exact only while every prefix sum stays
# <= 2^24: for 0/1 flags, N <= 2^24 (a 4096 x 4096 film).
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
# The tile kernel (replaces ops/scan.py::_scan_tile_kernel)
# ---------------------------------------------------------------------------

def scan_tiles_plain(xp: torch.Tensor):
    """The plain PyTorch version of the tile kernel: per row of ``xp``
    [R, 128] float32, the inclusive scan and the row total [R, 1]."""
    lane = torch.cumsum(xp, 1)
    return lane, lane[:, LANES - 1:]


def scan_tiles(xp: torch.Tensor):
    """Per 128-lane row of ``xp`` [R, 128] float32: (inclusive scan [R,
    128], row totals [R, 1]).  CUDA tensors launch ``csrc/scan.cu``; CPU
    tensors run ``scan_tiles_plain``."""
    device = xp.device
    if device.type == "cpu":
        return scan_tiles_plain(xp)
    if device.type != "cuda":
        raise ValueError(f"scan_tiles: the kernel takes CUDA tensors, got {device}")
    if xp.dim() != 2 or xp.shape[1] != LANES or xp.dtype != torch.float32 \
            or not xp.is_contiguous() or xp.data_ptr() % 16:
        raise ValueError(
            f"scan_tiles: expected contiguous 16-byte-aligned float32 [R, {LANES}], got "
            f"{xp.dtype} {tuple(xp.shape)}")
    rows = xp.shape[0]
    if rows >= 2**31:
        raise ValueError(f"scan_tiles: {rows} rows exceed the kernel's 32-bit row count")
    lane = torch.empty_like(xp)
    tot = torch.empty((rows, 1), dtype=torch.float32, device=device)
    lib = kernels.load("scan")
    code = lib.lib.ptt_launch_scan_tiles(xp.data_ptr(), lane.data_ptr(), tot.data_ptr(), rows,
                                         kernels.stream_handle(device))
    lib.check(code, "scan_tiles")
    scan_tiles.launches += 1
    return lane, tot


scan_tiles.launches = 0


def _scan_tiled(x: torch.Tensor, inclusive: bool) -> torch.Tensor:
    """The JAX package's ``_scan_pallas_f32``: pad to whole tiles, scan the
    rows, add the exclusive scan of the row totals."""
    n = x.shape[0]
    n_pad = ((n + TILE - 1) // TILE) * TILE
    xp = torch.nn.functional.pad(x, (0, n_pad - n)).reshape(-1, LANES)
    lane_scan, row_tot = scan_tiles(xp)
    row_off = exclusive_scan_jnp(row_tot[:, 0])
    out = lane_scan + row_off[:, None]
    if not inclusive:
        out = out - xp
    return out.reshape(-1)[:n]


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
        return inclusive_scan_jnp(x) if inclusive else exclusive_scan_jnp(x)
    out = _scan_tiled(x.to(torch.float32), inclusive)
    if not torch.is_floating_point(x):
        out = torch.round(out).to(x.dtype)
    return out


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
