"""ctypes binding for the native C++ BVH builder (``csrc/bvh_builder.cpp``).

The JAX package's builder (``project3_cuda_path_tracer_2025_tpu/native/``),
the same source and C ABI: the two give the same tree.  The library is
built with the host C++ compiler (``CXX``, ``CXX_FLAGS``: the JAX
``Makefile``'s) at first use into ``build/native/<hash>/`` at the
repository root, keyed by a hash of the source and the flags, and loaded
once per process.  Several processes may build at once: each writes a
file of its own and moves it into place.

There is no fallback: where the library cannot be built or loaded,
``load`` raises with the compiler's output, so a tree always comes from
the builder that was asked for (``build_bvh(use_native=False)`` is the
NumPy build).
"""

from __future__ import annotations

import ctypes
import functools
import os
import pathlib
import subprocess
import time

import numpy as np

from ..ops import kernels

SOURCE = "bvh_builder.cpp"
CXX = "g++"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
BUILD_ROOT = kernels.BUILD_ROOT.parent / "native"

_f = ctypes.POINTER(ctypes.c_float)
_i = ctypes.POINTER(ctypes.c_int)


class NativeBuildError(RuntimeError):
    """The native BVH builder could not be built or loaded."""


def compile_library(lib_path: pathlib.Path) -> float:
    """Compile the source into ``lib_path`` (a file of this process's own,
    then moved into place); returns the compiler's seconds.  Raises
    ``NativeBuildError`` with the command and the compiler's output."""
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.stem}.{os.getpid()}.tmp.so")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(kernels.CSRC / SOURCE)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(
            f"the native BVH builder could not be built ($ {' '.join(cmd)}): {e}"
        ) from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"the native BVH builder could not be built ($ {' '.join(cmd)}, exit "
            f"{proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib_path)
    return time.perf_counter() - t0


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises ``NativeBuildError``
    naming the compiler's command and output when either fails."""
    lib_path = library_path()
    if not lib_path.is_file():
        compile_library(lib_path)
    try:
        lib = ctypes.CDLL(str(lib_path))
    except OSError as e:
        raise NativeBuildError(f"the native BVH builder {lib_path} could not be loaded: {e}") \
            from e
    lib.build_bvh.restype = ctypes.c_int
    lib.build_bvh.argtypes = [
        _f,  # verts [T*9]
        _f,  # centroids [T*3]
        ctypes.c_int,  # T
        ctypes.c_int,  # leaf_size
        _f,  # out aabb_min [maxM*3]
        _f,  # out aabb_max
        _i,  # out left
        _i,  # out right
        _i,  # out start
        _i,  # out count
        _i,  # out tri_indices [T]
    ]
    return lib


def library_path() -> pathlib.Path:
    """Where ``load`` builds the library (it may not exist yet)."""
    return BUILD_ROOT / kernels._source_hash((SOURCE,), CXX_FLAGS) / "libptt_bvh_builder.so"


def build(tri_vertices: np.ndarray, centroids: np.ndarray, leaf_size: int) -> dict:
    """The BVH arrays of ``tri_vertices`` [T, 3, 3] with ``centroids``
    [T, 3], built in C++: the JAX binding's dict (``aabb_min``/``aabb_max``
    [M, 3], ``left``, ``right``, ``start``, ``count``/``tri_count`` [M],
    ``tri_indices`` [T])."""
    t = int(tri_vertices.shape[0])
    if tri_vertices.shape != (t, 3, 3) or centroids.shape != (t, 3):
        raise ValueError(f"triangles {tri_vertices.shape} and centroids {centroids.shape}: "
                         "give [T, 3, 3] and [T, 3]")
    if t == 0 or leaf_size < 1:
        raise ValueError(f"a BVH needs triangles and leaf_size >= 1 (T={t}, "
                         f"leaf_size={leaf_size})")
    lib = load()
    max_nodes = 2 * t  # a binary tree with >= 1 triangle per leaf has < 2T nodes
    verts = np.ascontiguousarray(tri_vertices, np.float32).reshape(-1)
    cents = np.ascontiguousarray(centroids, np.float32).reshape(-1)
    aabb_min = np.empty(max_nodes * 3, np.float32)
    aabb_max = np.empty(max_nodes * 3, np.float32)
    left, right, start, count = (np.empty(max_nodes, np.int32) for _ in range(4))
    tri_indices = np.empty(t, np.int32)
    fp = lambda a: a.ctypes.data_as(_f)
    ip = lambda a: a.ctypes.data_as(_i)
    m = lib.build_bvh(fp(verts), fp(cents), t, int(leaf_size), fp(aabb_min), fp(aabb_max),
                      ip(left), ip(right), ip(start), ip(count), ip(tri_indices))
    if m <= 0:
        raise NativeBuildError(f"the native BVH build returned {m} nodes for {t} triangles")
    return dict(
        aabb_min=aabb_min[: m * 3].reshape(m, 3),
        aabb_max=aabb_max[: m * 3].reshape(m, 3),
        left=left[:m].copy(),
        right=right[:m].copy(),
        start=start[:m].copy(),
        count=count[:m].copy(),
        tri_count=count[:m].copy(),
        tri_indices=tri_indices,
    )
