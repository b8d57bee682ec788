"""Build, load and launch the CUDA kernels of ``csrc/``.

The kernels are compiled with ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes``: no PyTorch headers, so a build takes
seconds.  The library goes to ``build/kernels/<hash>/`` at the repository
root, keyed by a hash of the sources and flags, and is built at first use
(``load()``), never at import.  A failed build raises with nvcc's output; a
launch that the runtime refuses raises with its error string.

The ctypes structures below mirror ``csrc/prim_path.cuh`` and
``csrc/fused_prim.cu`` field for field; ``load()`` checks their sizes and
offsets against the library's own (``ptt_abi``) before anything launches.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("prim_path.cuh", "fused_prim.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

MAX_GEOMS = 32
MAX_MATERIALS = 32
MAX_DEPTH = 64

_f = ctypes.c_float
_i = ctypes.c_int32
_p = ctypes.c_void_p


class PttGeom(ctypes.Structure):
    _fields_ = [
        ("type", _i), ("material_id", _i),
        ("inverse", _f * 12), ("transform", _f * 12), ("inv_transpose", _f * 12),
    ]


class PttMaterial(ctypes.Structure):
    _fields_ = [
        ("color", _f * 3), ("emittance", _f), ("has_reflective", _f),
        ("has_refractive", _f), ("ior", _f), ("roughness", _f), ("metallic", _f),
    ]


class PttScene(ctypes.Structure):
    _fields_ = [
        ("num_geoms", _i), ("num_materials", _i),
        ("lobe_glass", _i), ("lobe_mirror", _i), ("lobe_trans", _i), ("lobe_micro", _i),
        ("baby_eps", _f), ("larger_eps", _f), ("ray_eps", _f), ("pad", _i),
        ("geoms", PttGeom * MAX_GEOMS), ("materials", PttMaterial * MAX_MATERIALS),
    ]


class PttCamera(ctypes.Structure):
    _fields_ = [
        ("position", _f * 3), ("view", _f * 3), ("up", _f * 3), ("right", _f * 3),
        ("pixel_length", _f * 2), ("aperture", _f), ("focal_dist", _f),
    ]


class PttIterArgs(ctypes.Structure):
    _fields_ = [
        ("scene", _p), ("film_x", _p), ("film_y", _p), ("film_z", _p), ("alive", _p),
        ("cam", PttCamera),
        ("width", _i), ("height", _i), ("n", _i), ("depth", _i),
        ("keys", ctypes.c_uint32 * (2 * (MAX_DEPTH + 1))),
    ]


class PttBounceArgs(ctypes.Structure):
    _fields_ = [
        ("scene", _p), ("in_f", _p * 9), ("in_bounces", _p), ("u", _p),
        ("out_f", _p * 9), ("out_bounces", _p), ("n", _i), ("pad", _i),
    ]


def _abi_expected() -> list:
    return [
        ctypes.sizeof(PttScene),
        ctypes.sizeof(PttCamera),
        ctypes.sizeof(PttIterArgs),
        PttIterArgs.cam.offset,
        PttIterArgs.keys.offset,
        ctypes.sizeof(PttBounceArgs),
        PttBounceArgs.n.offset,
        MAX_GEOMS,
        MAX_MATERIALS,
        MAX_DEPTH,
    ]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH); the CUDA kernels build on a machine with the CUDA toolkit"
        )
    return found


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


class KernelLibrary:
    """The loaded library: its ctypes functions and how it was built."""

    def __init__(self, path: pathlib.Path, build_seconds: float, build_log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log
        lib = ctypes.CDLL(str(path))
        lib.ptt_abi.argtypes = [ctypes.POINTER(_i), _i]
        lib.ptt_abi.restype = _i
        lib.ptt_launch_iteration.argtypes = [ctypes.POINTER(PttIterArgs), _p]
        lib.ptt_launch_iteration.restype = _i
        lib.ptt_launch_bounce.argtypes = [ctypes.POINTER(PttBounceArgs), _p]
        lib.ptt_launch_bounce.restype = _i
        lib.ptt_launch_uniforms.argtypes = [
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, _p, _p,
        ]
        lib.ptt_launch_uniforms.restype = _i
        lib.ptt_error_string.argtypes = [_i]
        lib.ptt_error_string.restype = ctypes.c_char_p
        self.lib = lib
        want = _abi_expected()
        buf = (_i * len(want))()
        count = lib.ptt_abi(buf, len(want))
        got = list(buf)[:count]
        if got != want:
            raise RuntimeError(
                f"ctypes mirror of the kernel structs disagrees with {path}: "
                f"library {got}, ctypes {want}"
            )

    def check(self, code: int, what: str) -> None:
        if code != 0:
            msg = self.lib.ptt_error_string(code).decode()
            raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


@functools.lru_cache(maxsize=1)
def load() -> KernelLibrary:
    """Build (if needed) and load the kernel library."""
    out_dir = BUILD_ROOT / _source_hash()
    lib_path = out_dir / "libptt_prim.so"
    log_path = out_dir / "build.log"
    if lib_path.is_file():
        log = log_path.read_text() if log_path.is_file() else ""
        return KernelLibrary(lib_path, 0.0, log)
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libptt_prim.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / "fused_prim.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib_path)
    return KernelLibrary(lib_path, seconds, log)


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
