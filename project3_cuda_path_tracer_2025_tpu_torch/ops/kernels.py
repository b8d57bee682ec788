"""Build, load and launch the CUDA kernels of ``csrc/``.

Each ``.cu`` file of ``LIBRARIES`` is compiled with ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes``: no PyTorch
headers, so a build takes seconds, and the libraries build in parallel (one
``nvcc`` each, started together).  They go to ``build/kernels/<hash>/`` at
the repository root, keyed by a hash of the sources and flags, and are
built at first use (``load()``), never at import.  A failed build raises
with nvcc's output; a launch that the runtime refuses raises with its error
string.

The ctypes structures below mirror ``csrc/prim_path.cuh``,
``csrc/fused_prim.cu``, ``csrc/fused_mesh.cu`` and ``csrc/mesh_walk.cu``
field for field; loading a library checks their sizes and offsets against
the library's own (``ptt_abi``, ``ptt_mesh_abi``, ``ptt_walk_abi``,
``ptt_scan_abi``) before anything launches.
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
SOURCES = ("prim_path.cuh", "fused_prim.cu", "mesh_path.cuh", "fused_mesh.cu", "mesh_walk.cu",
           "scan.cuh", "scan.cu")
# Library name -> its translation unit.
LIBRARIES = {"fused_prim": "fused_prim.cu", "fused_mesh": "fused_mesh.cu",
             "mesh_walk": "mesh_walk.cu", "scan": "scan.cu"}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_f = ctypes.c_float
_i = ctypes.c_int32
_u = ctypes.c_uint32
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
    """The scene's header: counts, and pointers to the primitive and material
    tables (``PttGeom[num_geoms]``, ``PttMaterial[num_materials]``), which
    have any length and live where the reader runs (device or host)."""

    _fields_ = [
        ("num_geoms", _i), ("num_materials", _i),
        ("lobe_glass", _i), ("lobe_mirror", _i), ("lobe_trans", _i), ("lobe_micro", _i),
        ("baby_eps", _f), ("larger_eps", _f), ("ray_eps", _f), ("pad", _i),
        ("geoms", _p), ("materials", _p),
    ]


class PttCamera(ctypes.Structure):
    _fields_ = [
        ("position", _f * 3), ("view", _f * 3), ("up", _f * 3), ("right", _f * 3),
        ("pixel_length", _f * 2), ("aperture", _f), ("focal_dist", _f),
    ]


class PttIterArgs(ctypes.Structure):
    _fields_ = [
        ("scene", _p), ("film_x", _p), ("film_y", _p), ("film_z", _p), ("alive", _p),
        ("next_pixel", _p), ("keys", _p),
        ("cam", PttCamera),
        ("width", _i), ("height", _i), ("n", _i), ("depth", _i),
        ("num_geoms", _i), ("num_materials", _i),
        ("cam_key", _u * 2), ("iter_key", _u * 2),
    ]


class PttBounceArgs(ctypes.Structure):
    _fields_ = [
        ("scene", _p), ("in_f", _p * 9), ("in_bounces", _p), ("u", _p), ("pixel", _p),
        ("chunks", _p), ("out_f", _p * 9), ("out_bounces", _p),
        ("k0", _u), ("k1", _u), ("rng_n", _u), ("n", _i),
        ("num_geoms", _i), ("num_materials", _i),
    ]


class PttMonoArgs(ctypes.Structure):
    _fields_ = [
        ("ray", _p * 6), ("active", _p), ("tlim", _p), ("coef", _p),
        ("tile_aabb", _p), ("center", _p), ("out_t", _p), ("out_tri", _p),
        ("baby_eps", _f), ("eps_succ", _f),
        ("n", _i), ("ct", _i), ("num_tris", _i), ("pad", _i),
    ]


class PttMeshShadeArgs(ctypes.Structure):
    _fields_ = [
        ("scene", _p), ("in_f", _p * 9), ("in_bounces", _p), ("pixel", _p),
        ("mesh_t", _p), ("mesh_n", _p * 3), ("mesh_mat", _p), ("mesh_alb", _p * 3),
        ("prim_win", _p), ("tile_aabb", _p), ("center", _p),
        ("out_f", _p * 9), ("out_bounces", _p), ("out_tlim", _p), ("out_key", _p),
        ("out_win", _p),
        ("k0", _u), ("k1", _u), ("rng_n", _u),
        ("n", _i), ("ct", _i), ("emit", _i), ("mode", _i),
        ("num_geoms", _i), ("num_materials", _i), ("pad", _i),
    ]


class PttWalkArgs(ctypes.Structure):
    _fields_ = [
        ("ray", _p * 6), ("live", _p), ("tlim", _p), ("coef", _p),
        ("tile_aabb", _p), ("center", _p), ("ids", _p), ("tlo", _p), ("cnt", _p),
        ("saabb", _p), ("out_t", _p), ("out_tri", _p),
        ("baby_eps", _f), ("eps_succ", _f),
        ("n", _i), ("ct", _i), ("cs", _i),
    ]


class PttPlanArgs(ctypes.Structure):
    _fields_ = [
        ("ray", _p * 6), ("live", _p), ("tlim", _p), ("tile_aabb", _p),
        ("out_h", _p), ("out_lb", _p),
        ("nb", _i), ("ct", _i),
    ]


class PttBinnedArgs(ctypes.Structure):
    _fields_ = [
        ("ray", _p * 6), ("live", _p), ("tlim", _p), ("coef", _p),
        ("tile_aabb", _p), ("center", _p), ("vt", _p), ("src", _p),
        ("out_t", _p), ("out_tri", _p),
        ("baby_eps", _f), ("eps_succ", _f),
        ("n", _i), ("n_g", _i), ("nv", _i), ("ct", _i),
    ]


# ptt_launch_walk's kind: which of the walk kernels.
WALK_KINDS = ("planned_lanebest", "planned", "streamed", "streamed_super", "sweep",
              "lb_asc", "lb_mm", "epilogue_mono_full", "epilogue_mono_gate",
              "epilogue_mono_mm")


def _walk_abi_expected() -> list:
    from . import intersect_mxu as mxu

    return [
        ctypes.sizeof(PttWalkArgs),
        PttWalkArgs.baby_eps.offset,
        PttWalkArgs.n.offset,
        PttWalkArgs.cs.offset,
        ctypes.sizeof(PttPlanArgs),
        PttPlanArgs.nb.offset,
        ctypes.sizeof(PttBinnedArgs),
        PttBinnedArgs.baby_eps.offset,
        PttBinnedArgs.n.offset,
        ctypes.sizeof(PttMonoArgs),
        PttMonoArgs.baby_eps.offset,
        PttMonoArgs.n.offset,
        mxu.TRI_TILE,
        mxu.COEF_W,
        mxu.RAY_TILE,
        mxu.BINNED_G,
        mxu.PLANNED_MAX_TILES,
        mxu.STREAMED_MAX_TILES,
        mxu.SUPER_TILES,
        mxu.MONO_MAX_TILES,
    ]


def _mesh_abi_expected() -> list:
    from . import intersect_mxu as mxu

    return [
        ctypes.sizeof(PttScene),
        ctypes.sizeof(PttMeshShadeArgs),
        PttMeshShadeArgs.prim_win.offset,
        PttMeshShadeArgs.out_win.offset,
        PttMeshShadeArgs.k0.offset,
        PttMeshShadeArgs.n.offset,
        PttMeshShadeArgs.mode.offset,
        PttMeshShadeArgs.num_geoms.offset,
        ctypes.sizeof(PttGeom),
        ctypes.sizeof(PttMaterial),
        PttScene.geoms.offset,
        mxu.TRI_TILE,
        mxu.COEF_W,
        mxu.KEY_INLINE_MAX_CT,
    ]


def _prim_abi_expected() -> list:
    return [
        ctypes.sizeof(PttScene),
        ctypes.sizeof(PttCamera),
        ctypes.sizeof(PttIterArgs),
        PttIterArgs.next_pixel.offset,
        PttIterArgs.keys.offset,
        PttIterArgs.cam.offset,
        PttIterArgs.cam_key.offset,
        ctypes.sizeof(PttBounceArgs),
        PttBounceArgs.pixel.offset,
        PttBounceArgs.chunks.offset,
        PttBounceArgs.k0.offset,
        PttBounceArgs.n.offset,
        ctypes.sizeof(PttGeom),
        ctypes.sizeof(PttMaterial),
        PttScene.geoms.offset,
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


def _source_hash(sources=SOURCES, flags=NVCC_FLAGS) -> str:
    """The build directory's name: a hash of the ``csrc/`` files
    ``sources`` and the compiler ``flags``."""
    h = hashlib.sha256()
    for name in sources:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _bind_prim(lib) -> tuple:
    lib.ptt_launch_iteration.argtypes = [ctypes.POINTER(PttIterArgs), _p]
    lib.ptt_launch_iteration.restype = _i
    lib.ptt_launch_bounce.argtypes = [ctypes.POINTER(PttBounceArgs), _p]
    lib.ptt_launch_bounce.restype = _i
    lib.ptt_launch_uniforms.argtypes = [_u] * 6 + [_p, _p]
    lib.ptt_launch_uniforms.restype = _i
    return lib.ptt_abi, _prim_abi_expected(), lib.ptt_error_string


def _bind_mesh(lib) -> tuple:
    lib.ptt_launch_mesh_shade.argtypes = [ctypes.POINTER(PttMeshShadeArgs), _p]
    lib.ptt_launch_mesh_shade.restype = _i
    return lib.ptt_mesh_abi, _mesh_abi_expected(), lib.ptt_mesh_error_string


def _bind_walk(lib) -> tuple:
    lib.ptt_launch_walk.argtypes = [ctypes.POINTER(PttWalkArgs), _i, _p]
    lib.ptt_launch_walk.restype = _i
    lib.ptt_launch_binned.argtypes = [ctypes.POINTER(PttBinnedArgs), _p]
    lib.ptt_launch_binned.restype = _i
    lib.ptt_launch_mono.argtypes = [ctypes.POINTER(PttMonoArgs), _p]
    lib.ptt_launch_mono.restype = _i
    lib.ptt_launch_plan_prepass.argtypes = [ctypes.POINTER(PttPlanArgs), _p]
    lib.ptt_launch_plan_prepass.restype = _i
    return lib.ptt_walk_abi, _walk_abi_expected(), lib.ptt_walk_error_string


def _bind_scan(lib) -> tuple:
    from . import scan

    lib.ptt_launch_scan.argtypes = [_p, _p, _p, ctypes.c_int64, _i, _i, _p]
    lib.ptt_launch_scan.restype = _i
    return lib.ptt_scan_abi, [scan.KERNEL_TILE, scan.KERNEL_THREADS], lib.ptt_scan_error_string


_BIND = {"fused_prim": _bind_prim, "fused_mesh": _bind_mesh, "mesh_walk": _bind_walk,
         "scan": _bind_scan}


class KernelLibrary:
    """One loaded library: its ctypes functions and how it was built."""

    def __init__(self, name: str, path: pathlib.Path, build_seconds: float,
                 build_log: str):
        self.name = name
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log
        lib = ctypes.CDLL(str(path))
        abi, want, err = _BIND[name](lib)
        abi.argtypes = [ctypes.POINTER(_i), _i]
        abi.restype = _i
        err.argtypes = [_i]
        err.restype = ctypes.c_char_p
        self._error_string = err
        self.lib = lib
        buf = (_i * len(want))()
        count = abi(buf, len(want))
        got = list(buf)[:count]
        if got != want:
            raise RuntimeError(
                f"ctypes mirror of the kernel structs disagrees with {path}: "
                f"library {got}, ctypes {want}"
            )

    def check(self, code: int, what: str) -> None:
        if code != 0:
            msg = self._error_string(code).decode()
            raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def load(name: str = "fused_prim") -> KernelLibrary:
    """Build (if needed) and load the kernel library ``name`` (a key of
    ``LIBRARIES``).  The first call builds every library, in parallel."""
    return load_all()[name]


@functools.lru_cache(maxsize=1)
def load_all() -> dict:
    """Build the missing libraries with one ``nvcc`` each, all started
    together, and load them all: name -> ``KernelLibrary``."""
    out_dir = BUILD_ROOT / _source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, src in LIBRARIES.items():
        lib_path = out_dir / f"libptt_{name}.so"
        if lib_path.is_file():
            continue
        tmp = out_dir / f"libptt_{name}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        jobs[name] = (cmd, proc, tmp, lib_path, time.perf_counter())
    built, failed = {}, []
    for name, (cmd, proc, tmp, lib_path, t0) in jobs.items():
        stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        log = f"$ {' '.join(cmd)}\n{stdout}{stderr}"
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
            continue
        (out_dir / f"build_{name}.log").write_text(log)
        os.replace(tmp, lib_path)
        built[name] = (seconds, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    libs = {}
    for name in LIBRARIES:
        lib_path = out_dir / f"libptt_{name}.so"
        seconds, log = built.get(name, (0.0, None))
        if log is None:
            log_path = out_dir / f"build_{name}.log"
            log = log_path.read_text() if log_path.is_file() else ""
        libs[name] = KernelLibrary(name, lib_path, seconds, log)
    return libs


def stream_handle(device: torch.device) -> int:
    """The handle of ``device``'s current CUDA stream, read on every call
    (never cached: the caller may have made another stream current).
    PyTorch's own binding for it, the one its code generators call, returns
    the handle as an int; ``torch.cuda.current_stream()`` builds a Stream
    object around the same handle, at some ten times the host cost (PERF.md,
    the scan's host split).

    A kernel launches on the CUDA runtime's current device, so a device
    that names another index is refused: its launch would fail or land on
    the current device.  Launch under ``torch.cuda.device(device)``, as
    ``Renderer`` and ``parallel.shardmap`` do."""
    current = torch._C._cuda_getDevice()  # torch.cuda.current_device() without its checks
    if device.index is not None and device.index != current:
        raise RuntimeError(
            f"a kernel for {device} would launch on the current device cuda:{current}; "
            f"launch it under torch.cuda.device({device.index})"
        )
    return torch._C._cuda_getCurrentRawStream(current)
