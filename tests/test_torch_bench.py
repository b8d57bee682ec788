"""The port's bench (``bench_torch.py``, ``project3_cuda_path_tracer_2025_tpu_torch/bench.py``)
and mesh roofline (``scripts/torch_roofline_mesh.py``) on the CPU.

Without a card the bench prints its error-shaped line and exits 1 (no
fallback); its body, ``measure``, runs on the CPU at a small size and
returns exactly ``bench.py``'s keys; the roofline script runs the plain
walk and times nothing; none of the new modules imports JAX.
"""

import ast
import json
import pathlib
import subprocess
import sys

import pytest
import torch

from project3_cuda_path_tracer_2025_tpu_torch import bench

REPO = pathlib.Path(__file__).resolve().parent.parent


def _bench_py_keys() -> set:
    """Every key of the line ``bench.py`` prints (its ``mesh_roofline`` too)."""
    tree = ast.parse((REPO / "bench.py").read_text())
    line = next(n for n in ast.walk(tree) if isinstance(n, ast.Dict)
                and any(isinstance(k, ast.Constant) and k.value == "baseline_ms"
                        for k in n.keys))
    return {k.value for n in ast.walk(line) if isinstance(n, ast.Dict)
            for k in n.keys if isinstance(k, ast.Constant)}


def test_bench_without_a_card_prints_an_error_and_exits_1():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(REPO / "bench_torch.py")], capture_output=True,
                         text=True, timeout=300, cwd=str(REPO))
    assert out.returncode == 1
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["value"] is None and rec["vs_baseline"] is None and "CUDA" in rec["error"]
    assert rec["metric"] == bench.METRIC and rec["unit"] == "ms/frame"


def test_measure_on_the_cpu_has_bench_py_keys():
    rec = bench.measure("cpu", res=16, batch=2, warmup=1, reps=1, mesh=False)
    keys = _bench_py_keys()
    assert "mesh_roofline" in keys and len(keys) == 15
    assert set(bench.KEYS) == keys and len(bench.KEYS) == len(keys)
    assert set(rec) == keys - {"mesh_roofline"}  # bench.py leaves it out too when off
    assert rec["metric"] == "cornell.json 800x800 depth-8 ms/frame"
    assert rec["film_finite"] is True and rec["device"] == "cpu"
    assert rec["frames_timed"] == 2 and rec["spp_per_launch"] == 2
    assert rec["value"] > 0 and rec["vs_baseline"] == round(bench.BASELINE_MS / rec["value"], 3)
    assert bench.SCENE == REPO / "scenes" / "cornell.json"


def test_mesh_roofline_failure_is_a_note(monkeypatch):
    monkeypatch.setattr(bench, "ROOFLINE", REPO / "scripts" / "no_such_script.py")
    note = bench.mesh_roofline(torch.device("cpu"))
    assert set(note) == {"error"} and note["error"]


def test_roofline_script_on_the_cpu():
    out = subprocess.run([sys.executable, "scripts/torch_roofline_mesh.py", "--device", "cpu",
                          "--res", "8"], capture_output=True, text=True, timeout=300,
                         cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    recs = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    assert len(recs) == 1
    rec = recs[0]
    assert rec["mesh_scene"] == "cornell_mesh_5k.json" and rec["traversal"] == "mono"
    for key in ("kernel_ms_per_bounce", "us_per_visit", "share_of_bound", "hbm_gbps"):
        assert rec[key] is None, key
    assert rec["visits"] == rec["live_blocks"] * rec["tiles"] > 0
    assert rec["plan_visits"] > 0 and rec["live_rays"] > 0
    assert rec["bound_ms"] > 0 and rec["bound_by"] in ("bytes", "operations")
    assert rec["card"] == "cpu"
    for gone in ("mxu_tflops", "mxu_peak_frac", "vpu_gelem_ops"):  # the TPU's units
        assert gone not in rec


def test_new_modules_import_no_jax():
    code = (
        "import importlib.util, sys\n"
        f"sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'scripts')!r}]\n"
        "import project3_cuda_path_tracer_2025_tpu_torch.bench\n"
        "import project3_cuda_path_tracer_2025_tpu_torch.entry\n"
        "for name, path in (('bench_torch', 'bench_torch.py'),\n"
        "                   ('graft_entry_torch', 'graft_entry_torch.py'),\n"
        "                   ('torch_roofline_mesh', 'scripts/torch_roofline_mesh.py')):\n"
        f"    spec = importlib.util.spec_from_file_location(name, {str(REPO)!r} + '/' + path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.split('.')[0] == 'project3_cuda_path_tracer_2025_tpu']\n"
        "print('BAD', bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD []" in out.stdout
