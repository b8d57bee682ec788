"""The harness on the CPU: files found by name, the metrics' arithmetic on
synthetic traces, the frozen iteration count, the orbit input's
determinism, and the command's refusal without a card."""

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest

import loops
import run
import tracing
import work
from conftest import BENCH
from spec import Spec, SpecError

ROOT = BENCH.parent


def test_spec_finds_every_named_file():
    spec = Spec.load()
    for cell in spec.doc["workloads"]:
        config = spec.config(cell["config"])
        assert config["name"] == cell["config"] and "scene" in config
        assert loops.params(spec.traffic(cell["traffic"]))["display"] in ("each", "end")
        assert spec.limits(cell["name"])
        for m in spec.end_to_end(cell) + spec.per_layer(cell):
            assert callable(spec.reader(m["name"]))
        assert any(m["name"] == "setup_s" for m in spec.end_to_end(cell))
        assert len(spec.end_to_end(cell)) >= 2 and spec.per_layer(cell)
    with pytest.raises(SpecError):
        spec.cell("no_such_cell")


def test_new_cell_from_files_only(tmp_path):
    """A configuration, a traffic mix and a metric added as new files and
    entries run without an edit to any file the benchmark has."""
    root = tmp_path / "repo"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    here = root / "benchmark"
    config = json.loads((here / "configs" / "cornell.json").read_text())
    config["name"] = "cornell_small"
    config["render"] = {"spp_per_launch": 2}
    (here / "configs" / "cornell_small.json").write_text(json.dumps(config))
    # A mix the files do not have: 2 spp a displayed step, drags of 3 steps.
    traffic = {"why": "a test", "spp_per_step": 2, "display": "each", "drag_frames": 3,
               "still_frames": 2, "step_min": 0.01, "step_max": 0.02, "phi_span": 0.1,
               "theta_span": 0.1, "check_pixels": 16, "check_drag_frames": 2,
               "check_still_frames": 2}
    (here / "traffic" / "orbit_small.json").write_text(json.dumps(traffic))
    (here / "metrics" / "spp_per_s.py").write_text(
        "def read(rec):\n    return rec['frames'] / rec['window_s']\n")
    (here / "limits" / "cornell_small.orbit_small.json").write_text(
        json.dumps({"image_mean_gap": {"limit": 1e-6}}))
    doc["configs"].append({"name": "cornell_small", "source": "https://example.org",
                           "file": "benchmark/configs/cornell_small.json", "reduced": [],
                           "why": "a test"})
    doc["workloads"].append({"name": "cornell_small.orbit_small",
                             "config": "cornell_small", "traffic": "orbit_small",
                             "chips": 1, "why": "a test"})
    doc["end_to_end"].append({"name": "spp_per_s", "unit": "spp/s", "better": "higher",
                              "bound": 0.05, "source": "host_clock",
                              "workloads": ["cornell_small.orbit_small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    before = {p: p.read_bytes() for p in BENCH.rglob("*") if p.is_file()
              and "__pycache__" not in p.parts}

    spec = Spec.load(root, here)
    result, rows = run.run_cell(spec, spec.cell("cornell_small.orbit_small"), 5, 0.2,
                                False, device="cpu", res=(8, 8))
    assert result["correct"] and rows[0][0] == "image_mean_gap"
    assert result["attempted"] > 0 and set(result["metrics"]) == {"setup_s", "spp_per_s"}
    assert result["metrics"]["spp_per_s"]["value"] > 0
    assert before == {p: p.read_bytes() for p in before}


def _rec():
    ms = 1_000_000
    return {
        "frames": 4, "displays": 2, "window": [0, 10 * ms], "host_reads": 2.0,
        "device": [("void ptt_iteration_kernel(PttIterArgs)", 1 * ms, 3 * ms),
                   ("void at::native::fill_kernel<int>(int)", 2 * ms, 4 * ms),
                   ("Memcpy DtoH (Device -> Pageable)", 6 * ms, 7 * ms),
                   ("void ptt_streamed_kernel<512>(Args)", 9 * ms, 12 * ms)],
        "spans": [("traced", 0, 10 * ms), ("input", 0, 1 * ms), ("step", 1 * ms, 2 * ms),
                  ("preview", 4 * ms, 8 * ms), ("input", 8 * ms, 9 * ms)],
        "work": (1.0e9, 67e9),  # 1 ms by operations, 0.3 ms by bytes
        "walk_work": (3.35e8, 67e8),  # 0.1 ms by bytes and by operations
    }


def test_interval_arithmetic():
    assert tracing.union_ns([(0, 4), (2, 6), (8, 9), (20, 30)], 0, 10) == 7
    assert tracing.union_ns([(5, 20)], 0, 10) == 5
    assert tracing.gaps([(1, 3), (2, 4), (6, 7)], 0, 10) == [(0, 1), (4, 6), (7, 10)]
    assert tracing.gaps([], 0, 10) == [(0, 10)]


@pytest.mark.parametrize("metric,expected", [
    ("launches_per_frame", 1.0),
    ("launches_per_frame.mesh", 1.0),
    ("device_idle_pct", 100.0 * (1 - 5 / 10)),  # busy [1,4] [6,7] [9,10]
    ("device_idle_pct.mesh", 50.0),
    ("device_idle_pct.orbit", 50.0),
    ("glue_device_ms_per_frame", 3.0 / 4),
    ("kernel_device_ms_per_frame", 5.0 / 4),
    ("host_reads_per_frame", 2.0),
    ("host_enqueue_ms.orbit", 3.0 / 2),
    ("iteration_roofline_pct", 100.0 * 1.0 / (2.0 / 4)),
    ("walk_roofline_pct", 100.0 * 0.1 / (3.0 / 4)),  # ptt_streamed_kernel, 3 ms
])
def test_per_layer_arithmetic(metric, expected):
    assert Spec.load().reader(metric)(_rec()) == pytest.approx(expected)


def test_reader_finds_nothing():
    rec = _rec()
    rec["device"] = [d for d in rec["device"] if "iteration" not in d[0]]
    assert Spec.load().reader("iteration_roofline_pct")(rec) is None
    del rec["work"]
    assert Spec.load().reader("iteration_roofline_pct")(rec) is None


def test_walk_reader_finds_nothing():
    """No walk kernel in the record (the iteration kernel alone), or no
    count: nothing to read."""
    rec = _rec()
    rec["device"] = [d for d in rec["device"] if "streamed" not in d[0]]
    assert Spec.load().reader("walk_roofline_pct")(rec) is None
    rec = _rec()
    del rec["walk_work"]
    assert Spec.load().reader("walk_roofline_pct")(rec) is None


def test_walk_roofline_is_the_200k_cells_alone():
    spec = Spec.load()
    reports = [c["name"] for c in spec.doc["workloads"]
               if "walk_roofline_pct" in {m["name"] for m in spec.per_layer(c)}]
    assert reports == ["cornell_mesh_200k.progressive"]


@pytest.mark.parametrize("metric,expected", [
    ("frame_ms", 2000.0 / 400), ("frame_ms.mesh", 2000.0 / 400), ("display_ms", 2000.0 / 4),
    ("setup_s", 7.5),
    ("display_p95_ms", float(np.percentile([0.1, 0.2, 0.3, 1.0], 95)) * 1e3),
])
def test_end_to_end_arithmetic(metric, expected):
    rec = {"setup_s": 7.5, "window_s": 2.0, "frames": 400, "displays": 4,
           "latencies_s": [0.1, 0.2, 0.3, 1.0]}
    assert Spec.load().reader(metric)(rec) == pytest.approx(expected)


def test_breakdown_labels_gaps_by_host_span():
    b = tracing.breakdown(_rec())
    assert b["device_ops"][0] == ["ptt_streamed_kernel", pytest.approx(3e-3)]
    # Idle [0, 1] and [7, 9] fall in input spans, [4, 6] in the preview's.
    assert dict(b["idle_gaps"]) == pytest.approx({"input": 3e-3, "preview": 2e-3})
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_iteration_work_by_hand():
    # 4 pixels, 2 boxes and 1 sphere, alive after each of 3 bounces: 3, 1, 0.
    nbytes, ops = work.iteration_work(4, 2, 1, [3, 1, 0])
    assert nbytes == 4 * 24 + 3 * 4
    per_ray = 25 + 2 * 78 + 60 + 100
    assert ops == 4 * 45 + (4 + 3 + 1) * per_ray
    ms, by = work.bound_ms(3.35e12, 67e12 / 2)
    assert ms == pytest.approx(1e3) and by == "bytes"


def test_walk_work_by_hand():
    # Two bounces: 10 then 4 rays alive before, 7 then 2 pairs, 5 then 2 triangles.
    nbytes, ops = work.walk_work([[10, 7, 5], [4, 2, 2]])
    assert nbytes == 14 * 32 + 7 * 36 and ops == 9 * work.OPS_TRIANGLE


def test_orbit_input_is_drawn_from_the_seed():
    traffic = loops.params(Spec.load().traffic("orbit"))

    def moves(seed):
        _, (_, rng, _) = run.seed_streams(seed)
        plan = loops.InputPlan(traffic, rng)
        return [plan.move(i) for i in range(3 * (traffic["drag_frames"]
                                                 + traffic["still_frames"]))]

    a, b = moves(2**31 + 7), moves(2**31 + 7)
    assert a == b and a != moves(8)
    period = traffic["drag_frames"] + traffic["still_frames"]
    for c in range(3):
        drag = a[c * period:c * period + traffic["drag_frames"]]
        assert all(m is not None for m in drag)
        assert all(m is None for m in a[c * period + traffic["drag_frames"]:(c + 1) * period])
        steps = [np.hypot(*m) for m in drag]
        assert min(steps) >= traffic["step_min"] and max(steps) <= traffic["step_max"]
    phi = np.cumsum([m[0] for m in a if m is not None])
    theta = np.cumsum([m[1] for m in a if m is not None])
    assert np.abs(phi).max() <= traffic["phi_span"] + traffic["step_max"]
    assert np.abs(theta).max() <= traffic["theta_span"] + traffic["step_max"]


def test_forbidden_modules_compare_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "project3_cuda_path_tracer_2025_tpu_torch_x", sys)
    assert "project3_cuda_path_tracer_2025_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]


def test_run_refuses_without_a_card():
    """No CUDA device: exit code 2, nothing on standard output, no CPU run."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "cornell.progressive", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
                         timeout=300)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_changed_asset_is_refused(tmp_path):
    """A configuration's frozen asset that no longer hashes to its value
    stops the run before anything is measured."""
    root = tmp_path / "repo"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    spec = Spec.load(root, root / "benchmark")
    name = [c["name"] for c in spec.doc["configs"]
            if "sha256" in json.loads((ROOT / c["file"]).read_text())][0]
    cfg = json.loads((ROOT / spec._named("configs", name)["file"]).read_text())
    for rel in cfg["sha256"]:
        (root / cfg["assets"] / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / cfg["assets"] / rel).write_text("v 0 0 0\n")
    with pytest.raises(SpecError, match="has changed"):
        spec.config(name)
    assert Spec.load().config(name)["dir"] == str(ROOT / cfg["assets"])


def test_unknown_traffic_parameter_is_refused():
    with pytest.raises(ValueError, match="unknown"):
        loops.params({"drag_frame": 3})
    with pytest.raises(ValueError, match="display"):
        loops.params({"display": "sometimes"})


def test_variant_metric_reads_its_base_file():
    spec = Spec.load()
    assert spec.reader("frame_ms.any_variant")({"window_s": 1.0, "frames": 4}) == 250.0
    with pytest.raises(SpecError):
        spec.reader("no_such_metric.mesh")
