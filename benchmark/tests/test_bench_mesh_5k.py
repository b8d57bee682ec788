"""The cell ``cornell_mesh_5k.progressive`` (the open 5k box, ``ico4.obj``
shaded by its vertex normals, the mono walk #4 on the card): on the CPU at
a small size a sound run is correct and each planted fault is not, the
reference in bfloat16 fails the cell's limits and in float32 reads 0, and
the cell reports the metrics ``BENCHMARK.json`` lists for it; on the card
(``gpu``-marked, skips without one) a short traced run is correct and
reads #4 against the walk's bound."""

import pytest
import torch

import check
import control
import run
from spec import Spec
from test_bench_faults import altered, half_left_out, run_small, unchanged

CELL = "cornell_mesh_5k.progressive"
END_TO_END = {"frame_ms.mesh", "setup_s"}
PER_LAYER = {"launches_per_frame.mesh", "glue_device_ms_per_frame", "host_reads_per_frame",
             "kernel_device_ms_per_frame", "device_idle_pct.mesh", "walk_roofline_pct.mono"}


@pytest.mark.parametrize("res", [(8, 8), (12, 12)])
def test_sound_run_is_correct(res):
    result = run_small(CELL, res)
    assert result["correct"] and result["attempted"] > 0, result
    assert set(result["metrics"]) == END_TO_END


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered])
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result = run_small(CELL, (8, 8))
    assert not result["correct"], result
    assert any(v["value"] > v["limit"] for v in result["check"].values())


def test_control_fails_the_limits():
    spec = Spec.load()
    cell, limits = spec.cell(CELL), spec.limits(CELL)
    for seed in (11, 12, 13):
        low = control.control_numbers(spec, cell, seed, 3, "cpu", torch.bfloat16, res=(16, 16))
        correct, _ = check.decide(low, limits)
        assert not correct, (seed, low)
        same = control.control_numbers(spec, cell, seed, 3, "cpu", torch.float32, res=(16, 16))
        assert all(v == 0.0 for v in same.values()), same


def test_cell_reports_its_metrics():
    """Untraced the mesh frame and the set-up; traced the five mesh metrics
    of the 200k cell and #4's share of the walk's bound, which the walk
    roofline's own file reads, and not ``walk_roofline_pct``."""
    spec = Spec.load()
    cell = spec.cell(CELL)
    assert {m["name"] for m in spec.end_to_end(cell)} == END_TO_END
    assert {m["name"] for m in spec.per_layer(cell)} == PER_LAYER
    assert cell["chips"] == 1
    rec = {"frames": 2, "walk_work": (3.35e8, 67e8),  # 0.1 ms by bytes and by operations
           "device": [("void ptt_mono_kernel<512>(Args)", 0, 2_000_000),
                      ("void at::native::fill_kernel<int>(int)", 2_000_000, 3_000_000)]}
    assert spec.reader("walk_roofline_pct.mono")(rec) == pytest.approx(100.0 * 0.1 / 1.0)


@pytest.mark.gpu
def test_cell_traced_on_the_card(card):
    spec = Spec.load()
    cell = spec.cell(CELL)
    result, rows = run.run_cell(spec, cell, 2**31 + 103, 2.0, True, device=card.type)
    assert result["correct"], rows
    assert set(result["metrics"]) == PER_LAYER
    assert 0 < result["metrics"]["walk_roofline_pct.mono"]["value"] < 100
    assert "ptt_mono_kernel" in [op for op, _ in result["breakdown"]["device_ops"]]
