"""Short runs of cells on the card through the harness past its look for a
card (``cornell.progressive`` plain and traced, the mesh cell traced):
correct, with every metric the cell reports.  Skips without a CUDA
device."""

import pytest

import run
from spec import Spec

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("traced", [False, True])
def test_cell_on_the_card(card, traced):
    spec = Spec.load()
    cell = spec.cell("cornell.progressive")
    result, rows = run.run_cell(spec, cell, 2**31 + 99, 2.0, traced, device=card.type)
    assert result["correct"], rows
    names = spec.per_layer(cell) if traced else spec.end_to_end(cell)
    assert set(result["metrics"]) == {m["name"] for m in names}
    assert result["device"]["platform"] == "gpu" and result["device"]["memory_peak_bytes"] > 0
    if traced:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert result["breakdown"]["device_ops"][0][0] == "ptt_iteration_kernel"
        assert 0 < result["metrics"]["iteration_roofline_pct"]["value"] < 100


def test_mesh_cell_traced_on_the_card(card):
    """The traced mesh cell: the walks' share of the bound that the
    reference's count sets, between 0 and 100."""
    spec = Spec.load()
    cell = spec.cell("cornell_mesh_200k.progressive")
    result, rows = run.run_cell(spec, cell, 2**31 + 101, 2.0, True, device=card.type)
    assert result["correct"], rows
    assert set(result["metrics"]) == {m["name"] for m in spec.per_layer(cell)}
    assert 0 < result["metrics"]["walk_roofline_pct"]["value"] < 100
