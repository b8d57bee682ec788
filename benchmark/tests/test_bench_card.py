"""One short run of a cell on the card, plain and traced, through the
harness past its look for a card: correct, with every metric the cell
reports.  Skips without a CUDA device."""

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
