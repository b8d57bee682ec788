"""A run with the timed path broken underneath comes out not correct: the
harness's run of each cell on the CPU at a small size (past its look for a
card), once for each fault the cell can have.  One card has no exchange
between chips to leave out."""

import time

import pytest
import torch

import run
from spec import Spec

from project3_cuda_path_tracer_2025_tpu_torch.models import renderer
from project3_cuda_path_tracer_2025_tpu_torch.ops import film as film_ops

CELLS = [("cornell.progressive", (12, 12)), ("cornell.orbit", (12, 12)),
         ("cornell_mesh_200k.progressive", (8, 8))]


def unchanged(monkeypatch):
    """A step that returns its state unchanged (in a step's time, so the
    window holds as many steps as a sound one)."""
    def dispatch(self):
        time.sleep(0.01)
        self.iteration += self._spp_stride
        return self.film, torch.zeros(self.static.trace_depth, dtype=torch.int32)
    monkeypatch.setattr(renderer.Renderer, "_dispatch", dispatch)


def half_left_out(monkeypatch):
    """Half of the batch left out: the step traces every pixel, and the
    second half of the film keeps what it held before."""
    step = renderer.Renderer._dispatch

    def dispatch(self):
        n = self.static.pixel_count
        before = [f[n // 2:].clone() for f in self.film]
        out = step(self)
        for f, b in zip(self.film, before):
            f[n // 2:] = b
        return out
    monkeypatch.setattr(renderer.Renderer, "_dispatch", dispatch)


def altered(monkeypatch):
    """An answer altered where it is produced: each path's red and green
    are swapped as its colour is added to the film."""
    add = film_ops.accumulate

    def accumulate(film, paths, *a, **k):
        c = paths.color
        return add(film, paths._replace(color=type(c)(c.y, c.x, c.z)), *a, **k)
    monkeypatch.setattr(film_ops, "accumulate", accumulate)


def run_small(cell, res, seed=424242):
    spec = Spec.load()
    result, _ = run.run_cell(spec, spec.cell(cell), seed, 0.3, False, device="cpu", res=res)
    return result


@pytest.mark.parametrize("cell,res", CELLS)
def test_sound_run_is_correct(cell, res):
    result = run_small(cell, res)
    assert result["correct"] and result["attempted"] > 0, result


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered])
@pytest.mark.parametrize("cell,res", CELLS)
def test_fault_is_not_correct(cell, res, fault, monkeypatch):
    fault(monkeypatch)
    result = run_small(cell, res)
    assert not result["correct"], result
    assert any(v["value"] > v["limit"] for v in result["check"].values())
