"""The port's spans (``utils/timers.py``: ``span``, ``host_read``) on the CPU.

Without a profiler a span is one shared no-op.  Under
``torch.profiler.profile``, one step of the 5k mesh at 16x16 with the fused
mesh bounce and the binned traversal (their plain versions here) records
``ptt.mesh.bounce`` once a bounce, in bounce order, inside it the
prelude (first bounce), the sort (where the bounce resorts), the plan, the
walk and the shade, nested in time, and inside the shade the surface (the
shade's plain version resolves it in torch; on the card the kernel does,
and no ``mesh.surface`` opens), with ``read.live_pos``
and ``read.overflow`` once each inside the plan; with the default (mono)
traversal, the walk and no plan and no read; the film and the alive
counts are the same bit for bit with the profiler as without.  An orbit
display records the camera, the step and the preview with its reads.
"""

import pathlib

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer
from project3_cuda_path_tracer_2025_tpu_torch.scene import load_scene, set_resolution
from project3_cuda_path_tracer_2025_tpu_torch.utils import timers

REPO = pathlib.Path(__file__).resolve().parent.parent
MESH = str(REPO / "scenes" / "cornell_mesh_5k.json")
DOF = str(REPO / "scenes" / "cornell_dof.json")
DEPTH = 4
BINNED_MESH = dict(mesh_intersector="mxu", fused_bounce="on", ray_sorting="on",
                   mxu_traversal="binned")
STAGES = ("mesh.prelude", "mesh.sort", "mesh.plan", "mesh.walk", "mesh.shade", "mesh.surface")

torch.set_num_threads(1)


def _scene(path, res, depth):
    s = set_resolution(load_scene(path), res, res)
    s.state.trace_depth = depth
    return s


def _profiled(fn):
    """``fn()`` under a CPU profiler -> [(name, start_ns, end_ns)] of the
    port's spans, by start."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        fn()
    spans = []
    for e in p.profiler.kineto_results.events():
        if e.name().startswith(timers.SPAN_PREFIX):
            spans.append((e.name()[len(timers.SPAN_PREFIX):], e.start_ns(), e.end_ns()))
    return sorted(spans, key=lambda s: (s[1], -s[2]))


def _inside(spans, outer):
    _, s0, e0 = outer
    return [s for s in spans if s is not outer and s0 <= s[1] and s[2] <= e0]


@pytest.mark.parametrize("make", [
    lambda: timers.span("mesh.plan"),
    lambda: timers.span("mesh.bounce"),
    lambda: timers.host_read("live_pos"),
], ids=["plan", "bounce", "host_read"])
def test_no_profiler_gives_the_shared_noop(make):
    first = make()
    assert first is make() is timers._NO_SPAN
    with first:
        pass


def _mesh_step_spans(cfg, depth):
    """One step of the 5k mesh at 16x16 with and without the profiler: the
    films and alive counts bit-equal -> (the traced step's spans, its
    ``mesh.bounce`` spans, the inner span names of each bounce)."""
    scene = _scene(MESH, 16, depth)
    plain = Renderer(scene, cfg, seed=3, device="cpu")
    plain.step()
    traced = Renderer(scene, cfg, seed=3, device="cpu")
    spans = _profiled(traced.step)

    for a, b in zip(plain._flat_film(), traced._flat_film()):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(plain._alive_counts, traced._alive_counts)
    assert sum(float(x.sum()) for x in plain._flat_film()) > 0

    step = [s for s in spans if s[0] == "renderer.step_many"]
    assert len(step) == 1
    bounces = [s for s in spans if s[0] == "mesh.bounce"]
    assert len(bounces) == depth
    assert all(b in _inside(spans, step[0]) for b in bounces)
    names = [[s[0] for s in _inside(spans, b)] for b in bounces]
    for d, inner in enumerate(names):
        assert inner.count("mesh.prelude") == (d == 0)
        order = [n for n in inner if n in STAGES]
        assert order == [n for n in STAGES if n in order], (d, order)
    accumulate = [s for s in spans if s[0] == "film.accumulate"]
    assert len(accumulate) == 1 and accumulate[0][1] >= bounces[-1][2]
    assert all(s[0] in ("renderer.step_many", "film.accumulate")
               or s[0].startswith(("mesh.", "read.")) for s in spans)
    return spans, bounces, names



@pytest.mark.parametrize("sort_every", [1, 2])
def test_mesh_step_spans_by_stage(sort_every):
    cfg = RenderConfig(ray_sort_every=sort_every, **BINNED_MESH)
    spans, bounces, names = _mesh_step_spans(cfg, DEPTH)
    for d, (bounce, inner) in enumerate(zip(bounces, names)):
        assert inner.count("mesh.sort") == (d % sort_every == 0)
        for stage in ("mesh.plan", "mesh.walk", "mesh.surface", "mesh.shade"):
            assert inner.count(stage) == 1, (d, stage, inner)
        assert inner.count("read.live_pos") == inner.count("read.overflow") == 1
        plan = [s for s in _inside(spans, bounce) if s[0] == "mesh.plan"][0]
        assert sorted(s[0] for s in _inside(spans, plan)) == ["read.live_pos", "read.overflow"]
        shade = [s for s in _inside(spans, bounce) if s[0] == "mesh.shade"][0]
        assert [s[0] for s in _inside(spans, shade)] == ["mesh.surface"]


def test_mono_mesh_step_spans_by_stage():
    """The default traversal of the 5k mesh (5 tiles: the mono walk, its
    plain version here) at depth 8: each bounce opens one ``mesh.walk``
    around the walk, and no ``mesh.plan`` and no host read, since the
    route builds no plan and reads nothing."""
    cfg = RenderConfig(**dict(BINNED_MESH, mxu_traversal="auto"))
    _, _, names = _mesh_step_spans(cfg, 8)
    for d, inner in enumerate(names):
        assert inner.count("mesh.sort") == 1
        for stage in ("mesh.walk", "mesh.surface", "mesh.shade"):
            assert inner.count(stage) == 1, (d, stage, inner)
        assert "mesh.plan" not in inner, (d, inner)
        assert not [n for n in inner if n.startswith("read.")], (d, inner)


@pytest.mark.parametrize("kw,glue_per_bounce", [
    (dict(fused_bounce="on"), 0),
    (dict(fused_bounce="on", ray_sort_every=2), 0),
    (dict(fused_bounce="on", ray_sort_mode="morton"), 1),
    (dict(fused_bounce="off"), 1),
], ids=["fused", "fused, every 2", "fused, morton", "unfused"])
def test_key_glue_spans_count_the_torch_keys(kw, glue_per_bounce, monkeypatch):
    """``ptt.mesh.key_glue`` marks a sort key built in torch.  On the 80k
    mesh (79 tiles, past the old 24-tile rule) with sorting on, the fused
    bounce takes every signature key from the kernels (the prelude's at
    bounce 0, the shade's after it; their plain versions here): no span in
    the frame, and the shade emits the key only for a next bounce that
    sorts by it.  Mode "morton" and the unfused route (``fused_bounce="off"``,
    the MXU intersector) build one in torch a sorted bounce."""
    from project3_cuda_path_tracer_2025_tpu_torch.ops import fused

    emits, shade = [], fused.fused_mesh_shade_plain

    def spy(*a, **k):
        emits.append(a[8])
        return shade(*a, **k)

    monkeypatch.setattr(fused, "fused_mesh_shade_plain", spy)
    depth = 4
    scene = _scene(str(REPO / "scenes" / "cornell_mesh_80k.json"), 8, depth)
    cfg = RenderConfig(mesh_intersector="mxu", ray_sorting="on", **kw)
    r = Renderer(scene, cfg, seed=2, device="cpu")
    assert r.dev.mxu_mesh.tile_aabb.shape[0] > 24
    names = [s[0] for s in _profiled(r.step)]
    sorted_bounces = len(range(0, depth, cfg.ray_sort_every))
    assert names.count("mesh.key_glue") == glue_per_bounce * sorted_bounces
    fused_on = cfg.fused_bounce == "on"
    assert names.count("mesh.bounce") == (depth if fused_on else 0)
    if fused_on:
        keyed = [cfg.ray_sort_mode != "morton" and (d + 1) % cfg.ray_sort_every == 0
                 for d in range(depth - 1)]
        assert emits == [("tlim+key" if k else "tlim") for k in keyed] + [""]


def test_orbit_display_spans():
    r = Renderer(_scene(DOF, 16, 3), RenderConfig(), seed=1, device="cpu")
    r.step_many(1, sync=False)

    def display():
        r.orbit_camera(0.01, -0.02)
        r.step_many(1, sync=False)
        r.preview_image(8, 8)
        r.image()

    spans = _profiled(display)
    top = [s[0] for s in spans if not any(s in _inside(spans, o) for o in spans)]
    assert top == ["renderer.orbit_camera", "renderer.step_many", "renderer.preview",
                   "renderer.image"]
    preview = [s for s in spans if s[0] == "renderer.preview"][0]
    assert [s[0] for s in _inside(spans, preview)] == ["read.preview_grid", "read.preview_grid",
                                                       "read.preview"]
    image = [s for s in spans if s[0] == "renderer.image"][0]
    assert [s[0] for s in _inside(spans, image)] == ["read.film"]


def test_step_many_records_frame_times_only_when_synced():
    r = Renderer(_scene(DOF, 8, 2), RenderConfig(), seed=1, device="cpu")
    r.step_many(3, sync=False)
    assert r.stats.times_ms == [] and r.iteration == 3
    r.step_many(2)
    assert len(r.stats.times_ms) == 2 and r.stats.mean_ms > 0
