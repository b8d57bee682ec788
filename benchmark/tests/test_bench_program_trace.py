"""``program_trace.py`` on the CPU: the six program-span readers' arithmetic
on a hand-built record, nothing read without the program's spans, the
existing readers unchanged by them, the idle gaps by program span, the
launch times matched by correlation id on hand-built profiler events, and
one profiled CPU step of the port."""

import pathlib
import types

import pytest

import program_trace
import tracing
from spec import Spec

MS = 1_000_000
REPO = pathlib.Path(__file__).resolve().parents[2]


def _rec():
    """Two spp frames, two displays; device activities with their launch
    times, the harness's spans and the program's."""
    return {
        "frames": 2, "displays": 2, "window": [0, 20 * MS], "host_reads": 1.0,
        "device": [("void at::native::reduce_kernel<int>(int)", 2 * MS, 4 * MS),
                   ("void at::native::elementwise_kernel<int>(int)", 4 * MS, 5 * MS),
                   ("void ptt_binned_kernel<512>(Args)", 6 * MS, 9 * MS),
                   ("Memcpy DtoH (Device -> Pageable)", 12 * MS, 13 * MS),
                   ("void at::native::fill_kernel<int>(int)", 16 * MS, 17 * MS)],
        "launched_ns": [1 * MS, 3 * MS, 5 * MS, 11 * MS, None],
        "spans": [("traced", 0, 20 * MS), ("input", 0, MS // 2), ("step", MS // 2, 14 * MS),
                  ("preview", 14 * MS, 18 * MS)],
        "program_spans": [
            ("renderer.orbit_camera", 0, MS // 2),
            ("renderer.step_many", MS // 2, 14 * MS),
            ("mesh.bounce", 1 * MS, 13 * MS),
            ("mesh.sort", 1 * MS, 2 * MS),
            ("mesh.plan", 2 * MS, 4 * MS),
            ("read.live_pos", 3 * MS + MS // 2, 4 * MS),
            ("mesh.walk", 4 * MS, 6 * MS),
            ("mesh.plan", 10 * MS, 13 * MS),
            ("read.overflow", 11 * MS, 13 * MS),
            ("renderer.preview", 14 * MS, 18 * MS),
            ("read.preview_grid", 15 * MS, 15 * MS + MS // 4),
            ("read.preview", 16 * MS, 17 * MS),
        ],
    }


@pytest.mark.parametrize("metric,expected", [
    # launched at 3 ms (inside the first plan) and at 11 ms (the second's read)
    ("plan_device_ms_per_frame", (1.0 + 1.0) / 2),
    ("sort_device_ms_per_frame", 2.0 / 2),  # launched at 1 ms
    ("read_wait_ms_per_frame", (0.5 + 2.0) / 2),  # the preview's reads lie outside the step
    ("dispatch_host_ms_per_frame", (12.0 - 0.5 - 2.0) / 2),  # the bounce less its reads
    ("camera_host_ms", 0.5 / 2),
    ("preview_host_ms", (4.0 - 0.25 - 1.0) / 2),
])
def test_per_layer_arithmetic(metric, expected):
    assert Spec.load().reader(metric)(_rec()) == pytest.approx(expected)


PROGRAM_METRICS = ["plan_device_ms_per_frame", "sort_device_ms_per_frame",
                   "read_wait_ms_per_frame", "dispatch_host_ms_per_frame", "camera_host_ms",
                   "preview_host_ms"]


@pytest.mark.parametrize("metric", PROGRAM_METRICS)
def test_nothing_to_read_without_program_spans(metric):
    rec = _rec()
    del rec["program_spans"], rec["launched_ns"]
    assert Spec.load().reader(metric)(rec) is None


def test_existing_readers_ignore_the_program_spans():
    """Every reader the benchmark has reads the same with and without the
    program's spans and launch times, and with the program's annotations
    mirrored among the profiler's events, which are no device activities."""
    spec = Spec.load()
    with_spans = _rec()
    without = {k: v for k, v in with_spans.items() if k not in ("program_spans", "launched_ns")}
    without["work"] = with_spans["work"] = (1.0e9, 67e9)
    for m in spec.doc["per_layer"] + spec.doc["end_to_end"]:
        if m["source"] == "host_clock":
            continue
        assert spec.reader(m["name"])(with_spans) == spec.reader(m["name"])(without), m["name"]
    assert tracing.breakdown(with_spans) == tracing.breakdown(without)

    class Event:
        def __init__(self, name, device):
            self._name, self._device = name, device

        def name(self):
            return self._name

        def device_type(self):
            return self._device

        def is_user_annotation(self):
            return self._name.startswith("ptt.")

    for e in (Event("ptt.mesh.plan", tracing._CUDA), Event("ptt.read.overflow", tracing._CPU)):
        assert not tracing.is_device_activity(e, e.name())


def test_idle_gaps_by_program_span():
    # Idle [0, 2], [5, 6], [9, 12], [13, 16] and [17, 20], each by the
    # innermost span open at its middle: the sort, the walk, the second
    # plan (its read opens later), the preview, and past the program's
    # spans the harness's.
    gaps = dict(program_trace.idle_gaps_program(_rec()))
    assert gaps == pytest.approx({"mesh.sort": 2e-3, "mesh.walk": 1e-3, "mesh.plan": 3e-3,
                                  "renderer.preview": 3e-3, "traced": 3e-3})


def test_interval_helpers():
    assert program_trace.covered_ns([(0, 4), (2, 6), (8, 9)]) == 7
    assert program_trace.overlap_ns([(0, 4), (2, 6), (8, 9)], [(3, 8), (8, 20)]) == 4


class _Event:
    """A kineto event as ``ProgramProfiled._ready`` reads it."""

    def __init__(self, name, device, start, end=None, kind=None, corr=0, annotation=False):
        self._name, self._device, self._corr, self._annotation = name, device, corr, annotation
        self._start, self._end = start, start + 1 if end is None else end
        if kind is not None:
            self.activity_type = lambda: kind

    def name(self):
        return self._name

    def device_type(self):
        return self._device

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def correlation_id(self):
        return self._corr

    def is_user_annotation(self):
        return self._annotation


def _profiler(events):
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=types.SimpleNamespace(events=lambda: events)))


@pytest.mark.parametrize("kinds", [True, False], ids=["activity_type", "by_name"])
def test_launch_times_follow_the_device_order_by_correlation_id(kinds):
    """``launched`` stays parallel to ``device``: each activity gets the start
    of the runtime call with its correlation id, in the activities' order
    (not the calls'), None where no call has it; annotations are neither.
    Without activity kinds (older torch) a runtime call is known by its
    name, and a device annotation by ``is_user_annotation``."""
    cpu, cuda = tracing._CPU, tracing._CUDA
    k = (lambda kind: kind) if kinds else (lambda kind: None)
    events = [
        _Event("cudaLaunchKernel", cpu, 100, kind=k("cuda_runtime"), corr=7),
        _Event("ptt.mesh.plan", cpu, 90, 400, kind=k("user_annotation"), annotation=True),
        _Event("ptt.mesh.plan", cuda, 150, 450, kind=k("gpu_user_annotation"), annotation=True),
        _Event("cuLaunchKernel", cpu, 200, kind=k("cuda_driver"), corr=9),
        _Event("void ptt_binned_kernel<512>(Args)", cuda, 500, 900, kind=k("kernel"), corr=9),
        _Event("void at::native::fill_kernel<int>(int)", cuda, 300, 350, kind=k("kernel"),
               corr=7),
        _Event("Memcpy DtoH (Device -> Pageable)", cuda, 950, 990, kind=k("gpu_memcpy"),
               corr=11),
        _Event("bench.step", cpu, 50, 1000, kind=k("user_annotation"), annotation=True),
    ]
    p = program_trace.ProgramProfiled.__new__(program_trace.ProgramProfiled)
    p.device, p.spans, p.program, p.launched = [], [], [], []
    p._ready(_profiler(events))
    assert [name for name, _, _ in p.device] == [
        "void ptt_binned_kernel<512>(Args)", "void at::native::fill_kernel<int>(int)",
        "Memcpy DtoH (Device -> Pageable)"]
    assert p.launched == [200, 100, None]
    assert p.program == [("mesh.plan", 90, 400)]
    assert p.spans == [("step", 50, 1000)]


def test_profiled_cpu_step_keeps_the_program_spans():
    """``ProgramProfiled`` around one orbit display of the port on the CPU:
    its traced step holds the port's spans, nested, and no device activity."""
    from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer
    from project3_cuda_path_tracer_2025_tpu_torch.scene import load_scene, set_resolution

    scene = set_resolution(load_scene(str(REPO / "scenes" / "cornell.json")), 8, 8)
    scene.state.trace_depth = 2
    r = Renderer(scene, RenderConfig(), seed=1, device="cpu")
    p = program_trace.ProgramProfiled()
    with p:
        r.step_many(1)
        p.step()
        r.orbit_camera(dphi=0.1)
        r.step_many(1, sync=False)
        r.preview_image(4, 4)
        p.step()
    names = [name for name, _, _ in p.program]
    assert names.count("renderer.step_many") == 1 and names.count("renderer.orbit_camera") == 1
    assert {"renderer.preview", "read.preview"} <= set(names)
    spans = {name: (s, e) for name, s, e in p.program}
    (ps, pe), (rs, re_) = spans["renderer.preview"], spans["read.preview"]
    assert ps <= rs <= re_ <= pe
    assert p.device == [] and p.launched == []
