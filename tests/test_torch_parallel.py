"""The port's multi-device rendering (``parallel``) on the CPU, after the
JAX package's ``tests/test_parallel.py``: pixel mode bit-equal to the
unsharded iteration (prims through the kernels' plain versions, meshes
through three traversals, the wavefront), sample mode, flat checkpoints
across layouts and packages, the camera draw of a block, and the device
and stream each shard launches under.

The shards run on one device named nd times (``"cpu"`` x nd); the JAX
package runs on ``tests/conftest.py``'s 8 virtual CPU devices.  Port
against port is bit for bit; port against JAX at
``torch_compare.assert_films_close``, alive counts equal.
"""

import contextlib
import itertools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_2025_tpu.config import RenderConfig as JConfig
from project3_cuda_path_tracer_2025_tpu.models import Renderer as JRenderer
from project3_cuda_path_tracer_2025_tpu.scene import load_scene as j_load
from project3_cuda_path_tracer_2025_tpu.scene import set_resolution as j_set_res
from project3_cuda_path_tracer_2025_tpu.utils import prng as jprng
from project3_cuda_path_tracer_2025_tpu_torch import parallel
from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer, megakernel_iteration
from project3_cuda_path_tracer_2025_tpu_torch.ops import film as film_ops
from project3_cuda_path_tracer_2025_tpu_torch.ops import kernels
from project3_cuda_path_tracer_2025_tpu_torch.parallel import shardmap
from project3_cuda_path_tracer_2025_tpu_torch.scene import (
    build_device_scene, camera_state, derive_render_camera, load_scene, set_resolution,
)
from project3_cuda_path_tracer_2025_tpu_torch.utils import prng
from torch_compare import assert_films_close

REPO = pathlib.Path(__file__).resolve().parent.parent
DOF = str(REPO / "scenes" / "cornell_dof.json")
MESH = str(REPO / "scenes" / "cornell_mesh_5k.json")
RES, DEPTH = 16, 4

needs8 = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


def _scene(path=DOF, res=RES, depth=DEPTH):
    s = set_resolution(load_scene(path), res, res)
    s.state.trace_depth = depth
    return s


def _jscene(path=DOF, res=RES, depth=DEPTH):
    s = j_set_res(j_load(path), res, res)
    s.state.trace_depth = depth
    return s


def _flat(r) -> np.ndarray:
    f = r._flat_film()
    return np.stack([np.asarray(f.x), np.asarray(f.y), np.asarray(f.z)], 1)


def _unsharded_films(scene, cfg, steps: int) -> list:
    """The film after each of ``steps`` iterations of the port's unsharded
    ``megakernel_iteration`` (with ``cfg``; no iteration kernel)."""
    dev, static = build_device_scene(scene, "cpu")
    cam = camera_state(derive_render_camera(scene.state.camera))
    film = film_ops.new_film(static.pixel_count, "cpu")
    out = []
    for it in range(1, steps + 1):
        film, alive = megakernel_iteration(dev, static, cfg, cam, film, it, prng.prng_key(0))
        out.append((torch.stack(list(film), 1).numpy().copy(), alive.numpy().copy()))
    return out


@pytest.mark.parametrize("nd", [2, 8])
def test_pixel_mode_bitexact_fused_plain(nd):
    """Pixel mode with ``fused_bounce="on"`` (the bounce kernel's plain
    version and the camera draw under ``shard=``) equals the unsharded
    ``megakernel_iteration`` bit for bit, step by step."""
    scene = _scene()
    cfg = RenderConfig(fused_bounce="on")
    want = _unsharded_films(scene, cfg, 2)
    r = Renderer(scene, RenderConfig(fused_bounce="on", devices=nd), device="cpu")
    assert len(r.film) == nd and r.film[0].x.shape == (RES * RES // nd,)
    for film, alive in want:
        r.step()
        np.testing.assert_array_equal(_flat(r), film)
        np.testing.assert_array_equal(r._alive_counts, alive)
    assert r.iteration == 2


@pytest.fixture(scope="module")
def jax_sharded():
    """The JAX package's sharded renders (module-scoped: one compile each):
    pixel mode, 2 steps; sample mode, one 8-sample step and its checkpoint."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    s = _jscene()
    px = JRenderer(s, JConfig(devices=8, parallel_mode="pixel"))
    px.step()
    px.step()
    sm = JRenderer(s, JConfig(devices=8, parallel_mode="sample"))
    sm.step()
    return dict(pixel=(_flat(px), np.asarray(px._alive_counts)), sample=sm)


@needs8
def test_pixel_mode_matches_jax_sharded(jax_sharded):
    r = Renderer(_scene(), RenderConfig(devices=8), device="cpu")
    r.step()
    r.step()
    film, alive = jax_sharded["pixel"]
    assert_films_close(_flat(r), film)
    np.testing.assert_array_equal(r._alive_counts, alive)


def test_sample_mode_is_nd_single_steps():
    """One sample-mode step of nd shards == nd single steps (shard d renders
    iteration it - nd + 1 + d; the films summed in shard order); step_many
    rounds up to whole strides."""
    scene = _scene()
    a = Renderer(scene, RenderConfig(), device="cpu")
    a.step_many(4)
    b = Renderer(scene, RenderConfig(devices=4, parallel_mode="sample"), device="cpu")
    b.step()
    assert b.iteration == 4 and len(b.film) == 4
    np.testing.assert_array_equal(_flat(b), _flat(a))
    a.step_many(4)
    b.step_many(3)  # one stride of 4
    assert b.iteration == 8 and len(b.stats.times_ms) == 8
    np.testing.assert_allclose(_flat(b), _flat(a), rtol=1e-6, atol=0)


def test_wavefront_pixel_mode_bitexact():
    scene = _scene()
    a = Renderer(scene, RenderConfig(integrator="wavefront", stream_compaction=True),
                 device="cpu")
    b = Renderer(scene, RenderConfig(integrator="wavefront", stream_compaction=True,
                                     devices=8), device="cpu")
    for _ in range(2):
        a.step()
        b.step()
    np.testing.assert_array_equal(_flat(b), _flat(a))
    np.testing.assert_array_equal(b._alive_counts, a._alive_counts)


@pytest.mark.parametrize("traversal", ["mono", "streamed", "binned"])
def test_mesh_pixel_mode_bitexact(traversal):
    """The 5k mesh through the MXU tables' traversal with the persistent ray
    sort: each shard sorts its own block, and the film scatter shifted by
    the block's first pixel lands where the unsharded one does."""
    scene = _scene(MESH, 16, 3)
    kw = dict(mesh_intersector="mxu", ray_sorting="on", fused_bounce="on",
              mxu_traversal=traversal)
    a = Renderer(scene, RenderConfig(**kw), device="cpu")
    b = Renderer(scene, RenderConfig(devices=2, **kw), device="cpu")
    a.step()
    b.step()
    np.testing.assert_array_equal(_flat(b), _flat(a))
    np.testing.assert_array_equal(b._alive_counts, a._alive_counts)


def test_pixel_mode_must_divide():
    with pytest.raises(ValueError, match="devices \\| pixels"):
        Renderer(_scene(res=10), RenderConfig(devices=3), device="cpu")
    # sample mode takes any resolution
    r = Renderer(_scene(res=10), RenderConfig(devices=3, parallel_mode="sample"), device="cpu")
    r.step()
    assert r.iteration == 3 and np.isfinite(r.image()).all()


def test_checkpoint_roundtrip_single_sample_single(tmp_path):
    """Checkpoints are flat films: single -> sample mode (the film in the
    first shard's row, the others zero) -> single, image unchanged, and the
    render goes on as one device would."""
    scene = _scene()
    a = Renderer(scene, RenderConfig(), device="cpu")
    a.step()
    ck = str(tmp_path / "a.npz")
    a.checkpoint(ck)
    b = Renderer(scene, RenderConfig(devices=4, parallel_mode="sample"), device="cpu")
    b.restore(ck)
    assert b.iteration == 1
    np.testing.assert_array_equal(b.image(), a.image())
    assert not any(f.x.any() for f in b.film[1:])
    b.step()  # samples 2..5
    a.step_many(4)
    np.testing.assert_allclose(_flat(b), _flat(a), rtol=1e-6, atol=0)
    ck2 = str(tmp_path / "b.npz")
    b.checkpoint(ck2)
    c = Renderer(scene, RenderConfig(), device="cpu")
    c.restore(ck2)
    assert c.iteration == 5
    np.testing.assert_array_equal(c.image(), b.image())
    # and into pixel mode: each shard takes its block
    p = Renderer(scene, RenderConfig(devices=2), device="cpu")
    p.restore(ck2)
    np.testing.assert_array_equal(p.image(), b.image())
    p.step()
    c.step()
    np.testing.assert_array_equal(p.image(), c.image())


@needs8
def test_jax_sample_checkpoint_restores_in_the_port(jax_sharded, tmp_path):
    """A JAX sample-mode checkpoint (8 shards, 8 samples) restores in the
    port, flat and in sample mode, and both go on like the JAX renderer."""
    j = jax_sharded["sample"]
    ck = str(tmp_path / "j.npz")
    j.checkpoint(ck)
    single = Renderer(_scene(), RenderConfig(), device="cpu")
    single.restore(ck)
    sharded = Renderer(_scene(), RenderConfig(devices=8, parallel_mode="sample"), device="cpu")
    sharded.restore(ck)
    assert single.iteration == sharded.iteration == 8
    np.testing.assert_array_equal(single.image(), j.image())
    np.testing.assert_array_equal(sharded.image(), j.image())
    j.step()  # samples 9..16
    sharded.step()
    single.step_many(8)
    assert sharded.iteration == single.iteration == j.iteration == 16
    assert_films_close(_flat(sharded), _flat(j))
    np.testing.assert_allclose(_flat(sharded), _flat(single), rtol=1e-6, atol=0)


@pytest.mark.parametrize("base,ln,n", [(0, 64, 64), (96, 32, 256), (1000, 24, 4096)])
def test_camera_draw_of_a_block_matches_jax(base, ln, n):
    """The camera draw's plain form at a block ``[base, base + ln)`` of an
    n-pixel frame (what the Threefry kernel computes with ``base`` and
    ``rng_n``) is the JAX ``uniforms_at`` at those pixels."""
    jkey = jprng.stage_key(jprng.iteration_key(jax.random.PRNGKey(5), jnp.int32(3)), 0, 0)
    kd = np.asarray(jax.random.key_data(jkey)).astype(np.uint32)
    key = (int(kd[0]), int(kd[1]))
    want = np.asarray(jprng.uniforms_at(jkey, jnp.arange(base, base + ln, dtype=jnp.int32), 4, n))
    got = prng.uniforms(key, ln, 4, "cpu", base=base, rng_n=n)
    np.testing.assert_array_equal(got.numpy(), want)
    if base == 0 and ln == n:
        np.testing.assert_array_equal(got.numpy(), prng.uniforms(key, n, 4).numpy())


def test_each_shard_launches_under_its_device_and_stream(monkeypatch):
    """With CUDA's device and stream calls stubbed: each shard's iteration
    runs with its device current and its own stream current on it (so
    ``kernels.stream_handle`` hands its launches that stream, and refuses
    another device), shards named on one device get streams of their own,
    each stream waits for its device's current stream before the step and
    the current streams (and the first device's) wait for every shard
    after it; the counts are summed."""
    state = {"device": 0}
    handles = itertools.count(100)
    created = []

    class FakeStream:
        def __init__(self, device=None):
            self.device = torch.device(device)
            self.handle = next(handles)
            self.waited = []
            created.append(self)

        def wait_stream(self, other):
            self.waited.append(other)

    current = {i: FakeStream(torch.device("cuda", i)) for i in range(2)}
    defaults = dict(current)
    created.clear()

    @contextlib.contextmanager
    def fake_device(d):
        prev, state["device"] = state["device"], torch.device(d).index
        try:
            yield
        finally:
            state["device"] = prev

    @contextlib.contextmanager
    def fake_stream(s):
        i = s.device.index
        prev, current[i] = current[i], s
        try:
            yield
        finally:
            current[i] = prev

    def fake_current_stream(device=None):
        i = None if device is None else torch.device(device).index
        return current[state["device"] if i is None else i]

    monkeypatch.setattr(torch.cuda, "Stream", FakeStream)
    monkeypatch.setattr(torch.cuda, "device", fake_device)
    monkeypatch.setattr(torch.cuda, "stream", fake_stream)
    monkeypatch.setattr(torch.cuda, "current_stream", fake_current_stream)
    # (The CPU build of torch has no CUDA bindings to replace.)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: state["device"], raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: current[i].handle,
                        raising=False)

    seen = []

    def fake_iteration(dev, static, cfg, cam, film, iteration, key, shard=None):
        here = torch.device("cuda", state["device"])
        seen.append((dev, shard, iteration, here, kernels.stream_handle(here),
                     kernels.stream_handle(torch.device("cuda"))))
        with pytest.raises(RuntimeError, match="current device"):
            kernels.stream_handle(torch.device("cuda", 1 - state["device"]))
        return film, torch.full((2,), 1 + len(seen), dtype=torch.int32)

    monkeypatch.setattr(shardmap, "megakernel_iteration", fake_iteration)
    _, static = build_device_scene(_scene(res=12), "cpu")
    devices = [torch.device("cuda", i) for i in (0, 1, 0)]
    step, stride = parallel.make_sharded_step(
        {devices[0]: "scene0", devices[1]: "scene1"}, static, RenderConfig(), devices, "pixel")
    streams = list(created)
    assert stride == 1 and len(streams) == 3
    assert [s.device for s in streams] == devices
    assert len({s.handle for s in streams}) == 3
    film = ["f0", "f1", "f2"]
    _, alive = step(None, film, 5, (0, 0))
    assert [s[0] for s in seen] == ["scene0", "scene1", "scene0"]
    assert [s[1] for s in seen] == [(range(0, 48), 144), (range(48, 96), 144),
                                    (range(96, 144), 144)]
    assert [s[2] for s in seen] == [5, 5, 5]
    assert [s[3] for s in seen] == devices
    assert [s[4] for s in seen] == [s.handle for s in streams]
    assert [s[5] for s in seen] == [s.handle for s in streams]
    assert state["device"] == 0 and current == defaults  # contexts left as found
    for s in streams:
        assert s.waited == [defaults[s.device.index]]
    assert defaults[1].waited == [streams[1]]
    assert defaults[0].waited == [streams[0], streams[1], streams[2]]
    assert alive.tolist() == [2 + 3 + 4] * 2


def test_device_list_and_dryrun():
    """``make_device_list`` never shortens a request: more CUDA devices than
    the machine has raise; a named list may repeat a device.  ``dryrun``
    runs one pixel-mode step, the unsharded film bit for bit."""
    have = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="CUDA devices asked for"):
        parallel.make_device_list(have + 1)
    assert parallel.make_device_list(3, ["cpu"] * 3) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="named"):
        parallel.make_device_list(2, ["cpu"] * 3)
    reps = parallel.replicate_scene(_scene(), ["cpu"] * 4)
    assert list(reps) == [torch.device("cpu")]
    film, alive, devices = parallel.dryrun(4, DOF, 16, 16, devices=["cpu"] * 4)
    assert devices == [torch.device("cpu")] * 4
    scene = set_resolution(load_scene(DOF), 16, 16)
    (want, want_alive), = _unsharded_films(scene, RenderConfig(), 1)
    np.testing.assert_array_equal(torch.stack(list(film), 1).numpy(), want)
    np.testing.assert_array_equal(alive.numpy(), want_alive)
