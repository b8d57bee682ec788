"""The port's interactive shell (``interactive.py``) and the CLI's five
multi-device, chunk, preview and interactive flags, after the JAX package's
``tests/test_interactive.py`` and ``tests/test_cli.py``: the frame
rasterizer equal to the JAX one on the same arrays, key dispatch, the
device-side preview against the full fetch, ``step(sync=False)``, the live
loop on a stubbed TTY, and each flag end to end on the CPU.
"""

import glob
import io
import pathlib

import numpy as np
import pytest

from project3_cuda_path_tracer_2025_tpu import interactive as jinteractive
from project3_cuda_path_tracer_2025_tpu_torch import cli, interactive
from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu_torch.interactive import InteractiveShell, frame_to_ansi
from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer
from project3_cuda_path_tracer_2025_tpu_torch.scene import load_scene, set_resolution
from project3_cuda_path_tracer_2025_tpu_torch.utils import image_io

REPO = pathlib.Path(__file__).resolve().parent.parent
DOF = str(REPO / "scenes" / "cornell_dof.json")


def _renderer(res=12, depth=2, **cfg):
    scene = set_resolution(load_scene(DOF), res, res)
    scene.state.trace_depth = depth
    return Renderer(scene, RenderConfig(**cfg), device="cpu")


@pytest.mark.parametrize("shape,cols,rows,mirror", [
    ((8, 8), 4, 2, False), ((8, 8), 4, 2, True), ((37, 53), 20, 9, True),
    ((16, 16), 40, 30, False),
])
def test_frame_to_ansi_matches_jax(shape, cols, rows, mirror):
    rng = np.random.default_rng(sum(shape) + cols)
    img = rng.uniform(-0.2, 1.4, (*shape, 3)).astype(np.float32)
    assert frame_to_ansi(img, cols, rows, mirror) == jinteractive.frame_to_ansi(
        img, cols, rows, mirror)


def test_frame_to_ansi_shape_and_colors():
    img = np.zeros((8, 8, 3), np.float32)
    img[:, :4] = (1.0, 0.0, 0.0)  # left half red
    lines = frame_to_ansi(img, cols=4, rows=2, mirror=False).split("\n")
    assert len(lines) == 2 and lines[0].count("▀") == 4
    assert "38;2;255;0;0" in lines[0] and "38;2;0;0;0" in lines[0]
    m = frame_to_ansi(img, cols=4, rows=2, mirror=True)
    assert "38;2;0;0;0" in m.split("▀")[0]  # mirror flips red to the right half
    out = frame_to_ansi(np.full((4, 4, 3), 7.5, np.float32), cols=2, rows=1)
    assert "38;2;255;255;255" in out and "256" not in out  # clamped


def test_shell_key_dispatch(tmp_path):
    r = _renderer()
    r.step()
    shell = InteractiveShell(r, out_dir=str(tmp_path))
    it0 = r.iteration
    assert shell.handle_key("l")  # orbit resets accumulation
    assert r.iteration == 0 and it0 > 0
    for key in ("h", "k", "j", "+", "-", "A", "B", "C", "D"):
        assert shell.handle_key(key)
    assert shell.handle_key(" ") and shell.paused
    assert shell.handle_key(" ") and not shell.paused
    assert not shell.handle_key("z")  # unbound key
    r.step()
    assert shell.handle_key("s")
    assert "saved" in shell.message and not shell.quit
    assert shell.handle_key("q") and shell.quit
    assert len(glob.glob(str(tmp_path / "*.png"))) >= 1
    assert "iter" in shell.status_line()


@pytest.mark.parametrize("cfg", [dict(), dict(devices=4, parallel_mode="sample"),
                                 dict(devices=2)], ids=["single", "sample", "pixel"])
def test_preview_image_matches_full_fetch(cfg):
    """The device-side preview == the host downsample of the full image on
    the same nearest-neighbor grid, in every film layout."""
    r = _renderer(res=16, **cfg)
    r.step()
    small = r.preview_image(8, 4)
    assert small.shape == (8, 4, 3)
    full = r.image_normalized()
    ys = ((np.arange(8) + 0.5) * 16 / 8).astype(int)
    xs = ((np.arange(4) + 0.5) * 16 / 4).astype(int)
    np.testing.assert_allclose(small, full[ys][:, xs], rtol=1e-6)


def test_step_nosync_pipelines():
    a, b = _renderer(), _renderer()
    for _ in range(3):
        a.step()
        b.step(sync=False)
    np.testing.assert_array_equal(a.image(), b.image())
    assert b.iteration == 3


def test_run_needs_a_tty(monkeypatch, capsys):
    monkeypatch.setattr(interactive.sys, "stdin", io.StringIO(""))
    assert InteractiveShell(_renderer()).run() == 1
    assert "needs a TTY" in capsys.readouterr().err


def test_run_loop_on_a_stubbed_tty(monkeypatch, tmp_path, capsys):
    """``run`` with the terminal stubbed: an arrow key (ESC [ C) orbits,
    frames are drawn, and reaching max_iters saves and quits."""
    keys = list(b"\x1b[C")

    class FakeStdin:
        def isatty(self):
            return True

        def fileno(self):
            return 99

    import termios
    import tty

    monkeypatch.setattr(interactive.sys, "stdin", FakeStdin())
    monkeypatch.setattr(termios, "tcgetattr", lambda fd: "mode")
    monkeypatch.setattr(termios, "tcsetattr", lambda fd, when, mode: None)
    monkeypatch.setattr(tty, "setcbreak", lambda fd: None)
    monkeypatch.setattr(interactive.select, "select",
                        lambda r, w, x, t=None: (r if keys else [], [], []))
    monkeypatch.setattr(interactive.os, "read", lambda fd, n: bytes([keys.pop(0)]))
    monkeypatch.setattr(InteractiveShell, "_term_size", staticmethod(lambda: (24, 10)))
    r = _renderer()
    orbit0 = r.orbit.phi
    shell = InteractiveShell(r, out_dir=str(tmp_path))
    assert shell.run(spp_per_frame=1, max_iters=2) == 0
    out = capsys.readouterr().out
    assert r.orbit.phi != orbit0 and r.iteration == 2 and shell.quit
    assert "▀" in out and "iter 2" in out and "saved" in out
    assert len(glob.glob(str(tmp_path / "*.png"))) == 1


def _png(out_dir) -> np.ndarray:
    return image_io.read_png(str(next(pathlib.Path(out_dir).glob("*.png"))))


@pytest.mark.parametrize("flags", [
    ["--devices", "2"], ["--devices", "2", "--parallel-mode", "pixel"],
    ["--devices", "3", "--parallel-mode", "sample"], ["--pixel-chunks", "4"],
], ids=["devices", "pixel", "sample", "chunks"])
def test_cli_parallel_flags_end_to_end(tmp_path, flags):
    """Each flag through the real argv surface: the PNG and the checkpoint's
    film equal the single-device render's (sample mode: 3 spp in one
    step, close to 3 single steps)."""
    common = [DOF, "--cpu", "--res", "12", "12", "--depth", "3", "--spp", "3", "--quiet"]
    a, b = tmp_path / "single", tmp_path / "flag"
    assert cli.main(common + ["--out", str(a), "--checkpoint", str(a / "c.npz")]) == 0
    assert cli.main(common + flags + ["--out", str(b), "--checkpoint", str(b / "c.npz")]) == 0
    fa, fb = np.load(a / "c.npz"), np.load(b / "c.npz")
    assert int(fb["iteration"]) == 3
    for k in ("film_x", "film_y", "film_z"):
        np.testing.assert_allclose(fb[k], fa[k], rtol=1e-6, atol=0)
    if "sample" not in flags:
        np.testing.assert_array_equal(_png(b), _png(a))


def test_cli_preview_every_and_interactive(tmp_path, monkeypatch, capsys):
    out = tmp_path / "o"
    common = [DOF, "--cpu", "--res", "8", "8", "--depth", "2", "--out", str(out)]
    assert cli.main(common + ["--spp", "3", "--preview-every", "1"]) == 0
    assert "preview ->" in capsys.readouterr().out
    assert (out / "preview.png").is_file()
    assert len(list(out.glob("*samp.png"))) == 1
    monkeypatch.setattr(interactive.sys, "stdin", io.StringIO(""))
    assert cli.main(common + ["--interactive"]) == 1  # no TTY here
    assert "needs a TTY" in capsys.readouterr().err
