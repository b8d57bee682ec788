"""The port's Renderer end to end on the CPU: against the committed golden
film, against the JAX package's Renderer, checkpoints in both directions,
orbit resets and the CLI.

Film tolerances: ``tests/torch_compare.py`` (the goldens' per-pixel
tolerance on every pixel, and film sums).
"""

import pathlib

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_2025_tpu.config import RenderConfig as JConfig
from project3_cuda_path_tracer_2025_tpu.models import Renderer as JRenderer
from project3_cuda_path_tracer_2025_tpu.scene import load_scene as j_load
from project3_cuda_path_tracer_2025_tpu.scene import set_resolution as j_set_res
from project3_cuda_path_tracer_2025_tpu_torch import cli
from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer
from project3_cuda_path_tracer_2025_tpu_torch.scene import load_scene, set_resolution
from torch_compare import assert_films_close

REPO = pathlib.Path(__file__).resolve().parent.parent
DOF = str(REPO / "scenes" / "cornell_dof.json")
TRANS = str(REPO / "scenes" / "cornell_transmissive_sphere.json")
RES = 24


def _film(r) -> np.ndarray:
    return torch.stack(list(r.film), 1).cpu().numpy()


def _jfilm(r) -> np.ndarray:
    f = r._flat_film()
    return np.stack([np.asarray(f.x), np.asarray(f.y), np.asarray(f.z)], 1)


def _port(path, res, **cfg):
    return Renderer(set_resolution(load_scene(path), res, res), RenderConfig(**cfg),
                    seed=0, device="cpu")


@pytest.mark.parametrize("fused_bounce", ["auto", "on"])
def test_golden_dof(fused_bounce):
    """``tests/goldens/dof.npz`` at the goldens' own tolerance, through the
    unfused path ("auto" on the CPU) and the iteration kernel's plain
    version ("on")."""
    g = np.load(REPO / "tests" / "goldens" / "dof.npz")
    assert str(g["scene"]) == "$REPO/scenes/cornell_dof.json"
    r = _port(DOF, int(g["width"]), fused_bounce=fused_bounce)
    for _ in range(int(g["spp"])):
        r.step()
    got = _film(r)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, g["film"], rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX Renderer on the transmissive scene after 2 spp, and its
    checkpoint."""
    jr = JRenderer(j_set_res(j_load(TRANS), RES, RES), JConfig(), seed=0)
    for _ in range(2):
        jr.step()
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "jax2.npz")
    jr.checkpoint(ckpt)
    return jr, ckpt, _jfilm(jr), np.asarray(jr._alive_counts)


def test_matches_jax_renderer(jax_run):
    _, _, jfilm, jalive = jax_run
    r = _port(TRANS, RES)
    r.step_many(2)
    assert r.iteration == 2
    np.testing.assert_array_equal(r._alive_counts, jalive)
    assert_films_close(_film(r), jfilm)


def test_jax_checkpoint_resumes_in_port(jax_run, tmp_path):
    jr, ckpt, _, _ = jax_run
    r = _port(TRANS, RES)
    r.restore(ckpt)
    assert r.iteration == 2
    np.testing.assert_array_equal(_film(r), jax_run[2])
    jr.restore(ckpt)
    r.step()
    jr.step()
    assert r.iteration == jr.iteration == 3
    assert_films_close(_film(r), _jfilm(jr))


def test_port_checkpoint_resumes_in_jax(jax_run, tmp_path):
    jr = jax_run[0]
    r = _port(TRANS, RES)
    r.step_many(3)
    path = str(tmp_path / "port3.npz")
    r.checkpoint(path)
    jr.restore(path)
    assert jr.iteration == 3
    np.testing.assert_array_equal(_jfilm(jr), _film(r))
    r.step()
    jr.step()
    assert_films_close(_film(r), _jfilm(jr))


def test_orbit_resets_and_matches_fresh_renderer():
    r = _port(DOF, 12)
    r.step_many(2)
    before = _film(r)
    r.orbit_camera(dphi=0.2, dtheta=-0.1, dzoom=0.5)
    assert r.iteration == 0 and not _film(r).any()
    r.step()
    fresh = _port(DOF, 12)
    fresh.orbit_camera(dphi=0.2, dtheta=-0.1, dzoom=0.5)
    fresh.step()
    np.testing.assert_array_equal(_film(r), _film(fresh))
    first = _port(DOF, 12)
    first.step()
    assert not np.array_equal(_film(r), _film(first))
    assert before.any()


def test_images_and_preview():
    r = _port(DOF, 16)
    r.step_many(3)
    img = r.image()
    assert img.shape == (16, 16, 3)
    np.testing.assert_allclose(r.image_normalized(), img / 3)
    prev = r.preview_image(16, 16)
    np.testing.assert_allclose(prev, img / 3, rtol=1e-6)
    assert r.preview_image(4, 8).shape == (4, 8, 3)


def test_cli_renders_checkpoints_and_resumes(tmp_path):
    out, ck = tmp_path / "img", tmp_path / "ck.npz"
    common = [DOF, "--res", "8", "8", "--device", "cpu", "--out", str(out), "--quiet"]
    assert cli.main(common + ["--spp", "2", "--checkpoint", str(ck), "--hdr"]) == 0
    assert sorted(p.suffix for p in out.iterdir()) == [".hdr", ".png"]
    assert cli.main(common + ["--spp", "4", "--resume", str(ck)]) == 0
    d = np.load(ck)
    assert int(d["iteration"]) == 2
    direct = _port(DOF, 8)
    direct.step_many(2)
    np.testing.assert_array_equal(d["film_x"], direct.film.x.numpy())


@pytest.mark.parametrize("flag", ["--integrator", "--devices", "--interactive"])
def test_cli_unported_flags_raise(flag):
    if flag in ("--integrator", "--devices"):
        # Ported; "x" is not one of their values, which argparse refuses as
        # the JAX CLI does.
        with pytest.raises(SystemExit):
            cli.main([DOF, flag, "x"])
        return
    # --interactive is ported; what still raises is the config's unported
    # prefix tiers, before the shell starts.
    with pytest.raises(NotImplementedError, match="not ported yet"):
        cli.main([DOF, "--cpu", flag, "--bounce-prefix-tiers", "4,2"])
