"""The port's command line (``project3_cuda_path_tracer_2025_tpu_torch.cli``)
after the JAX package's CLI tests (``tests/test_cli.py``): the parser's
flags, batching with ``--spp-per-launch`` and its log lines, the
pass-through flags reaching their ``RenderConfig`` fields, ``--cpu``.

Films are compared bit for bit: a batch of launches is the same sequence of
single steps.
"""

import re

import numpy as np
import pytest

from project3_cuda_path_tracer_2025_tpu import cli as jcli
from project3_cuda_path_tracer_2025_tpu_torch import cli
from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer
from project3_cuda_path_tracer_2025_tpu_torch.scene import load_scene, set_resolution

import pathlib

REPO = pathlib.Path(__file__).resolve().parent.parent
DOF = str(REPO / "scenes" / "cornell_dof.json")
MESH = str(REPO / "scenes" / "cornell_mesh_5k.json")

PASS_THROUGH = ("--no-bvh", "--raw-camera", "--ray-sorting", "--bounce-prefix-tiers",
                "--fused-bounce", "--spp-per-launch", "--cpu")


def test_missing_scene_exits_nonzero(capsys):
    rc = cli.main(["/does/not/exist.json", "--cpu"])
    assert rc == 1
    assert "Couldn't read from" in capsys.readouterr().err


def test_parser_flags():
    a = cli.build_parser().parse_args(
        ["s.json", "--spp", "7", "--res", "32", "48", "--no-bvh", "--material-sort",
         "--integrator", "wavefront", "--raw-camera", "--spp-per-launch", "3"])
    assert a.spp == 7 and a.res == [32, 48]
    assert a.no_bvh and a.material_sort and a.raw_camera
    assert a.integrator == "wavefront" and a.spp_per_launch == 3


@pytest.mark.parametrize("flag", PASS_THROUGH)
def test_pass_through_flags_parse_as_in_the_jax_cli(flag):
    """Name, choices and default of each flag the port now takes are the
    JAX CLI's."""
    pick = lambda parser: next(a for a in parser._actions if flag in a.option_strings)
    ours, theirs = pick(cli.build_parser()), pick(jcli.build_parser())
    assert ours.default == theirs.default
    assert ours.choices == theirs.choices
    assert ours.nargs == theirs.nargs and ours.type == theirs.type


def _captured_config(monkeypatch, argv):
    """The RenderConfig and device the CLI hands to Renderer."""
    seen = {}

    class Stop(Exception):
        pass

    def fake(scene, cfg, seed=0, device="cuda"):
        seen.update(cfg=cfg, device=device)
        raise Stop

    import project3_cuda_path_tracer_2025_tpu_torch.models as models

    monkeypatch.setattr(models, "Renderer", fake)
    with pytest.raises(Stop):
        cli.main(argv)
    return seen


@pytest.mark.parametrize("argv,field,value", [
    (["--no-bvh"], "bvh_acceleration", False),
    (["--raw-camera"], "spherical_camera_reconstruction", False),
    (["--ray-sorting", "on"], "ray_sorting", "on"),
    (["--ray-sorting", "off"], "ray_sorting", "off"),
    (["--fused-bounce", "off"], "fused_bounce", "off"),
    (["--fused-bounce", "on"], "fused_bounce", "on"),
    (["--spp-per-launch", "5"], "spp_per_launch", 5),
    (["--bounce-prefix-tiers", "off"], "bounce_prefix_tiers", ()),
    (["--bounce-prefix-tiers", "4,2"], "bounce_prefix_tiers", (4, 2)),
    ([], "bounce_prefix_tiers", "auto"),
])
def test_each_flag_reaches_its_config_field(monkeypatch, argv, field, value):
    seen = _captured_config(monkeypatch, [DOF, "--cpu", *argv])
    assert getattr(seen["cfg"], field) == value
    default = RenderConfig()
    if argv:
        assert getattr(default, field) != value or field == "bounce_prefix_tiers"


def test_cpu_is_device_cpu(monkeypatch):
    assert _captured_config(monkeypatch, [DOF, "--cpu"])["device"] == "cpu"
    assert _captured_config(monkeypatch, [DOF, "--device", "cpu"])["device"] == "cpu"
    assert _captured_config(monkeypatch, [DOF])["device"] == "cuda"


def test_prefix_tiers_parse_and_raise_from_the_config(monkeypatch):
    """Prefix tiers are ported: both spellings of the flag build the JAX
    CLI's tuple (before the slice that ported them, the config raised)."""
    for argv in (["--bounce-prefix-tiers", "4,2"], ["--bounce-prefix-tiers=4,2"]):
        seen = _captured_config(monkeypatch, [DOF, "--cpu", *argv])
        assert seen["cfg"].bounce_prefix_tiers == (4, 2)
        assert seen["cfg"].resolved_prefix_tiers("cpu") == (4, 2)


@pytest.mark.parametrize("flag", ["--devices", "--parallel-mode", "--pixel-chunks",
                                  "--preview-every", "--interactive"])
def test_flags_of_unported_paths_still_raise(flag):
    """These five flags are ported now: each parses as the JAX CLI's does
    (name, choices, default, nargs, type), and argparse refuses a value
    that is not one of its own, as the JAX CLI does."""
    pick = lambda parser: next(a for a in parser._actions if flag in a.option_strings)
    ours, theirs = pick(cli.build_parser()), pick(jcli.build_parser())
    assert ours.default == theirs.default and ours.choices == theirs.choices
    assert ours.nargs == theirs.nargs and ours.type == theirs.type
    with pytest.raises(SystemExit):
        cli.main([DOF, "--cpu", flag, "x"])


def _film(ck):
    d = np.load(ck)
    return np.stack([d["film_x"], d["film_y"], d["film_z"]], 1), int(d["iteration"])


def test_spp_per_launch_batches_and_logs(tmp_path, capsys):
    """--spp-per-launch 3 --spp 7 steps 3 + 3 + 1: the film of seven single
    steps bit for bit, and the JAX CLI's log lines at its cadence (after a
    batch, when the iteration is a multiple of --log-every or the last)."""
    ck = tmp_path / "ck.npz"
    rc = cli.main([DOF, "--cpu", "--res", "8", "8", "--spp", "7", "--spp-per-launch", "3",
                   "--log-every", "3", "--out", str(tmp_path / "img"), "--checkpoint", str(ck),
                   "--no-bvh", "--raw-camera", "--ray-sorting", "off", "--fused-bounce", "off"])
    assert rc == 0
    out = capsys.readouterr().out
    film, it = _film(ck)
    assert it == 7
    r = Renderer(set_resolution(load_scene(DOF), 8, 8),
                 RenderConfig(bvh_acceleration=False, spherical_camera_reconstruction=False,
                              ray_sorting="off", fused_bounce="off", spp_per_launch=3),
                 device="cpu")
    for _ in range(7):
        r.step()
    np.testing.assert_array_equal(film, np.stack([c.numpy() for c in r.film], 1))
    assert "8x8, depth 8, 7 spp, integrator=megakernel, 0 tris, 7 prims" in out
    logged = re.findall(r"^iter (\d+)/7  [\d.]+ ms/frame  [\d.]+ FPS  [\d.]+ Mrays/s$", out, re.M)
    assert logged == ["3", "6", "7"]
    assert f"checkpoint -> {ck}" in out and re.search(r"Saved .*\.7samp\.png\.", out)


def test_checkpoint_cadence_follows_the_batches(tmp_path):
    """--checkpoint-every is checked after each batch, as in the JAX CLI: with
    batches of 2 and a cadence of 4 the checkpoint on disk after an
    interrupted run at 5 of 6 spp would be iteration 4; here the run ends, so
    the last write is the exit's."""
    ck = tmp_path / "ck.npz"
    common = [DOF, "--cpu", "--res", "8", "8", "--quiet", "--out", str(tmp_path / "img"),
              "--checkpoint", str(ck)]
    assert cli.main(common + ["--spp", "4", "--spp-per-launch", "2", "--checkpoint-every", "4"]) == 0
    film4, it = _film(ck)
    assert it == 4
    assert cli.main(common + ["--spp", "7", "--spp-per-launch", "2", "--resume", str(ck)]) == 0
    film7, it = _film(ck)
    assert it == 7  # 4 + 2 + 1: the last batch is cut to the total
    direct = Renderer(set_resolution(load_scene(DOF), 8, 8), RenderConfig(), device="cpu")
    direct.step_many(7)
    np.testing.assert_array_equal(film7, np.stack([c.numpy() for c in direct.film], 1))
    assert not np.array_equal(film4, film7)


def test_mesh_flags_end_to_end(tmp_path):
    """--no-bvh (brute-force triangles) and --raw-camera on a mesh scene
    through the real argv surface: finite, and the camera flag changes the
    image."""
    outs = {}
    for name, extra in (("bvh", []), ("nobvh", ["--no-bvh"]), ("raw", ["--raw-camera"])):
        ck = tmp_path / f"{name}.npz"
        assert cli.main([MESH, "--cpu", "--res", "8", "8", "--spp", "1", "--quiet", "--out",
                         str(tmp_path / name), "--checkpoint", str(ck), *extra]) == 0
        outs[name] = _film(ck)[0]
        assert np.isfinite(outs[name]).all() and outs[name].sum() > 0
    np.testing.assert_allclose(outs["bvh"], outs["nobvh"], rtol=2e-4, atol=2e-5)
