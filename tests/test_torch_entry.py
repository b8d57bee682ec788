"""The port's ``entry()`` (``project3_cuda_path_tracer_2025_tpu_torch/entry.py``)
against the repo's ``__graft_entry__.entry()``, and the stand-in scene
``scenes/cornell.json`` both read.

The step runs on the CPU in both packages (the port's unfused torch path,
the JAX package's XLA path) from the same example inputs, the JAX key
carried across; alive counts equal, the film at the goldens' bar
(``torch_compare.assert_films_close``).
"""

import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_2025_tpu.scene import load_scene as j_load
from project3_cuda_path_tracer_2025_tpu_torch import entry as port_entry
from project3_cuda_path_tracer_2025_tpu_torch.scene import load_scene
from torch_compare import assert_films_close

REPO = pathlib.Path(__file__).resolve().parent.parent
CORNELL = REPO / "scenes" / "cornell.json"
DOF = REPO / "scenes" / "cornell_dof.json"


@pytest.fixture(scope="module")
def jax_step():
    """``__graft_entry__.entry()``'s step, jitted as its ``__main__`` runs
    it, on its example args: (film [N, 3], alive, example args)."""
    import __graft_entry__

    assert pathlib.Path(__graft_entry__.SCENE).resolve() == CORNELL  # the stand-in
    fn, args = __graft_entry__.entry()
    film, alive = jax.jit(fn)(*args)
    return (np.stack([np.asarray(film.x), np.asarray(film.y), np.asarray(film.z)], 1),
            np.asarray(alive), args)


def test_entry_step_matches_jax(jax_step):
    want_film, want_alive, jargs = jax_step
    step, (cam, film, iteration, key) = port_entry.entry("cpu")
    jkey = tuple(int(k) for k in np.asarray(jargs[3]))
    assert key == jkey and iteration == int(jargs[2])
    assert film.x.shape == (128 * 128,) and film.x.device.type == "cpu"
    out, alive = step(cam, film, iteration, jkey)
    assert out is film  # updated in place
    np.testing.assert_array_equal(alive.numpy(), want_alive)
    assert want_alive[0] > 0
    assert_films_close(torch.stack(list(out), 1).numpy(), want_film)


def test_entry_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_entry.entry()


def test_stand_in_scene_is_cornell_dof_with_a_pinhole():
    """``scenes/cornell.json`` is ``cornell_dof.json`` but for ``APERTURE``
    (0, a pinhole) and ``FILE``; both packages load it to the same host
    scene of 5 materials and 7 geoms."""
    got, dof = json.loads(CORNELL.read_text()), json.loads(DOF.read_text())
    assert got["Camera"]["APERTURE"] == 0.0 and got["Camera"]["FILE"] == "cornell"
    for d in (got, dof):
        del d["Camera"]["APERTURE"], d["Camera"]["FILE"]
    assert got == dof

    want, port = j_load(str(CORNELL)), load_scene(str(CORNELL))
    assert len(port.materials) == len(want.materials) == 5
    assert len(port.geoms) == len(want.geoms) == 7
    assert float(port.state.camera.aperture) == float(want.state.camera.aperture) == 0.0
    assert port.state.image_name == want.state.image_name == "cornell"
    for f in dataclasses.fields(want.state.camera):
        np.testing.assert_array_equal(getattr(port.state.camera, f.name),
                                      getattr(want.state.camera, f.name))
    for a, b in zip(port.materials, want.materials):
        for f in dataclasses.fields(b):
            np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name))
    for a, b in zip(port.geoms, want.geoms):
        assert int(a.type) == int(b.type) and a.material_id == b.material_id
        np.testing.assert_array_equal(a.transform, b.transform)
