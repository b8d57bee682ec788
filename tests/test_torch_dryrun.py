"""The port's ``dryrun_multichip`` (``project3_cuda_path_tracer_2025_tpu_torch/entry.py``)
on the CPU, four shards named on one device.

Every tag of ``__graft_entry__.dryrun_multichip`` runs, in its order.  The
``megakernel`` and ``wavefront`` films meet the goldens' bar against the
JAX package's ``parallel.mesh.dryrun`` at the same sizes on
``tests/conftest.py``'s virtual CPU devices, alive counts equal (the other
JAX tags run Pallas in interpret mode and are left out).  Every
``shardmap+*`` film equals the port's unsharded film of the same
configuration bit for bit.
"""

import pathlib

import jax
import numpy as np
import pytest

from project3_cuda_path_tracer_2025_tpu.parallel.mesh import dryrun as j_dryrun
from project3_cuda_path_tracer_2025_tpu_torch import entry
from torch_compare import assert_films_close

REPO = pathlib.Path(__file__).resolve().parent.parent
ND = 4
# __graft_entry__.dryrun_multichip's tags, in its order.
JAX_TAGS = [
    "megakernel", "mesh+mxu", "wavefront", "shardmap+fused-prim", "shardmap+fused-mesh",
    "shardmap+streamed-traversal", "shardmap+binned-traversal", "shardmap+fused-tex",
    "shardmap+sample-parallel",
]
BY_TAG = {t[0]: t for t in entry.TAGS}


@pytest.fixture(scope="module")
def ran():
    return entry.dryrun_multichip(ND, devices=["cpu"] * ND)


def test_every_tag_runs(ran):
    assert list(ran) == JAX_TAGS == [t[0] for t in entry.TAGS]
    for tag, (film, alive) in ran.items():
        assert np.isfinite(film).all() and film.sum() > 0, tag
        assert alive[0] > 0, tag
    source = (REPO / "__graft_entry__.py").read_text()
    for tag in JAX_TAGS:  # every name is __graft_entry__.py's
        assert f'"{tag}"' in source or tag.endswith("-traversal"), tag


@pytest.mark.skipif(len(jax.devices()) < ND, reason=f"needs {ND} (virtual) devices")
@pytest.mark.parametrize("tag", ["megakernel", "wavefront"])
def test_dryrun_matches_jax(ran, tag):
    _, kind, scene, w, h, kw = BY_TAG[tag]
    assert kind == "dryrun"
    jfilm, jalive, mesh = j_dryrun(ND, str(scene), width=w, height=h, **kw)
    assert mesh.size == ND
    want = np.stack([np.asarray(jfilm.x), np.asarray(jfilm.y), np.asarray(jfilm.z)], 1)
    film, alive = ran[tag]
    np.testing.assert_array_equal(alive, np.asarray(jalive))
    assert_films_close(film, want)


@pytest.mark.parametrize("tag", [t for t in JAX_TAGS if t.startswith("shardmap+")])
def test_sharded_film_equals_unsharded(ran, tag):
    film, alive = ran[tag]
    want, want_alive = entry.run_unsharded(BY_TAG[tag], ND, "cpu")
    if tag != "shardmap+sample-parallel":  # one step of nd shards: nd spp
        np.testing.assert_array_equal(alive, want_alive)
    np.testing.assert_array_equal(film, want)
