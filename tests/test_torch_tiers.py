"""Bounce prefix tiers (``RenderConfig.bounce_prefix_tiers``) in the port.

A tiered bounce runs over the smallest prefix of the state that holds every
alive ray (``ops.fused.run_tiered`` / ``run_tiered_carry``), the dead tail
passing through; every stage is per ray with pixel-keyed draws, so the film
must be the same bit for bit as the untiered film, with the same alive
counts.  On the CPU (the kernels' plain versions), after the JAX package's
``tests/test_fused.py`` and ``tests/test_integrators.py``:

* the fused mesh bounce on the 5k mesh at 32x32, depth 6 (``mesh_intersector
  ="mxu"``, ``fused_bounce="on"``, ``ray_sorting="on"``), and with the
  binned traversal, whose pair budget stays anchored to the unsliced ray
  count;
* the textured-prim bounce (``cornell_prim_textured_local.json``, 32x32,
  depth 6), liveness-packed;
* the wavefront at 48x48 with compaction on (with and without material
  sort) and "adaptive";
* pixel mode at nd=2 and ``pixel_chunks=4`` with tiers, against the
  unsharded untiered film: each block tiers its own rows.

Each case also shows that a tier engaged: the bounce bodies are counted by
the rows they ran on.  The JAX package's tiered film is in
``tests/test_torch_tiers_jax.py``.
"""

import pathlib

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer, wavefront
from project3_cuda_path_tracer_2025_tpu_torch.ops import compaction, fused
from project3_cuda_path_tracer_2025_tpu_torch.ops import intersect_mxu as mxu
from project3_cuda_path_tracer_2025_tpu_torch.ops.rays import PathState
from project3_cuda_path_tracer_2025_tpu_torch.scene import load_scene, set_resolution
from project3_cuda_path_tracer_2025_tpu_torch.utils.vec import Vec3

REPO = pathlib.Path(__file__).resolve().parent.parent
MESH = str(REPO / "scenes" / "cornell_mesh_5k.json")
PRIM_TEX = str(REPO / "scenes" / "cornell_prim_textured_local.json")
DOF = str(REPO / "scenes" / "cornell_dof.json")
TIERS = (4, 2)
SORTED_MESH = dict(mesh_intersector="mxu", fused_bounce="on", ray_sorting="on")

torch.set_num_threads(1)


@pytest.fixture
def heads(monkeypatch):
    """The rows each bounce body ran on, by path: the fused mesh bounce, the
    textured-prim bounce and the wavefront's stages."""
    seen = {"mesh": [], "tex": [], "wavefront": []}

    def spy(kind, fn, at):
        def run(*args, **kw):
            seen[kind].append(args[at].pixel.shape[0])
            return fn(*args, **kw)
        return run

    monkeypatch.setattr(fused, "_fused_mesh_bounce_at", spy("mesh", fused._fused_mesh_bounce_at, 3))
    monkeypatch.setattr(fused, "_fused_tex_bounce_at", spy("tex", fused._fused_tex_bounce_at, 3))
    monkeypatch.setattr(wavefront, "intersect_scene", spy("wavefront", wavefront.intersect_scene, 2))
    return seen


def _scene(path, res, depth):
    s = set_resolution(load_scene(path), res, res)
    s.state.trace_depth = depth
    return s


def _render(scene, spp=2, **cfg):
    r = Renderer(scene, RenderConfig(**cfg), seed=0, device="cpu")
    r.step_many(spp)
    return r._flat_film(), np.asarray(r._alive_counts)


def _assert_same(a, b):
    (fa, aa), (fb, ab) = a, b
    for x, y in zip(fa, fb):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    np.testing.assert_array_equal(aa, ab)
    assert sum(float(x.sum()) for x in fa) > 0


def _tiered_rows(rows, n):
    """The tiers engaged, as row counts below the frame's ``n``."""
    return sorted({r for r in rows if r < n})


# ---------------------------------------------------------------------------
# The tier arithmetic and the head/tail split
# ---------------------------------------------------------------------------

def _paths(n, alive_rows, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda: torch.from_numpy(rng.normal(size=n).astype(np.float32))
    bounces = torch.zeros(n, dtype=torch.int32)
    bounces[alive_rows] = 3
    return PathState(Vec3(f(), f(), f()), Vec3(f(), f(), f()), Vec3(f(), f(), f()),
                     torch.randperm(n, generator=torch.Generator().manual_seed(seed))
                     .to(torch.int32), bounces)


@pytest.mark.parametrize("last_alive,want", [(-1, 256), (0, 256), (255, 256), (256, 512),
                                             (511, 512), (512, None), (1023, None)])
def test_engaged_tier_is_the_smallest_holding_the_alive_rays(last_alive, want):
    npres = fused.tier_sizes(1024, TIERS)
    assert npres == [256, 512]
    alive = [last_alive] if last_alive >= 0 else []
    assert fused.engaged_tier(_paths(1024, alive), npres) == want
    assert fused.engaged_tier(_paths(1024, alive), []) is None


def test_run_tiered_runs_the_head_and_keeps_the_tail():
    paths = _paths(1024, [3, 100, 300])
    seen = []

    def body(head):
        seen.append(head.pixel.shape[0])
        return head._replace(bounces=head.bounces - 1, color=head.color * 2.0)

    out = fused.run_tiered(paths, fused.tier_sizes(1024, TIERS), body)
    assert seen == [512]
    np.testing.assert_array_equal(out.bounces[:512].numpy(), (paths.bounces[:512] - 1).numpy())
    np.testing.assert_array_equal(out.bounces[512:].numpy(), paths.bounces[512:].numpy())
    np.testing.assert_array_equal(out.color.x[:512].numpy(), (paths.color.x[:512] * 2).numpy())
    np.testing.assert_array_equal(out.color.y[512:].numpy(), paths.color.y[512:].numpy())
    np.testing.assert_array_equal(out.pixel.numpy(), paths.pixel.numpy())
    # no tier holds them: the full state
    out = fused.run_tiered(_paths(1024, [600]), [256, 512], body)
    assert seen == [512, 1024]


@pytest.mark.parametrize("winner", [False, True])
@pytest.mark.parametrize("key", [False, True])
def test_run_tiered_carry_cuts_and_fills_the_carry(key, winner):
    n = 1024
    paths = _paths(n, [0, 200])
    rng = np.random.default_rng(1)
    carry = fused.MeshCarry(
        t_lim=torch.from_numpy(rng.random(n).astype(np.float32)),
        key=torch.arange(n, dtype=torch.int32) if key else None,
        win=torch.full((n,), 2, dtype=torch.int32) if winner else None)
    got = {}

    def body(head, head_carry):
        got["rows"] = head.pixel.shape[0]
        got["carry"] = head_carry
        return head, fused.MeshCarry(*(None if c is None else c + 1 for c in head_carry))

    out_p, out_c = fused.run_tiered_carry(paths, carry, [256, 512], body, True)
    assert got["rows"] == 256
    assert all(c is None or c.shape[0] == 256 for c in got["carry"])
    assert isinstance(got["carry"], fused.MeshCarry) and isinstance(out_c, fused.MeshCarry)
    np.testing.assert_array_equal(out_c.t_lim[:256].numpy(), (carry.t_lim[:256] + 1).numpy())
    assert (out_c.t_lim[256:] == np.float32(3.402823466e38)).all()
    if key:
        assert (out_c.key[256:] == mxu.DEAD_KEY).all()
        assert out_c.key.dtype == torch.int32
    else:
        assert out_c.key is None
    if winner:
        assert (out_c.win[256:] == -1).all() and (out_c.win[:256] == 3).all()
    else:
        assert out_c.win is None
    np.testing.assert_array_equal(out_p.pixel.numpy(), paths.pixel.numpy())
    # without want_carry the body returns paths alone
    out = fused.run_tiered_carry(paths, carry, [256, 512], lambda h, c: h, False)
    assert isinstance(out, PathState) and out.pixel.shape[0] == n


def test_liveness_pack_is_a_stable_argsort():
    """The textured-prim bounce's alive-first permutation (the compaction's
    front pack, the scan kernel on the card) is the stable argsort of
    ``where(alive, 0, 1)``."""
    rng = np.random.default_rng(4)
    for n, share in ((1000, 0.3), (2304, 0.8), (300, 0.0), (513, 1.0)):
        alive = torch.from_numpy(rng.random(n) < share)
        perm, live = compaction.front_pack_permutation(alive)
        want = torch.argsort(torch.where(alive, 0, 1), stable=True)
        np.testing.assert_array_equal(perm.numpy(), want.numpy())
        assert int(live) == int(alive.sum())
        paths = _paths(n, torch.nonzero(alive).flatten())
        packed = fused._liveness_pack(paths)
        np.testing.assert_array_equal(packed.pixel.numpy(), paths.pixel[want].numpy())
        np.testing.assert_array_equal(packed.origin.z.numpy(), paths.origin.z[want].numpy())


def test_tiers_resolve_by_device():
    """"auto" runs none on any device (the JAX package: (4, 2) on an
    accelerator); a tuple is taken as it is."""
    assert RenderConfig().resolved_prefix_tiers("cpu") == ()
    assert RenderConfig().resolved_prefix_tiers("cuda") == ()
    assert RenderConfig(bounce_prefix_tiers=[4, 2]).resolved_prefix_tiers("cuda") == TIERS
    cfg = RenderConfig(bounce_prefix_tiers=TIERS, ray_sorting="on")
    assert fused.tex_sort_active(cfg, "cpu")
    assert not fused.tex_sort_active(cfg.replace(bounce_prefix_tiers=()), "cpu")
    assert not fused.tex_sort_active(cfg.replace(ray_sorting="off"), "cpu")


# ---------------------------------------------------------------------------
# Films: tiered against untiered, bit for bit
# ---------------------------------------------------------------------------

def test_mesh_tiers_match_untiered(heads):
    scene = _scene(MESH, 32, 6)
    base = _render(scene, **SORTED_MESH)
    heads["mesh"].clear()
    tiered = _render(scene, bounce_prefix_tiers=TIERS, **SORTED_MESH)
    _assert_same(tiered, base)
    assert _tiered_rows(heads["mesh"], 1024) == [512]


def test_mesh_tiers_need_sorting(heads):
    """Without the persistent sort the alive rays are spread over the state:
    no tier engages (the JAX package's gate)."""
    scene = _scene(MESH, 32, 6)
    _render(scene, spp=1, bounce_prefix_tiers=TIERS,
            **{**SORTED_MESH, "ray_sorting": "off"})
    assert _tiered_rows(heads["mesh"], 1024) == []


def test_binned_tiers_match_untiered(heads, monkeypatch):
    """Binned with tiers: bit-equal to binned without them and to the
    default traversal; under a tier the pair budget is anchored to the
    frame's 1,024 rays, not the head's, and the binned walk (not its
    streamed fallback) runs on the head."""
    scene = _scene(MESH, 32, 6)
    base = _render(scene, spp=1, **SORTED_MESH)
    binned = _render(scene, spp=1, mxu_traversal="binned", **SORTED_MESH)
    calls = []
    traverse, walk = mxu.mesh_intersect_mxu, mxu.binned_intersect

    def spy_traverse(tables, num_tris, padded, ro, *a, **kw):
        calls.append(("budget", ro.x.shape[0], kw.get("binned_budget_rays")))
        return traverse(tables, num_tris, padded, ro, *a, **kw)

    def spy_walk(tables, ro, *a, **kw):
        calls.append(("binned", ro.x.shape[0]))
        return walk(tables, ro, *a, **kw)

    monkeypatch.setattr(mxu, "mesh_intersect_mxu", spy_traverse)
    monkeypatch.setattr(mxu, "binned_intersect", spy_walk)
    heads["mesh"].clear()
    tiered = _render(scene, spp=1, mxu_traversal="binned", bounce_prefix_tiers=TIERS,
                     **SORTED_MESH)
    _assert_same(tiered, binned)
    _assert_same(tiered, base)
    assert _tiered_rows(heads["mesh"], 1024) == [512]
    assert ("budget", 512, 1024) in calls
    assert all(c[2] == 1024 for c in calls if c[0] == "budget")
    assert ("binned", 512) in calls


def test_textured_prim_tiers_match_untiered(heads):
    scene = _scene(PRIM_TEX, 32, 6)
    cfg = dict(fused_bounce="on", ray_sorting="on", mesh_intersector="mxu")
    base = _render(scene, **cfg)
    assert heads["tex"] and set(heads["tex"]) == {1024}
    heads["tex"].clear()
    tiered = _render(scene, bounce_prefix_tiers=TIERS, **cfg)
    _assert_same(tiered, base)
    assert _tiered_rows(heads["tex"], 1024) == [512]


@pytest.mark.parametrize("compaction_mode,material_sort", [
    (True, True), (True, False), ("adaptive", False),
])
def test_wavefront_tiers_match_untiered(heads, compaction_mode, material_sort):
    scene = _scene(DOF, 48, 8)
    cfg = dict(integrator="wavefront", stream_compaction=compaction_mode,
               material_sorting=material_sort)
    base = _render(scene, **cfg)
    heads["wavefront"].clear()
    tiered = _render(scene, bounce_prefix_tiers=TIERS, **cfg)
    _assert_same(tiered, base)
    # 48x48 = 2,304 rays: the n/4 tier is 768 rows, n/2 1,280
    assert _tiered_rows(heads["wavefront"], 2304) == [768, 1280]


def test_wavefront_tiers_need_compaction(heads):
    scene = _scene(DOF, 48, 8)
    _render(scene, spp=1, integrator="wavefront", stream_compaction=False,
            bounce_prefix_tiers=TIERS)
    assert _tiered_rows(heads["wavefront"], 2304) == []


@pytest.mark.parametrize("case", ["mesh pixel nd=2", "textured prims pixel nd=2",
                                  "wavefront pixel nd=2", "wavefront pixel_chunks=4"])
def test_sharded_tiers_match_unsharded(heads, case):
    """Each block tiers its own rows with the frame's RNG stream: the tiered
    sharded or chunked film equals the unsharded untiered one."""
    path, res, depth, cfg, kind = {
        "mesh pixel nd=2": (MESH, 32, 6, dict(devices=2, **SORTED_MESH), "mesh"),
        "textured prims pixel nd=2": (PRIM_TEX, 32, 6, dict(
            devices=2, fused_bounce="on", ray_sorting="on", mesh_intersector="mxu"), "tex"),
        "wavefront pixel nd=2": (DOF, 48, 8, dict(
            devices=2, integrator="wavefront", stream_compaction=True), "wavefront"),
        "wavefront pixel_chunks=4": (DOF, 48, 8, dict(
            pixel_chunks=4, integrator="wavefront", stream_compaction=True), "wavefront"),
    }[case]
    scene = _scene(path, res, depth)
    plain = {k: v for k, v in cfg.items() if k not in ("devices", "pixel_chunks")}
    base = _render(scene, **plain)
    heads[kind].clear()
    tiered = _render(scene, bounce_prefix_tiers=TIERS, **cfg)
    _assert_same(tiered, base)
    blocks = cfg.get("devices", 1) * cfg.get("pixel_chunks", 1)
    local = res * res // blocks
    assert set(heads[kind]) >= {local}
    assert _tiered_rows(heads[kind], local), heads[kind]
