"""The measuring scripts of the port (``scripts/torch_*.py``) on the CPU:
each ``main([... "--device", "cpu", "--res", "8", ...])`` runs in this
process, exits 0 and prints parseable JSON lines that name the device and
time nothing; none of them imports JAX or the JAX package (checked in a
subprocess, where no test has imported either); ``chip_smoke.py`` lists its
phases and refuses to run without a card.
"""

import importlib.util
import json
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = ("torch_profile_epilogue", "torch_bench_scenes", "torch_scene_matrix",
           "torch_bench_binned", "torch_profile_mesh_bounce", "torch_profile_wavefront",
           "torch_compaction_study", "torch_diag_mesh_traversal", "torch_bench_kernels")
ARGS = {
    "torch_profile_epilogue": ["--res", "8", "--k", "1"],
    "torch_bench_scenes": ["--res", "8", "--spp", "1", "--batch", "1", "--quick", "--scenes",
                           "scenes/cornell_dof.json", "scenes/cornell_mesh_5k.json"],
    "torch_scene_matrix": ["--res", "8", "--spp", "1", "--batch", "1", "--only", "textured"],
    "torch_bench_binned": ["--res", "8", "--depth", "1", "--k", "1",
                           "scenes/cornell_mesh_20k.json"],
    "torch_profile_mesh_bounce": ["--res", "8", "--k", "1"],
    "torch_profile_wavefront": ["--res", "8", "--k", "1"],
    "torch_compaction_study": ["--res", "8", "--spp", "1", "--batch", "1"],
    "torch_diag_mesh_traversal": ["--res", "8", "--k", "1", "--scene",
                                  "scenes/cornell_mesh_20k.json"],
    "torch_bench_kernels": ["--res", "8", "--scenes", "80k", "--bounces", "2", "--k", "1",
                            "--scan-n", "20000"],
}
MIN_LINES = {"torch_profile_epilogue": 8, "torch_bench_scenes": 2, "torch_scene_matrix": 5,
             "torch_bench_binned": 2, "torch_profile_mesh_bounce": 12,
             "torch_profile_wavefront": 9, "torch_compaction_study": 6,
             "torch_diag_mesh_traversal": 9, "torch_bench_kernels": 5}


def _load(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # torch_compaction_study imports torch_bench_scenes by name
    spec.loader.exec_module(mod)
    return mod


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_runs_on_the_cpu_and_prints_json(name, capsys):
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        rc = _load(name).main(ARGS[name] + ["--device", "cpu"])
    finally:
        sys.path.remove(str(REPO / "scripts"))
    assert rc == 0
    recs = _json_lines(capsys.readouterr().out)
    assert len(recs) >= MIN_LINES[name]
    for r in recs:
        assert "error" not in r
        # Nothing is timed on the CPU, and every line says where it ran.
        for key in ("ms", "ms_per_frame", "plain_ms"):
            assert r.get(key) is None
        assert r.get("card", "cpu") == "cpu" and r.get("device", "cpu") == "cpu"
        assert r["script"].startswith("torch_")
    if name == "torch_scene_matrix":
        # The scenes whose textures are not in the repository are recorded
        # as expected load errors; the local stand-ins render sanely.
        assert sum("load_error" in r for r in recs) == 2
        assert all(r["sane"] for r in recs if "load_error" not in r)


def test_profile_epilogue_gates_before_timing(capsys):
    """The epilogue script's records: every exact variant identical to the
    reference, the floors marked inexact, bounds for all, by the function's
    work and not the schedule's."""
    recs = {r["variant"]: r for r in _load("torch_profile_epilogue").run(
        ["--res", "12", "--k", "1", "--device", "cpu", "--scene", "scenes/cornell_mesh_20k.json"])}
    capsys.readouterr()
    assert set(recs) == {"prod_lanebest", "prod_planned", "lb_asc", "mono", "mono_gate", "lb_mm",
                         "mono_mm"}  # 20 tiles: no prod_mono
    for name in ("prod_planned", "lb_asc", "mono", "mono_gate"):
        assert recs[name]["exact"] and recs[name]["identical_to_prod_lanebest"] is True
    assert not recs["lb_mm"]["exact"] and not recs["mono_mm"]["exact"]
    assert all(r["bound_ms"] > 0 and r["bound_by"] in ("bytes", "operations")
               for r in recs.values())
    # A bound counts what the function needs: full and gate compute one
    # function; what their schedules evaluate beyond it is reported apart.
    assert recs["mono"]["bound_ms"] == recs["mono_gate"]["bound_ms"]
    assert recs["mono"]["wasted_pairs"] >= recs["mono_gate"]["wasted_pairs"] > 0
    assert recs["lb_asc"]["wasted_pairs"] == 0 and recs["lb_mm"]["wasted_pairs"] is None


def test_profile_epilogue_exits_nonzero_on_a_wrong_variant(monkeypatch, capsys):
    """A variant that disagrees with the reference is reported (its first
    rays printed) and nothing is timed: the script exits 1."""
    tpe = _load("torch_profile_epilogue")
    real = tpe.mxu.lb_asc_intersect

    def wrong(*a, **kw):
        t, tri = real(*a, **kw)
        return t, tri + (tri >= 0).to(tri.dtype)

    wrong.launches = 0
    monkeypatch.setattr(tpe.mxu, "lb_asc_intersect", wrong)
    with pytest.raises(SystemExit) as exc:
        tpe.run(["--res", "12", "--k", "1", "--device", "cpu", "--only", "lb_asc"])
    out = capsys.readouterr().out
    assert exc.value.code == 1
    assert "lb_asc             bit-identical: False" in out and "  ray " in out
    assert not _json_lines(out)


def test_traversal_runs_cover_every_mode_and_plan():
    tbs = _load("torch_bench_scenes")
    runs = tbs.traversal_runs(tbs.MESH_SCENES)
    for scene in tbs.MESH_SCENES:
        mine = [(cfg["mxu_traversal"], env.get("PTT_PLAN_IMPL"), env.get("PTT_STREAM_SUPER"))
                for p, cfg, env in runs if p == scene]
        for mode in ("auto", "planned", "streamed", "binned"):
            assert (mode, "xla", None) in mine and (mode, "pallas", None) in mine
        assert ("sweep", "xla", None) in mine
        assert (("mono", "xla", None) in mine) == scene.endswith("_5k.json")
    assert ("scenes/cornell_mesh_500k.json", {"mxu_traversal": "streamed",
                                             "mesh_intersector": "mxu"},
            {"PTT_PLAN_IMPL": "pallas", "PTT_STREAM_SUPER": "1"}) in runs


def test_scripts_and_smoke_import_no_jax():
    """Importing every script (and chip_smoke) pulls in neither jax nor the
    JAX package."""
    code = (
        "import sys, importlib.util\n"
        f"sys.path.insert(0, {str(REPO / 'scripts')!r})\n"
        f"for name in {SCRIPTS + ('../chip_smoke',)!r}:\n"
        f"    path = {str(REPO / 'scripts')!r} + '/' + name + '.py'\n"
        "    spec = importlib.util.spec_from_file_location(name.split('/')[-1], path)\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    sys.modules[name.split('/')[-1]] = mod\n"
        "    spec.loader.exec_module(mod)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.split('.')[0] == 'project3_cuda_path_tracer_2025_tpu']\n"
        "print('BAD', bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD []" in out.stdout


def test_chip_smoke_lists_its_phases_and_needs_a_card():
    smoke = [sys.executable, str(REPO / "chip_smoke.py")]
    listed = subprocess.run(smoke + ["--list"], capture_output=True, text=True, timeout=300)
    assert listed.returncode == 0
    for span in ("1-2", "3-7", "8 ", "10-12", "13-14", "15", "16-19", "20", "21", "22", "25",
                 "9 "):
        assert any(line.startswith(span) for line in listed.stdout.splitlines()), span
    import torch

    if not torch.cuda.is_available():
        run = subprocess.run(smoke + ["--phases", "20"], capture_output=True, text=True,
                             timeout=300)
        assert run.returncode == 2 and '"ok"' not in run.stdout


def test_chip_smoke_parses_phase_lists():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.parse_phases("1-7,20") == {1, 2, 3, 4, 5, 6, 7, 20}
    assert smoke.parse_phases("22") == {22}
    numbered = sorted(p for g in smoke.GROUPS for p in g[1])
    assert numbered == [3, 4, 5, 6, 7, 8] + list(range(10, 26))
    assert {g[3] for g in smoke.GROUPS if g[3]} <= {g[0] for g in smoke.GROUPS}


def test_bench_kernels_planned_calls_are_the_chain():
    """``chain_calls`` (the A/B script's, also used by ``chip_smoke.py``
    phases 16 and 17) reads the calls of the 80k planned chain from the
    traversal ``mxu_traversal="planned"`` runs: #6 on the two 32-tile
    chunks, #5 on the last 15 tiles, each call's t_limit the running best;
    folded as the chain folds them, the calls give the traversal's (t, tri)
    on each sorted bounce at 32x32, and the walk entry points are the
    package's again afterwards."""
    import torch

    from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu_torch.ops import intersect_mxu as mxu
    from project3_cuda_path_tracer_2025_tpu_torch.scene import (
        build_device_scene, camera_state, derive_render_camera, load_scene, set_resolution,
    )

    bench = _load("torch_bench_kernels")
    scene = set_resolution(load_scene(str(REPO / "scenes" / "cornell_mesh_80k.json")), 32, 32)
    dev, static = build_device_scene(scene, "cpu")
    cam = camera_state(derive_render_camera(scene.state.camera))
    cfg, tables = RenderConfig(), dev.mxu_mesh
    hits = 0
    for paths, tl, live in bench.sorted_bounces(dev, static, cam, cfg, "cpu", 2):
        ro, rd = paths.origin, paths.direction
        calls = bench.chain_calls(mxu, "planned", tables, static.mxu_padded_tris, ro, rd, live,
                                  tl, 1e-5)
        assert mxu.WALKS["planned"] is mxu.planned_intersect
        assert mxu.WALKS["planned_lanebest"] is mxu.planned_lanebest_intersect
        assert [(k, a[0].tile_aabb.shape[0]) for k, a in calls] == [
            ("planned", 32), ("planned", 32), ("planned_lanebest", 15)]
        best_t, best_tri = tl, torch.full_like(paths.bounces, -1)
        for i, (kind, a) in enumerate(calls):
            assert torch.equal(a[4], best_t)
            t_c, tri_c = mxu.WALKS[kind](*a)
            better = tri_c >= 0
            best_t = torch.where(better, t_c, best_t)
            best_tri = torch.where(better, tri_c + i * mxu.CHUNK_TRIS, best_tri)
        want = mxu.mesh_intersect_mxu(
            tables, static.num_triangles, static.mxu_padded_tris, ro, rd, paths.alive, tl,
            cfg.baby_epsilon, compute_uv=False,
            **mxu.traversal_flags("planned", static.mxu_padded_tris))
        best_tri = torch.where(best_tri >= static.num_triangles, -1, best_tri)
        assert torch.equal(best_t, want.t) and torch.equal(best_tri, want.tri)
        hits += int((best_tri >= 0).sum())
    assert hits > 20


def test_chip_smoke_walk_bound_counts_the_pairs_the_result_needs():
    """``chip_smoke.py``'s bound of a planned walk counts the (ray, tile)
    pairs whose slab entry is no farther than the ray's final hit: the
    same pairs as the sweep's bound over every tile (the plan lists every
    tile a ray of its block enters), fewer than the plan's member pairs,
    on each sorted 20k bounce at 32x32."""
    import torch

    from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu_torch.ops import intersect_mxu as mxu
    from project3_cuda_path_tracer_2025_tpu_torch.scene import (
        build_device_scene, camera_state, derive_render_camera, load_scene, set_resolution,
    )

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    bench = _load("torch_bench_kernels")
    scene = set_resolution(load_scene(str(REPO / "scenes" / "cornell_mesh_20k.json")), 32, 32)
    dev, static = build_device_scene(scene, "cpu")
    cam = camera_state(derive_render_camera(scene.state.camera))
    tables = dev.mxu_mesh
    every = torch.ones((-(-static.pixel_count // mxu.RAY_TILE), tables.tile_aabb.shape[0]),
                       dtype=torch.bool)
    gated = listed = 0
    for st in bench.sorted_bounces(dev, static, cam, RenderConfig(), "cpu", 2):
        args = smoke.walk_args(tables, *st)
        hit_t = mxu.planned_lanebest_intersect(*args)[0]
        walk = smoke.walk_bound(args, hit_t)
        sweep = smoke.visit_bound(*args[:5], every, 0, gate_t=hit_t)
        member = smoke.visit_bound(*args[:5], mxu._plan_visits(args[5], every.shape[1]), 0)
        assert walk[2] == sweep[2] and walk[0] > 0.0
        gated, listed = gated + walk[2], listed + member[2]
    assert 0 < gated < listed


def test_bench_kernels_mono_and_binned_lines_on_the_cpu(capsys):
    """``torch_bench_kernels.py --walks mono binned`` on the CPU at 8x8: a
    mono line per sorted 5k bounce, a binned line per 200k bounce where a
    binned tier engages (with its visits and prefix), the 5k sorted and
    unsorted frames with one film hash (the sort changes no film), the
    textured-mesh and 200k "auto" frames; nothing timed."""
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        recs = _load("torch_bench_kernels").run(
            ["--device", "cpu", "--res", "8", "--scenes", "5k", "200k", "--walks", "mono",
             "binned", "--bounces", "2", "--k", "1", "--scan-n", "2000"])
    finally:
        sys.path.remove(str(REPO / "scripts"))
    walks = [(r["walk"], r["scene"], r["bounce"]) for r in recs if r["kind"] == "walk"]
    assert walks[:2] == [("mono", "5k", 0), ("mono", "5k", 1)]
    binned = [r for r in recs if r["kind"] == "walk" and r["walk"] == "binned"]
    assert binned and all(r["visits"] > 0 and r["prefix"] % 256 == 0 for r in binned)
    frames = {(r["scene"], r["traversal"]): r["film_sha"] for r in recs if r["kind"] == "frame"}
    assert set(frames) == {("5k", "auto"), ("5k", "auto, unsorted"), ("mesh_textured", "auto"),
                           ("200k", "auto")}
    assert frames[("5k", "auto")] == frames[("5k", "auto, unsorted")]
    assert all(r["ms"] is None for r in recs if "ms" in r)


def test_bench_kernels_shade_and_iteration_lines_on_the_cpu(capsys):
    """``torch_bench_kernels.py --kernels shade iteration`` on the CPU at
    8x8: a shade line per sorted bounce of the 5k, textured and 200k meshes,
    with the carried winner and the main path's emit (the key up to 24
    tiles, none on the frame's last bounce); the five "auto" frames; an
    iteration line per scene with the per-pixel schedule's lane counts (the
    counting build needs the card); nothing timed."""
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        recs = _load("torch_bench_kernels").run(
            ["--device", "cpu", "--res", "8", "--kernels", "shade", "iteration", "--bounces", "8",
             "--k", "1"])
    finally:
        sys.path.remove(str(REPO / "scripts"))
    shade = [r for r in recs if r["kind"] == "shade"]
    assert [(r["scene"], r["bounce"]) for r in shade] == [
        (s, d) for s in ("5k", "mesh_textured", "200k") for d in range(8)]
    assert all(r["carried"] for r in shade)
    emits = {(r["scene"], r["bounce"]): r["emit"] for r in shade}
    assert emits[("5k", 0)] == emits[("mesh_textured", 0)] == "tlim+key"
    assert emits[("200k", 0)] == "tlim" and emits[("5k", 7)] == ""
    assert {r["mode"] for r in shade if r["scene"] == "mesh_textured"} == {"textured"}
    frames = {(r["scene"], r["traversal"]) for r in recs if r["kind"] == "frame"}
    assert frames == {("5k", "auto"), ("5k", "auto, unsorted"), ("mesh_textured", "auto"),
                      ("200k", "auto"), ("20k", "auto"), ("80k", "auto")}
    its = [r for r in recs if r["kind"] == "iteration"]
    assert [(r["scene"], r["depth"]) for r in its] == [
        ("cornell_dof", 8), ("cornell_all_lobes", 8), ("depth80", 80)]
    for r in its:
        assert 0 < r["per_pixel_live"] <= r["per_pixel_issued"] and "regen_live" not in r
    assert all(r["ms"] is None for r in recs if "ms" in r)


def test_chip_smoke_mono_and_binned_bounds():
    """``chip_smoke.py``'s bound of a mono launch counts the same (ray,
    tile) pairs as the sweep's bound over every tile behind the root cull
    (the pairs whose entry is within the ray's final hit); its binned bound
    splits the pair rows into members of their visit's tile, live rows and
    all rows, on the sorted 5k and 200k bounces at 32x32."""
    import torch

    from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu_torch.ops import intersect_mxu as mxu
    from project3_cuda_path_tracer_2025_tpu_torch.scene import (
        build_device_scene, camera_state, derive_render_camera, load_scene, set_resolution,
    )

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    bench = _load("torch_bench_kernels")
    cfg = RenderConfig()
    members = 0
    for name in ("5k", "200k"):
        scene = set_resolution(load_scene(str(REPO / "scenes" / f"cornell_mesh_{name}.json")),
                               32, 32)
        dev, static = build_device_scene(scene, "cpu")
        cam = camera_state(derive_render_camera(scene.state.camera))
        tables = dev.mxu_mesh
        for paths, tl, live in bench.sorted_bounces(dev, static, cam, cfg, "cpu", 2):
            if name == "5k":
                args = (tables, static.num_triangles, paths.origin, paths.direction,
                        paths.alive, tl, cfg.baby_epsilon)
                b = smoke.mono_bound(args)
                every = torch.ones((-(-static.pixel_count // mxu.RAY_TILE),
                                    tables.tile_aabb.shape[0]), dtype=torch.bool)
                hit_t = mxu.mono_intersect(*args)[0]
                sweep = smoke.visit_bound(tables, paths.origin, paths.direction, live, tl,
                                          every, 0, gate_t=hit_t)
                assert torch.equal(b[3], live) and b[2] == sweep[2] > 0 and b[0] > 0.0
                continue
            found = bench.binned_args(mxu, tables, paths, tl, live, cfg.mxu_binned_tiers)
            if found is None:
                continue
            b = smoke.binned_bound(found[0])
            (ok_rows, rows), pairs = b[3], b[2]
            assert 0 < pairs <= ok_rows <= rows == found[0][5].numel() * mxu.RAY_TILE
            members += pairs
    assert members > 0


def test_bench_kernels_bounce_and_prepass_lines_on_the_cpu(capsys):
    """``torch_bench_kernels.py --kernels bounce prepass`` on the CPU at
    8x8: two bounce lines ("main", drawing inline, and "uniforms", the
    [3, n] plane) per bounce of ``cornell_dof``, ``cornell_all_lobes`` and
    the depth-80 scene, with one result hash a bounce and the per-ray
    schedule's lane counts; a prepass line per sorted 80k bounce and at
    bounce 0 of 200k and 500k, with its pair counts (the live rays' pairs
    no more than the per-block design's) and the work its bound counts (the
    live pairs' tests; the dead rays' live flags, the live rays' 28 bytes);
    the ``cornell_dof`` bounce-kernel
    frame and the 80k frame with the plan kernel; nothing timed.  The
    chip_smoke bound of a bounce counts the live rays' pixels and draws."""
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        bench = _load("torch_bench_kernels")
        recs = bench.run(
            ["--device", "cpu", "--res", "8", "--kernels", "bounce", "prepass", "--bounces",
             "3", "--k", "1"])
    finally:
        sys.path.remove(str(REPO / "scripts"))
    bounces = [r for r in recs if r["kind"] == "bounce"]
    assert [(r["scene"], r["bounce"], r["form"]) for r in bounces] == [
        (s, d, f) for s in ("cornell_dof", "cornell_all_lobes", "depth80") for d in range(3)
        for f in ("main", "uniforms")]
    for main, given in zip(bounces[::2], bounces[1::2]):
        assert main["result_sha"] == given["result_sha"] and main["inline"]
        assert 0 < main["live"] <= main["per_ray_issued"] and "kernel_live" not in main
    pre = [r for r in recs if r["kind"] == "prepass"]
    assert [(r["scene"], r["bounce"]) for r in pre] == [
        ("80k", 0), ("80k", 1), ("80k", 2), ("200k", 0), ("500k", 0)]
    for r in pre:
        assert r["pairs_live"] == r["live"] * r["tiles"] <= r["pairs_per_block_design"]
        assert r["pairs_per_block_design"] == 256 * r["live_blocks"] * r["tiles"]
        assert r["operations"] == r["pairs_live"] * bench.OPS_PLAN_PAIR
        rows = r["bytes_needed"] - 28 * r["live"] - 32 * r["tiles"]  # live flags, (h, lb)
        assert rows > 0 and rows % (256 + 5 * r["tiles"]) == 0
    frames = {(r["scene"], r["traversal"]) for r in recs if r["kind"] == "frame"}
    assert frames == {("cornell_dof", "bounce kernel"), ("80k", "auto, PTT_PLAN_IMPL=pallas")}
    assert all(r["ms"] is None for r in recs if "ms" in r)

    from project3_cuda_path_tracer_2025_tpu_torch.scene import build_device_scene, load_scene

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _, static = build_device_scene(load_scene(str(REPO / "scenes" / "cornell_dof.json")), "cpu")
    drawn, given = smoke.bounce_bound(static, 1000, 400), smoke.bounce_bound(
        static, 1000, 400, drawn=False)
    assert drawn[0] > 0.0 and given[0] > 0.0
    live_ops = 400 * (smoke.prim_ops(static) + smoke.OPS_SCATTER)
    assert smoke.bound_ms(1000 * 80 + 400 * 4, live_ops + 400 * 3 * smoke.OPS_UNIFORM) == drawn
    assert smoke.bound_ms(1000 * 92, live_ops) == given


def test_bench_kernels_epilogue_lines_on_the_cpu(capsys):
    """``torch_bench_kernels.py --kernels epilogue`` on the CPU at 8x8: a
    line per flavor on the 5k and 20k populations, mid-bounce and at bounce
    0 (#4 at 5k only); every exact flavor equal to the lane-best walk, with
    its hash; the schedule's bound above the function's by the wasted
    pairs' numerators for "full" and "gate", equal to it elsewhere; nothing
    timed."""
    from project3_cuda_path_tracer_2025_tpu_torch.utils.measure import PEAK_F32_S

    sys.path.insert(0, str(REPO / "scripts"))
    try:
        recs = _load("torch_bench_kernels").run(
            ["--device", "cpu", "--res", "8", "--kernels", "epilogue", "--k", "1"])
    finally:
        sys.path.remove(str(REPO / "scripts"))
    capsys.readouterr()
    lines = [r for r in recs if r["kind"] == "epilogue"]
    flavors = ("lanebest", "mono", "lb_asc", "lb_mm", "full", "gate", "mm")
    assert [(r["scene"], r["bounce0"], r["flavor"]) for r in lines] == [
        (s, b, f) for s in ("5k", "20k") for b in (False, True) for f in flavors
        if s == "5k" or f != "mono"]
    tpe = _load("torch_profile_epilogue")
    for r in lines:
        ref = next(q for q in lines if (q["scene"], q["bounce0"], q["flavor"]) ==
                   (r["scene"], r["bounce0"], "lanebest"))
        if r["flavor"] in ("lb_mm", "mm"):
            assert r["equal_to_lanebest"] is None and r["wasted_pairs"] is None
        else:
            assert r["equal_to_lanebest"] is True and r["result_sha"] == ref["result_sha"]
        if r["flavor"] in ("full", "gate"):
            assert r["wasted_pairs"] > 0
            numerators_ms = r["wasted_pairs"] * 1024 * tpe.OPS_NUMERATORS / PEAK_F32_S * 1e3
            assert r["schedule_bound_ms"] > max(r["bound_ms"], numerators_ms)
        else:
            assert r["schedule_bound_ms"] == r["bound_ms"]
        assert r["ms"] is None and r["device_ms"] is None
