"""Op-level A/B of the planned walk's epilogue on the PyTorch/CUDA port
(the port's counterpart of ``scripts/profile_epilogue.py``).

Times kernel VARIANTS of the mesh walk on the production mid-bounce
population (same sorted state, same plan) to see what the per-visit winner
bookkeeping costs on the card:

  prod_lanebest   ``planned_lanebest_intersect`` (front-to-back plan), the
                  reference every exact variant is held to
  prod_planned    ``planned_intersect`` (early exit + per-ray gate)
  prod_mono       ``mono_intersect`` (meshes of at most 8 tiles)
  lb_asc          the lane-best walk over an ASCENDING-TILE-ID plan
                  (the TPU kernel's ties resolve by visit order, its fold a
                  strict "<" only)
  mono            no plan: every tile in id order for a block with a live
                  ray, every pair of the block evaluated, members or not
  mono_gate       mono, a tile only when the block votes that some live ray
                  is a member of it
  lb_mm, mono_mm  timing floors: the four numerators and a minimum fold of
                  det only, as the JAX script's (WRONG results by design)

Every variant runs the block schedule (each tile's pairs dealt over a
block of 512 threads).  lb_asc is prod_lanebest's kernel fed the ascending
plan (the same improvability gate and key minimum: the strict fold has no
counterpart where a tile's pairs are folded by atomics in no order), so
lb_asc against prod_lanebest measures the visit order alone, ascending id
against front to back.  mono, mono_gate and the floors evaluate every
(ray, triangle) pair of the tiles a block takes: a pair of a ray that is
not a member costs its four numerators, a member's pair the epilogue too.
So mono against prod_mono measures the full width (every non-member's
numerators), mono_gate against mono what the member vote saves, and mono
against mono_mm what the members' epilogue costs beyond every pair's
numerators and the floor's fold.  ``wasted_pairs`` is still the full-width
flavors' (ray, tile) pairs beyond those the function needs, and
``schedule_bound_ms`` the bound of the pairs the schedule evaluates (the
wasted pairs at their four numerators each), beside ``bound_ms``, the
function's.

The exact variants are asserted EQUAL in (t, tri) to prod_lanebest on every
ray before anything is timed; a mismatch prints the first five rays and the
script exits non-zero.  With ``--check-plain`` every variant of the two new
kernels is also held bit for bit to its plain PyTorch version on the card.
Times are CUDA events over ``--k`` back-to-back launches; one JSON line per
variant carries them with the card's name and power limit, the variant's
bound (what its function needs of these inputs: ``mono`` and ``mono_gate``
compute ``prod_mono``'s function and share its bound) and, apart from it,
``wasted_pairs``: the (ray, tile) pairs its schedule evaluates beyond that.

    python scripts/torch_profile_epilogue.py --scene scenes/cornell_mesh_5k.json
    python scripts/torch_profile_epilogue.py --device cpu --res 16   # plain versions, no times
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from project3_cuda_path_tracer_2025_tpu_torch.config import RenderConfig  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.models import Renderer  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.ops import intersect_mxu as mxu  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.ops.compaction import permute_path_state  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.ops.intersect import prim_t_min  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.scene import load_scene, set_resolution  # noqa: E402
from project3_cuda_path_tracer_2025_tpu_torch.utils import measure  # noqa: E402

# Float32 operations of the kernels' device functions (csrc/mesh_path.cuh;
# an fma counts two): a ray's features and reciprocal direction, the member
# slab of one tile, one (ray, triangle) pair of an exact walk (19 fma, the
# division, t, the acceptance tests), of a floor flavor (19 fma, the fold's
# compare of det) and a pair's four numerators alone (19 fma).
OPS_WALK_RAY, OPS_TILE, OPS_PAIR, OPS_MM_PAIR, OPS_NUMERATORS = 25, 35, 41, 39, 38


def capture_population(r, cfg, bounce0: bool):
    """The script's population: iteration 1's camera rays, one bounce
    through ``intersect_scene`` + ``shade`` unless ``bounce0``, then the
    signature coherence sort of the whole state, as the fused mesh bounce
    applies it.  Returns (paths, t_limit, live) in sorted order; ``live``:
    alive and inside the root box."""
    tables = r.dev.mxu_mesh
    paths = measure.advance_population(r, cfg, 0 if bounce0 else 1)
    tl = prim_t_min(r.static, cfg, paths.origin, paths.direction)
    perm = mxu.coherence_perm(tables, paths.origin, paths.direction, paths.alive, tl,
                              cfg.ray_sort_bits, cfg.ray_sort_dir_bits, mode="signature")
    paths, (tl,) = permute_path_state(paths, perm, extra=(tl,))
    tl = tl.contiguous()
    live = paths.alive & mxu.root_hit_mask(tables, paths.origin, paths.direction, tl)
    return paths, tl, live.contiguous()


def member_pairs(tables, ro, rd, live, tl, visits) -> int:
    """(live ray, tile) pairs with the ray a member of a tile its block visits."""
    block = torch.arange(ro.x.shape[0], device=live.device) // mxu.RAY_TILE
    rf = mxu._features(tables, ro, rd)
    pairs = 0
    for c, row in enumerate(tables.tile_aabb.tolist()):
        member, _, _ = mxu._member_slab(row, rf.os, rf.inv, tl)
        pairs += int((member & live & visits[block, c]).sum())
    return pairs


def variant_bound(name, tables, ro, rd, live, tl, plan, gate_visits) -> tuple:
    """(bound ms, "bytes" | "operations", wasted pairs, schedule bound ms) of
    one launch of a variant on this population.  The bound counts what the variant's FUNCTION
    needs of these inputs, not what its schedule does: rays, plan and the
    visited tiles' coefficient rows read once, the outputs written once; a
    live ray's features, its member slab of every tile it is offered, and
    the pairs of the tiles it is a member of.  The mono flavors compute
    ``prod_mono``'s function and are bounded as it is.  The floors' function
    is defined over every ray of a visiting block, members or not.  The
    third value is the schedule's extra work, (ray, tile) pairs it evaluates
    that the function does not need: every non-member or dead ray of a block
    times the tiles the block takes (0 for the walks that skip them, None
    for the floors).  The fourth is the bound of the pairs the schedule
    evaluates: the function's work and the wasted pairs' four numerators
    (the function's bound where nothing is wasted)."""
    n, nb, ct = ro.x.shape[0], plan.cnt.shape[0], tables.tile_aabb.shape[0]
    n_live = int(live.sum())
    block = torch.arange(n, device=live.device) // mxu.RAY_TILE
    plan_visits = mxu._plan_visits(plan, ct)
    row_bytes = mxu.TRI_TILE * mxu.COEF_W * 4
    ray_bytes = n * (6 * 4 + 1 + 4 + 8)
    wasted = 0
    if name in ("prod_lanebest", "prod_planned", "lb_asc"):
        pairs = member_pairs(tables, ro, rd, live, tl, plan_visits)
        entries = int((plan.cnt.long()[block] * live).sum())
        tiles = int(plan_visits.any(dim=0).sum())
        nbytes = ray_bytes + nb * (ct * 8 + 4) + tiles * row_bytes
        ops = n_live * OPS_WALK_RAY + entries * OPS_TILE + pairs * mxu.TRI_TILE * OPS_PAIR
    elif name in ("prod_mono", "mono", "mono_gate"):
        every = torch.ones((nb, ct), dtype=torch.bool, device=live.device)
        pairs = member_pairs(tables, ro, rd, live, tl, every)
        nbytes = ray_bytes + ct * row_bytes
        ops = n_live * (OPS_WALK_RAY + ct * OPS_TILE) + pairs * mxu.TRI_TILE * OPS_PAIR
        if name != "prod_mono":  # a visiting block runs the tile at full width
            full_visits = mxu._mono_visits(tables, ro, rd, live, tl, gate=False)
            taken = gate_visits if name == "mono_gate" else full_visits
            wasted = int(taken.sum()) * mxu.RAY_TILE - pairs
    else:  # the floors: every ray of a block times the tiles the block takes
        wasted = None
        if name == "lb_mm":
            visits = int(plan.cnt.sum())
            nbytes = ray_bytes + nb * (ct * 4 + 4) + int(plan_visits.any(dim=0).sum()) * row_bytes
            ops = visits * mxu.RAY_TILE * mxu.TRI_TILE * OPS_MM_PAIR
        else:
            full_visits = mxu._mono_visits(tables, ro, rd, live, tl, gate=False)
            live_blocks = int(full_visits[:, 0].sum())
            nbytes = ray_bytes + ct * row_bytes
            ops = live_blocks * mxu.RAY_TILE * (OPS_WALK_RAY + ct * OPS_TILE) \
                + int(full_visits.sum()) * mxu.RAY_TILE * mxu.TRI_TILE * OPS_MM_PAIR
    schedule_ops = ops + (wasted or 0) * mxu.TRI_TILE * OPS_NUMERATORS
    return (*measure.bound_ms(nbytes, ops), wasted, measure.bound_ms(nbytes, schedule_ops)[0])


def cut_blocks(blocks, ro, rd, live, tl, plan, ct):
    """The first ``blocks`` ray blocks of a population and their plan rows
    (a block reads one plan row, so the cut computes the same function)."""
    m = blocks * mxu.RAY_TILE
    cut = lambda v: type(v)(*(x[:m].contiguous() for x in v))
    return (cut(ro), cut(rd), live[:m].contiguous(), tl[:m].contiguous(),
            mxu.TilePlan(plan.ids[:blocks * ct].contiguous(), plan.tlo[:blocks * ct].contiguous(),
                         plan.cnt[:blocks].contiguous()))


def run(argv=None) -> list:
    """Runs the A/B; returns one record per variant (also printed as JSON
    lines).  Raises ``SystemExit(1)`` when an exact variant disagrees with
    the reference or a kernel with its plain version."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default="scenes/cornell_mesh_5k.json")
    ap.add_argument("--res", type=int, default=800)
    ap.add_argument("--k", type=int, default=24, help="timed launches per variant")
    ap.add_argument("--only", default=None, help="comma-separated substrings of variant names")
    ap.add_argument("--bounce0", action="store_true",
                    help="profile the camera-ray population instead")
    ap.add_argument("--check-plain", action="store_true",
                    help="also hold the new kernels' variants to their plain versions on "
                    "the card, bit for bit, and time the plain versions once")
    ap.add_argument("--mm-plain-blocks", type=int, default=0,
                    help="with --check-plain, hold the floor flavors to their plain version on "
                    "the first N ray blocks only (0: all)")
    measure.add_device_argument(ap)
    args = ap.parse_args(argv)
    device = measure.open_device(args.device)
    on_card = device.type == "cuda"
    card = measure.card_label(device)
    wanted = lambda name: not args.only or any(s in name for s in args.only.split(","))

    scene = set_resolution(load_scene(args.scene), args.res, args.res)
    cfg = RenderConfig(mesh_intersector="mxu", ray_sorting="off")
    r = Renderer(scene, cfg, device=device)
    tables, n = r.dev.mxu_mesh, r.static.pixel_count
    ct = tables.tile_aabb.shape[0]
    eps = cfg.baby_epsilon
    print(f"{args.scene}: {r.static.num_triangles} tris, {ct} tiles, {n} rays, "
          f"device={device} ({card})", flush=True)
    if ct > mxu.PLANNED_MAX_TILES:
        raise SystemExit(f"{ct} tiles exceed the planned walks' {mxu.PLANNED_MAX_TILES}")

    paths, tl, live = capture_population(r, cfg, args.bounce0)
    ro, rd = paths.origin, paths.direction
    plan = mxu.plan_with_prefix(tables.tile_aabb, *mxu.plan_rays(tables, ro, rd, live, tl))
    plan_asc = mxu.ascending_plan(plan, ct)
    nb = plan.cnt.shape[0]
    live_blocks, visits = int((plan.cnt > 0).sum()), int(plan.cnt.sum())
    gate_visits = mxu._mono_visits(tables, ro, rd, live, tl, gate=True)
    print(f"plan: {visits} candidate visits over {live_blocks}/{nb} live blocks "
          f"({int(live.sum())} live rays); full sweep would be {live_blocks * ct}; "
          f"gated sweep {int(gate_visits.sum())}", flush=True)

    # name -> (launch, plain version or None, exact, the wrapper that counts its launches)
    mono = lambda flavor: (
        lambda: mxu.epilogue_mono_intersect(tables, ro, rd, live, tl, eps, flavor),
        lambda *a: mxu.epilogue_mono_plain(tables, *a[:4], eps, flavor),
    )
    variants = {
        "prod_lanebest": (lambda: mxu.planned_lanebest_intersect(tables, ro, rd, live, tl, plan,
                                                                 eps),
                          None, True, mxu.planned_lanebest_intersect),
        "prod_planned": (lambda: mxu.planned_intersect(tables, ro, rd, live, tl, plan, eps),
                         None, True, mxu.planned_intersect),
        "prod_mono": (lambda: mxu.mono_intersect(tables, r.static.num_triangles, ro, rd,
                                                 paths.alive.contiguous(), tl, eps),
                      None, True, mxu.mono_intersect),
        "lb_asc": (lambda: mxu.lb_asc_intersect(tables, ro, rd, live, tl, plan_asc, eps),
                   lambda *a: mxu.lb_asc_plain(tables, *a, eps), True, mxu.lb_asc_intersect),
        "mono": (*mono("full"), True, mxu.epilogue_mono_intersect),
        "mono_gate": (*mono("gate"), True, mxu.epilogue_mono_intersect),
        "lb_mm": (lambda: mxu.lb_asc_intersect(tables, ro, rd, live, tl, plan_asc, eps,
                                               mm_only=True),
                  lambda *a: mxu.lb_asc_plain(tables, *a, eps, mm_only=True), False,
                  mxu.lb_asc_intersect),
        "mono_mm": (*mono("mm"), False, mxu.epilogue_mono_intersect),
    }
    if ct > mxu.MONO_MAX_TILES:
        print(f"prod_mono skipped: {ct} tiles exceed the mono kernel's {mxu.MONO_MAX_TILES}",
              flush=True)
        del variants["prod_mono"]

    # --- the gate: exact variants == prod_lanebest, kernels == plain versions ---
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    launches = {name: 0 for name in variants}
    first = {}
    for name, (fn, _, _, counter) in variants.items():
        if name != "prod_lanebest" and not wanted(name):
            continue
        before = counter.launches
        first[name] = fn()
        sync()
        launches[name] += counter.launches - before
    ref_t, ref_tri = first["prod_lanebest"]
    print(f"reference hits: {int((ref_tri >= 0).sum())}", flush=True)
    failed = False
    identical = {}
    for name, (t, tri) in first.items():
        if not variants[name][2] or name == "prod_lanebest":
            continue
        bad = (t.view(torch.int32) != ref_t.view(torch.int32)) | (tri != ref_tri)
        identical[name] = not bool(bad.any())
        print(f"{name:18s} bit-identical: {identical[name]}", flush=True)
        if not identical[name]:
            failed = True
            for i in torch.nonzero(bad).flatten()[:5].tolist():
                print(f"  ray {i}: t {float(ref_t[i])} vs {float(t[i])}, "
                      f"tri {int(ref_tri[i])} vs {int(tri[i])}", flush=True)
    plain_check = {}
    if args.check_plain and on_card:
        for name, (fn, plain, exact, _) in variants.items():
            if plain is None or name not in first:
                continue
            got, a = first[name], (ro, rd, live, tl)
            asc = plan_asc
            if not exact and args.mm_plain_blocks and args.mm_plain_blocks < nb:
                *a, asc = cut_blocks(args.mm_plain_blocks, ro, rd, live, tl, plan_asc, ct)
                got = tuple(x[:a[3].shape[0]] for x in got)
            a = (*a, asc) if name.startswith("lb_") else tuple(a)
            plain_ms = measure.timed_ms(device, lambda: plain(*a), 1)
            want = plain(*a)
            sync()
            t_bad = got[0].view(torch.int32) != want[0].view(torch.int32)
            bad = t_bad | (got[1] != want[1])
            err = float(torch.where(t_bad, (got[0] - want[0]).abs(),
                                    torch.zeros_like(want[0])).max())
            plain_check[name] = dict(plain_ms=plain_ms, plain_rays=int(want[0].shape[0]),
                                     plain_mismatch=int(bad.sum()), max_abs_err=err)
            print(f"{name:18s} kernel vs plain on {want[0].shape[0]} rays: "
                  f"{int(bad.sum())} differ (max |t| diff {err}); plain {plain_ms:.2f} ms",
                  flush=True)
            failed = failed or bool(bad.any())
    if failed:
        print("a variant disagrees: nothing is timed", flush=True)
        raise SystemExit(1)

    # --- timing (the card only) and the records ---
    records = []
    for name, (fn, _, exact, counter) in variants.items():
        if name not in first:
            continue
        ms = None
        if on_card:
            before = counter.launches
            ms = measure.event_ms(fn, args.k)
            launches[name] += counter.launches - before
        b_ms, b_by, wasted, sched_ms = variant_bound(name, tables, ro, rd, live, tl, plan,
                                                     gate_visits)
        rec = dict(
            script="torch_profile_epilogue", variant=name, scene=os.path.basename(args.scene),
            res=args.res, bounce0=bool(args.bounce0), rays=n, tiles=ct, visits=visits,
            live_blocks=live_blocks, exact=exact,
            identical_to_prod_lanebest=identical.get(name), ms=ms,
            us_per_visit=None if ms is None else ms * 1e3 / max(visits, 1),
            us_per_sweep_visit=None if ms is None else ms * 1e3 / max(live_blocks * ct, 1),
            bound_ms=b_ms, bound_by=b_by, wasted_pairs=wasted, schedule_bound_ms=sched_ms,
            launches=launches[name],
            k=args.k, card=card,
            **plain_check.get(name, {}),
        )
        if ms is not None:
            print(f"{name:18s} {ms:8.3f} ms   {rec['us_per_visit']:6.2f} us/visit "
                  f"({rec['us_per_sweep_visit']:5.2f} us/sweep-visit)", flush=True)
        records.append(measure.emit(rec))
    return records


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
