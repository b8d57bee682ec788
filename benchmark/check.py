"""The output check that decides ``correct``: what the timed path produced,
at the timed size, against the plain reference.

The film is an answer of one value a pixel, so the check compares a sample
of pixels drawn from the seed, once the window has closed: the images the
host received (the final film, or a sample of the displayed previews:
drag steps, still steps and the longest accumulation), against the
reference rendering each with the camera that the inputs up to it give,
over the iterations since its last reset, its paths added in the same
order in float32; and, where the limits ask for it, the number of paths
alive after each bounce of the window's last iteration over the whole
frame.

Each sampled value's gap is the sum over channels of ``|program -
reference|`` over the reference's sum over channels (at least a thousandth
of the mean, so a black pixel does not divide by nothing).  The numbers
that may be compared are the largest gap, the mean gap and the share of
values whose gap exceeds ``OFF``; ``limits/<cell>.json`` names those that
are, each with its limit.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import scene as ref_scene
from reference.tracer import Tracer

OFF = 1e-4


def sample(rng: np.random.Generator, n: int, count: int) -> np.ndarray:
    """``count`` distinct flat pixel ids of ``n``, sorted."""
    return np.sort(rng.choice(n, size=min(count, n), replace=False))


def gaps(program: np.ndarray, reference: np.ndarray, prefix: str) -> dict:
    """The comparable numbers of ``[M, 3]`` values against the reference's."""
    program = np.asarray(program, np.float64).reshape(-1, 3)
    reference = np.asarray(reference, np.float64).reshape(-1, 3)
    den = reference.sum(axis=1)
    floor = max(1e-3 * float(np.mean(np.abs(den))), 1e-12)
    g = np.abs(program - reference).sum(axis=1) / np.maximum(np.abs(den), floor)
    g = np.where(np.isfinite(program).all(axis=1), g, np.inf)
    return {prefix + "max_gap": float(g.max()), prefix + "mean_gap": float(g.mean()),
            prefix + "share_off": float(np.mean(g > OFF))}


def reference_sums(tracer: Tracer, cameras: list, jobs: list) -> list:
    """For each job ``(camera index, pixels, k)``: ``[P, 3]`` float32, each
    pixel's colour through ``cameras[camera index]`` over iterations 1..k,
    added in iteration order as a film accumulates."""
    pix, its, cam = [], [], []
    for c, pixels, k in jobs:
        p = torch.as_tensor(pixels, dtype=torch.int64)
        pix.append(p.repeat(k))
        its.append(torch.arange(1, k + 1, dtype=torch.int64).repeat_interleave(len(p)))
        cam.append(torch.full((k * len(p),), c, dtype=torch.int64))
    rgb, _ = tracer.radiance(cameras, torch.cat(pix), torch.cat(its), torch.cat(cam))
    out, start = [], 0
    for _, pixels, k in jobs:
        block = rgb[start:start + k * len(pixels)].numpy().reshape(k, len(pixels), 3)
        start += k * len(pixels)
        acc = np.zeros((len(pixels), 3), np.float32)
        for c in block:
            acc += c
        out.append(acc)
    return out


def alive_gap(tracer: Tracer, camera, iteration: int, program_alive) -> float:
    """The largest relative gap of the paths alive after each bounce of one
    whole-frame iteration."""
    n = tracer.scene.pixel_count
    _, alive = tracer.radiance([camera], torch.arange(n), torch.full((n,), iteration))
    ref = alive.numpy().astype(np.float64)
    prog = np.asarray(program_alive, np.float64)
    return float(np.max(np.abs(prog - ref) / np.maximum(ref, 1.0)))


def walk_counts(scene, tracer: Tracer, out: dict) -> list:
    """[rays alive before, (ray, triangle) pairs, triangles entered] at each
    bounce of the window's last iteration over the whole frame, the one
    ``alive_gap`` traces (``Tracer.walk_counts``)."""
    cameras, counts = replay(scene, out["moves"], [out["steps"] - 1], out["spp"])
    return tracer.walk_counts(cameras[0], counts[0])


def lobe_counts(scene, tracer: Tracer, out: dict) -> dict:
    """The paths each lobe scatters at each bounce of the window's last
    iteration over the whole frame, the one ``alive_gap`` traces
    (``Tracer.lobe_counts``)."""
    cameras, counts = replay(scene, out["moves"], [out["steps"] - 1], out["spp"])
    return tracer.lobe_counts(cameras[0], counts[0])


def checked_steps(out: dict, rng: np.random.Generator, traffic: dict) -> list:
    """The steps whose image the check compares: of those that brought an
    image to the host, ``check_drag_frames`` drag steps and
    ``check_still_frames`` still steps drawn from ``rng``, the last step of
    the last whole still stretch (the longest accumulation of a displayed
    window), and the last step."""
    moves, pool = out["moves"], sorted(out["outputs"])
    drags = [i for i in pool if moves[i] is not None]
    stills = [i for i in pool if moves[i] is None]
    take = lambda pool, k: list(rng.choice(pool, size=min(k, len(pool)), replace=False)) \
        if pool and k else []
    chosen = set(take(drags, traffic["check_drag_frames"]))
    chosen |= set(take(stills, traffic["check_still_frames"]))
    ends = [i for i in stills if i + 1 < len(moves) and moves[i + 1] is not None]
    if ends:
        chosen.add(ends[-1])
    chosen.add(pool[-1])
    return sorted(int(i) for i in chosen)


def preview_sources(scene, out_h: int, out_w: int, pixels: np.ndarray) -> np.ndarray:
    """Film pixel ids of the preview's flat ids (its nearest-neighbour grid;
    at the film's own size, the same ids)."""
    h, w = scene.height, scene.width
    ys = np.clip((np.arange(out_h) + 0.5) * h / out_h, 0, h - 1).astype(int)
    xs = np.clip((np.arange(out_w) + 0.5) * w / out_w, 0, w - 1).astype(int)
    return ys[pixels // out_w] * w + xs[pixels % out_w]


def replay(scene, moves: list, steps: list, spp: int) -> tuple:
    """(the camera at each of ``steps``, the iterations accumulated since
    the last reset at each), from the inputs up to it."""
    rig = scene.orbit()
    cameras, counts, done, first = [], [], 0, 0  # first: the first step since the reset
    for s in steps:
        for i in range(done, s + 1):
            if moves[i] is not None:
                rig.move(*moves[i])
                first = i
        done = s + 1
        cameras.append(scene.render_camera(rig))
        counts.append((s - first + 1) * spp)
    return cameras, counts


def reference_images(scene, tracer: Tracer, out: dict, steps: list) -> np.ndarray:
    """``[len(steps), P, 3]``: the reference's images at ``steps``, as the
    host gets them: the preview (the film over its iterations) where each
    step is displayed, else the film itself."""
    src = preview_sources(scene, scene.height, scene.width, out["pixels"])
    cameras, counts = replay(scene, out["moves"], steps, out["spp"])
    jobs = [(c, src, k) for c, k in enumerate(counts)]
    sums = reference_sums(tracer, cameras, jobs)
    if out["display"] == "each":
        sums = [s / np.float32(k) for s, k in zip(sums, counts)]
    return np.stack(sums)


def judge(scene, tracer: Tracer, out: dict, traffic: dict, rng, want) -> dict:
    """Numbers of a window's output ``out`` (``loops.window``): the images
    of ``checked_steps`` against the reference's, and, where ``want`` names
    ``alive_gap``, the paths alive after each bounce of the last iteration
    over the whole frame."""
    steps = checked_steps(out, rng, traffic)
    ref = reference_images(scene, tracer, out, steps)
    prefix = "image_" if out["display"] == "each" else "film_"
    numbers = gaps(np.stack([out["outputs"][s] for s in steps]), ref, prefix)
    if "alive_gap" in want:
        cameras, counts = replay(scene, out["moves"], [out["steps"] - 1], out["spp"])
        numbers["alive_gap"] = alive_gap(tracer, cameras[0], counts[0], out["alive"])
    return numbers


def decide(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]) for each number the limits name."""
    rows = [(name, numbers.get(name, float("inf")), float(entry["limit"]))
            for name, entry in limits.items()]
    return all(np.isfinite(v) and v <= lim for _, v, lim in rows), rows


def load_scene(config: dict, res: tuple = None):
    return ref_scene.load(config["scene"], config["dir"], res)
