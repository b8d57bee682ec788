"""Multi-device rendering: one process drives a list of devices.

The port of the JAX package's ``parallel/shardmap.py``.  There the whole
iteration runs inside ``jax.shard_map``, one program a chip; here one
host thread (single-controller, like the JAX ``Renderer``) runs the same
iteration once a shard, each shard's launches under
``torch.cuda.device(d)`` and on a CUDA stream of its own, so the shards of
one step may overlap on the card.  The only data that crosses shards in a
step is the per-depth alive counts, summed onto the first device (the JAX
package's ``psum``); no film moves until it is read (``film_to_flat``).

Two modes, as in the JAX package:

* ``pixel``: shard d of nd renders pixels ``[d*N/nd, (d+1)*N/nd)`` every
  iteration (``megakernel_iteration(shard=...)``): every draw is the whole
  frame's stream at the shard's pixels, so the film equals the one-device
  film bit for bit.
* ``sample``: shard d renders global iteration ``it - nd + 1 + d`` of the
  full frame into a film of its own; the films are summed in shard order
  when read.  One step advances nd samples.

The sharded step runs ``megakernel_iteration`` (or the wavefront), never
the whole-iteration kernel, as the JAX package's does.  A device list may
name one device more than once: nd shards on one device give the same
film, and on one card show the host cost of the split.
"""

from __future__ import annotations

import contextlib

import torch

from ..config import RenderConfig
from ..models.megakernel import megakernel_iteration
from ..models.wavefront import wavefront_iteration
from ..ops import film as film_ops
from ..scene.device import SceneStatic
from ..utils.vec import Vec3

MODES = ("pixel", "sample")


def _iter_fn(cfg: RenderConfig):
    return wavefront_iteration if cfg.integrator == "wavefront" else megakernel_iteration


def pixel_blocks(n: int, nd: int) -> list:
    """The nd blocks of pixel mode, as ranges of pixel ids."""
    if n % nd:
        raise ValueError(
            f"pixel-parallel mode needs devices | pixels ({nd} vs {n}); "
            "use parallel_mode='sample' for odd resolutions"
        )
    size = n // nd
    return [range(d * size, (d + 1) * size) for d in range(nd)]


def sharded_film(static: SceneStatic, devices: list, mode: str) -> list:
    """A fresh film in the layout the sharded step expects: one Vec3 a
    shard, on its device; pixel mode a shard's block, sample mode the
    full frame."""
    if mode == "sample":
        return [film_ops.new_film(static.pixel_count, device=d) for d in devices]
    return [film_ops.new_film(len(b), device=d)
            for b, d in zip(pixel_blocks(static.pixel_count, len(devices)), devices)]


def film_to_flat(film: list, mode: str, device) -> Vec3:
    """The sharded film as the one-device ``[N]`` film on ``device``:
    pixel mode's blocks joined, sample mode's films summed in shard
    order."""
    if mode == "sample":
        out = [a.to(device, copy=True) for a in film[0]]
        for f in film[1:]:
            for acc, a in zip(out, f):
                acc.add_(a.to(device))
        return Vec3(*out)
    return Vec3(*(torch.cat([f[c].to(device) for f in film]) for c in range(3)))


def shard_streams(devices: list) -> list:
    """A CUDA stream of its own for each shard on a CUDA device (None on
    the CPU)."""
    return [torch.cuda.Stream(device=d) if d.type == "cuda" else None for d in devices]


def _fork(devices: list, streams: list) -> None:
    """Each shard's stream waits for the work already queued on its
    device's current stream (the film, the scene, a restore)."""
    for d, s in zip(devices, streams):
        if s is not None:
            s.wait_stream(torch.cuda.current_stream(d))


def _join(devices: list, streams: list) -> None:
    """The current streams of each shard's device and of the first device
    wait for the shard: what reads the film or the counts next, and the
    first device's timing events, come after it."""
    for d, s in zip(devices, streams):
        if s is not None:
            for target in dict.fromkeys((d, devices[0])):
                if target.type == "cuda":
                    torch.cuda.current_stream(target).wait_stream(s)


@contextlib.contextmanager
def on_shard(device: torch.device, stream):
    """The context of a shard's launches: its device current, its stream
    current on it.  Nothing on the CPU."""
    if stream is None:
        yield
        return
    with torch.cuda.device(device), torch.cuda.stream(stream):
        yield


def make_sharded_step(
    dev_by_device: dict,
    static: SceneStatic,
    cfg: RenderConfig,
    devices: list,
    mode: str = "pixel",
):
    """Build the multi-device ``step(cam, film, iteration, key)``; ``film``
    is ``sharded_film``'s list, updated in place.  Returns ``(step,
    spp_per_step)``: ``sample`` mode advances nd samples a step
    (``iteration`` is the last global sample the step completes),
    ``pixel`` mode one.  ``step`` returns ``(film, alive_counts[depth])``,
    the counts summed over the shards on the first device."""
    if mode not in MODES:
        raise ValueError(f"unknown parallel_mode {mode!r}")
    devices = [torch.device(d) for d in devices]
    nd, n = len(devices), static.pixel_count
    iter_fn = _iter_fn(cfg)
    blocks = pixel_blocks(n, nd) if mode == "pixel" else None
    streams = shard_streams(devices)

    def step(cam, film, iteration, key):
        _fork(devices, streams)
        alive = []
        for d, device in enumerate(devices):
            with on_shard(device, streams[d]):
                if blocks is not None:
                    film[d], a = iter_fn(dev_by_device[device], static, cfg, cam, film[d],
                                         iteration, key, shard=(blocks[d], n))
                else:
                    film[d], a = iter_fn(dev_by_device[device], static, cfg, cam, film[d],
                                         iteration - nd + 1 + d, key)
            alive.append(a)
        _join(devices, streams)
        total = alive[0]
        for a in alive[1:]:
            total = total + a.to(total.device)
        return film, total

    return step, (nd if mode == "sample" else 1)
