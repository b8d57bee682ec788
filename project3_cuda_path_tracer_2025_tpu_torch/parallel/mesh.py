"""The device list, the replicated scene and ``dryrun``.

The port of the JAX package's ``parallel/mesh.py``.  A list of
``torch.device`` takes the place of the 1-D ``jax.sharding.Mesh``.  The
JAX module's ``sharded_iteration`` (and ``shard_film``), a step left to
XLA's automatic partitioner, has no torch counterpart and is not ported:
``dryrun`` runs the explicit sharded step of ``parallel.shardmap``.
"""

from __future__ import annotations

import pathlib
from typing import Optional, Tuple

import torch

from ..config import RenderConfig
from ..scene.device import build_device_scene
from ..scene.types import HostScene

DEFAULT_SCENE = pathlib.Path(__file__).resolve().parents[2] / "scenes" / "cornell_dof.json"


def make_device_list(n_devices: Optional[int] = None, devices=None) -> list:
    """The shards' devices: ``devices`` as given (it may name one device
    more than once, e.g. ``["cuda:0"] * 4``, or ``["cpu"] * 8``), or
    ``cuda:0`` .. ``cuda:{n-1}``.  Asking for more CUDA devices than the
    machine has raises; the list is never cut short without saying so."""
    if devices is not None:
        out = [torch.device(d) for d in devices]
        if not out or (n_devices is not None and len(out) != n_devices):
            raise ValueError(f"{len(out)} devices named for {n_devices} shards")
        return out
    have = torch.cuda.device_count()
    n = have if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices={n_devices}: at least one device")
    if have < n:
        raise RuntimeError(
            f"{n} CUDA devices asked for, {have} present; name the shards' devices to "
            f"run several on one (devices=['cuda:0'] * {n})"
        )
    return [torch.device("cuda", i) for i in range(n)]


def replicate_scene(scene: HostScene, devices: list, built: Optional[dict] = None) -> dict:
    """``build_device_scene(scene, d)`` once a distinct device of
    ``devices``: device -> DeviceScene.  ``built`` holds device scenes
    already made (device -> DeviceScene), reused as they are."""
    out = dict(built or {})
    for d in devices:
        d = torch.device(d)
        if d not in out:
            out[d] = build_device_scene(scene, d)[0]
    return out


def dryrun(n_devices: int, scene_path: Optional[str] = None, width: int = 64,
           height: int = 64, integrator: str = "megakernel", devices=None,
           **cfg_overrides) -> Tuple:
    """One pixel-mode step of the sharded iteration at a small size:
    ``(flat film, alive counts, devices)``.  ``devices`` names the shards'
    devices (default ``cuda:0`` ..); ``cfg_overrides`` go to
    ``RenderConfig``."""
    from ..scene import camera_state, derive_render_camera, load_scene, set_resolution
    from ..utils import prng
    from .shardmap import film_to_flat, make_sharded_step, sharded_film

    scene = set_resolution(load_scene(str(scene_path or DEFAULT_SCENE)), width, height)
    devs = make_device_list(n_devices, devices)
    cfg = RenderConfig(integrator=integrator, **cfg_overrides)
    dev0, static = build_device_scene(scene, devs[0])
    dev_by_device = replicate_scene(scene, devs, {devs[0]: dev0})
    step, _ = make_sharded_step(dev_by_device, static, cfg, devs, "pixel")
    cam = camera_state(derive_render_camera(scene.state.camera))
    film, alive = step(cam, sharded_film(static, devs, "pixel"), 1, prng.prng_key(0))
    return film_to_flat(film, "pixel", devs[0]), alive, devs
