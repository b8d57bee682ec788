"""High-level renderer: the counterpart of the reference's app shell.

Replaces ``main.cpp``'s GLFW/CUDA-GL loop with a headless device-resident
loop: scene -> device scene -> per-iteration kernel -> film -> PNG/HDR, plus
checkpoint/resume of (film, iteration, rng key) in the JAX package's format,
so a checkpoint moves between the two packages in either direction.

On a CUDA device (the default) with the default config, every step of a
prim-only scene is one launch of the iteration kernel
(``ops.fused.fused_prim_iteration``).  The camera is an argument of that
kernel, so an orbit rebuilds nothing (the JAX package bakes it into its
kernel and recompiles).  A mesh or textured scene steps through
``megakernel_iteration``, whose every bounce launches a traversal kernel
(meshes) and the mesh-shade kernel.  ``integrator="wavefront"`` steps
through ``wavefront_iteration`` instead, on any scene.

Camera orbit parity: ``orbit_camera()`` applies the reference's mouse
controls and, like ``runCuda`` (``src/main.cpp:423-453``), resets
accumulation.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..config import RenderConfig
from ..ops import film as film_ops
from ..ops import fused
from ..scene import load_scene
from ..scene.camera import OrbitState, camera_state, derive_render_camera
from ..scene.device import build_device_scene
from ..scene.types import HostScene
from ..utils import image_io, prng
from ..utils.timers import FrameStats, PerformanceTimer
from ..utils.vec import Vec3
from .megakernel import megakernel_iteration
from .wavefront import wavefront_iteration


@dataclass
class RenderResult:
    image: np.ndarray  # [H, W, 3] accumulated (undivided)
    iterations: int
    stats: FrameStats
    alive_counts: np.ndarray  # [depth] from the last iteration
    path: Optional[str] = None


class Renderer:
    def __init__(
        self,
        scene: HostScene | str,
        cfg: RenderConfig = RenderConfig(),
        seed: int = 0,
        device="cuda",
    ) -> None:
        if isinstance(scene, str):
            scene = load_scene(
                scene, leaf_size=cfg.bvh_leaf_size, native_bvh=cfg.native_bvh
            )
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Renderer(device='cuda') needs a CUDA device; pass "
                "device='cpu' to render on the CPU"
            )
        self.scene = scene
        self.cfg = cfg
        self.dev, self.static = build_device_scene(scene, self.device)
        self.orbit = OrbitState.from_camera(scene.state.camera)
        self._base_key = prng.prng_key(seed)
        self.iteration = 0
        self.film: Vec3 = self._new_film()
        self.stats = FrameStats()
        self._alive_counts = np.zeros(self.static.trace_depth, np.int64)
        self._refresh_camera()
        # The whole-iteration kernel: on a CUDA device unless disabled; on
        # the CPU only when forced, where it runs its plain version (the
        # JAX package runs its kernel in interpret mode there).
        self._use_fused_iter = (
            cfg.integrator == "megakernel" and fused.fused_applicable(self.static, cfg)
        ) and (
            cfg.fused_bounce == "on"
            or (cfg.fused_bounce == "auto" and self.device.type == "cuda")
        )

    @property
    def _alive_counts(self) -> np.ndarray:
        """Per-depth alive-ray counts of the last iteration, fetched to the
        host on first read (so a step does not wait for them)."""
        raw = self._alive_raw
        if not isinstance(raw, np.ndarray):
            raw = raw.cpu().numpy()
            self._alive_raw = raw
        return raw

    @_alive_counts.setter
    def _alive_counts(self, value) -> None:
        self._alive_raw = value

    def _new_film(self) -> Vec3:
        return film_ops.new_film(self.static.pixel_count, device=self.device)

    # -- camera --------------------------------------------------------------
    def _refresh_camera(self) -> None:
        if self.cfg.spherical_camera_reconstruction:
            cam = derive_render_camera(self.scene.state.camera, self.orbit)
        else:
            cam = self.scene.state.camera
        self.render_camera = cam
        self._cam_state = camera_state(cam)

    def orbit_camera(self, dphi=0.0, dtheta=0.0, dzoom=0.0, look_at=None) -> None:
        """Orbit controls; resets accumulation like the reference
        (``src/main.cpp:423-425``)."""
        self.orbit.orbit(dphi=dphi, dtheta=dtheta, dzoom=dzoom)
        if look_at is not None:
            self.orbit.look_at = np.asarray(look_at, np.float64)
        self._refresh_camera()
        self.reset()

    def reset(self) -> None:
        self.iteration = 0
        self.film = self._new_film()
        self.stats = FrameStats()

    # -- rendering -------------------------------------------------------------
    def _dispatch(self):
        """Trace one spp iteration; the film is updated in place (the JAX
        package donates it to its jitted step for the same effect)."""
        self.iteration += 1
        if self._use_fused_iter:
            return fused.fused_prim_iteration(
                self.static, self.cfg, self._cam_state, self.film,
                self.iteration, self._base_key,
            )
        iteration = (
            wavefront_iteration if self.cfg.integrator == "wavefront" else megakernel_iteration
        )
        return iteration(
            self.dev, self.static, self.cfg, self._cam_state, self.film,
            self.iteration, self._base_key,
        )

    def step(self, sync: bool = True) -> None:
        """Trace one spp iteration (reference: one ``pathtrace()`` frame)."""
        self.step_many(1, sync=sync)

    def step_many(self, k: int, sync: bool = True) -> None:
        """Trace k spp, launched back to back from the host.

        With ``sync`` the batch is timed on the device (CUDA events, which
        wait for it to finish); without, the per-frame time recorded is the
        host's enqueue time."""
        k = max(1, int(k))
        timer = PerformanceTimer(self.device if sync else "cpu")
        timer.start()
        for _ in range(k):
            self.film, alive = self._dispatch()
        dt_ms = timer.stop() / k
        for _ in range(k):
            self.stats.add(dt_ms)
        self._alive_counts = alive
        if self.cfg.debug_nan_checks:
            self._check_finite()

    def _check_finite(self) -> None:
        """Debug-config runtime checking (the reference's analogue is the
        ERRORCHECK sync-after-every-launch, src/pathtrace.cu:26-49)."""
        for name, arr in (("film.r", self.film.x), ("film.g", self.film.y),
                          ("film.b", self.film.z)):
            bad = int(torch.sum(~torch.isfinite(arr)))
            if bad:
                raise FloatingPointError(
                    f"non-finite values in {name} after iteration "
                    f"{self.iteration}: {bad} lanes"
                )

    def render(
        self,
        spp: Optional[int] = None,
        out_dir: Optional[str] = None,
        hdr: bool = False,
        log_every: int = 0,
    ) -> RenderResult:
        total = spp if spp is not None else self.static.iterations
        batch = max(1, self.cfg.spp_per_launch)
        while self.iteration < total:
            self.step_many(min(batch, total - self.iteration))
            if log_every and (self.iteration % log_every == 0 or self.iteration == total):
                rays = float(self._alive_counts.sum() + self.static.pixel_count)
                print(
                    f"iter {self.iteration}/{total}  "
                    f"{self.stats.mean_ms:.2f} ms/frame  "
                    f"{self.stats.fps:.1f} FPS  "
                    f"{self.stats.mrays_per_s(rays):.1f} Mrays/s  "
                    f"depth-alive {self._alive_counts.tolist()}"
                )
        img = self.image()
        path = None
        if out_dir is not None:
            path = image_io.save_film(
                img,
                self.iteration,
                self.static.image_name,
                out_dir=out_dir,
                mirror=self.cfg.mirror_output,
                hdr=hdr,
            )
        return RenderResult(
            image=img,
            iterations=self.iteration,
            stats=self.stats,
            alive_counts=self._alive_counts,
            path=path,
        )

    def image(self) -> np.ndarray:
        """Accumulated film as [H, W, 3] (host copy happens here only)."""
        return film_ops.to_host_image(self.film, self.static.width, self.static.height)

    def preview_image(self, out_h: int, out_w: int) -> np.ndarray:
        """[out_h, out_w, 3] normalized preview, downsampled on the device
        with the nearest-neighbor grid of the JAX package's preview."""
        h, w = self.static.height, self.static.width
        ys = np.clip((np.arange(out_h) + 0.5) * h / out_h, 0, h - 1).astype(int)
        xs = np.clip((np.arange(out_w) + 0.5) * w / out_w, 0, w - 1).astype(int)
        ys_t = torch.as_tensor(ys, device=self.device)
        xs_t = torch.as_tensor(xs, device=self.device)
        img = torch.stack(
            [a.reshape(h, w)[ys_t][:, xs_t] for a in self.film], dim=-1
        )
        return (img / float(max(1, self.iteration))).cpu().numpy()

    def image_normalized(self) -> np.ndarray:
        return self.image() / max(1, self.iteration)

    def save(self, out_dir: str = "img", hdr: bool = False) -> str:
        return image_io.save_film(
            self.image(),
            max(1, self.iteration),
            self.static.image_name,
            out_dir=out_dir,
            mirror=self.cfg.mirror_output,
            hdr=hdr,
        )

    # -- checkpoint / resume ---------------------------------------------------
    def checkpoint(self, path: str) -> None:
        """The JAX package's format: film_x/y/z, iteration, key (uint32 [2])."""
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        np.savez_compressed(
            path,
            film_x=self.film.x.cpu().numpy(),
            film_y=self.film.y.cpu().numpy(),
            film_z=self.film.z.cpu().numpy(),
            iteration=self.iteration,
            key=np.asarray(self._base_key, np.uint32),
        )

    def restore(self, path: str) -> None:
        d = np.load(path)
        n = self.static.pixel_count
        film = []
        for name in ("film_x", "film_y", "film_z"):
            a = np.asarray(d[name], np.float32)
            if a.shape != (n,):
                raise ValueError(
                    f"{path}: {name} has shape {a.shape}, this scene has {n} pixels"
                )
            film.append(torch.as_tensor(a, device=self.device).clone())
        self.film = Vec3(*film)
        self.iteration = int(d["iteration"])
        key = np.asarray(d["key"]).astype(np.uint32).reshape(-1)
        self._base_key = (int(key[0]), int(key[1]))
