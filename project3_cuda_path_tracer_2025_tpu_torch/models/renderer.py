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

``cfg.devices > 1`` steps through ``parallel.shardmap``'s sharded step
(pixel or sample mode; the film is a list of per-shard films), and
``cfg.pixel_chunks > 1`` through the chunked step: C sequential
``shard=`` calls on one device, each writing into its slice of the film.
Both run ``megakernel_iteration`` (or the wavefront), never the iteration
kernel, as the JAX package's do.  Checkpoints are always the flat film.

Camera orbit parity: ``orbit_camera()`` applies the reference's mouse
controls and, like ``runCuda`` (``src/main.cpp:423-453``), resets
accumulation.
"""

from __future__ import annotations

import contextlib
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
from ..utils.timers import FrameStats, PerformanceTimer, host_read, span
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
        shard_devices=None,
    ) -> None:
        """``shard_devices`` names the devices of ``cfg.devices`` shards (the
        JAX Renderer's ``devices``; a list may name one device more than
        once): by default ``"cpu"`` nd times on the CPU, else ``cuda:0`` ..
        ``cuda:{nd-1}``, which must exist."""
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
        self._spp_stride = 1  # spp advanced per dispatch (sample mode: nd)
        self._devices = self._sharded_step = None
        if cfg.devices > 1:
            from .. import parallel

            if shard_devices is None and self.device.type == "cpu":
                shard_devices = [self.device] * cfg.devices
            self._devices = parallel.make_device_list(cfg.devices, shard_devices)
            here = self.device
            if here.type == "cuda" and here.index is None:
                here = torch.device("cuda", torch.cuda.current_device())
            self._sharded_step, self._spp_stride = parallel.make_sharded_step(
                parallel.replicate_scene(scene, self._devices, {here: self.dev}),
                self.static, cfg, self._devices, cfg.parallel_mode,
            )
        # Chunking never composes with devices, as in the JAX package.
        self._pixel_chunks = (
            1 if self._devices else cfg.resolved_pixel_chunks(self.static.pixel_count)
        )
        if self.static.pixel_count % self._pixel_chunks:
            raise ValueError(
                f"pixel_chunks={self._pixel_chunks} must divide the pixel count "
                f"{self.static.pixel_count}"
            )
        self.film = self._new_film()  # Vec3; a list of them when sharded
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

    def _new_film(self):
        if self._devices:
            from ..parallel import sharded_film

            return sharded_film(self.static, self._devices, self.cfg.parallel_mode)
        return film_ops.new_film(self.static.pixel_count, device=self.device)

    def _flat_film(self) -> Vec3:
        """The film as the one-device ``[N]`` film (sharded films joined or
        summed on ``self.device``)."""
        if self._devices:
            from ..parallel import film_to_flat

            return film_to_flat(self.film, self.cfg.parallel_mode, self.device)
        return self.film

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
        with span("renderer.orbit_camera"):
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
        """Trace one step (``_spp_stride`` spp); the film is updated in place
        (the JAX package donates it to its jitted step for the same
        effect)."""
        self.iteration += self._spp_stride
        if self._sharded_step is not None:
            return self._sharded_step(self._cam_state, self.film, self.iteration,
                                      self._base_key)
        if self._pixel_chunks > 1:
            return self._chunked_step()
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

    def _chunked_step(self):
        """C sequential ``shard=`` calls over the frame's pixel blocks, each
        writing into its slice of the film: the unchunked film bit for
        bit."""
        n = self.static.pixel_count
        size = n // self._pixel_chunks
        iteration = (
            wavefront_iteration if self.cfg.integrator == "wavefront" else megakernel_iteration
        )
        alive = None
        for c in range(self._pixel_chunks):
            sl = slice(c * size, (c + 1) * size)
            _, a = iteration(
                self.dev, self.static, self.cfg, self._cam_state,
                Vec3(self.film.x[sl], self.film.y[sl], self.film.z[sl]),
                self.iteration, self._base_key, shard=(range(sl.start, sl.stop), n),
            )
            alive = a if alive is None else alive + a
        return self.film, alive

    def step(self, sync: bool = True) -> None:
        """Trace one spp iteration (reference: one ``pathtrace()`` frame);
        sample mode advances ``cfg.devices`` spp a call."""
        self.step_many(1, sync=sync)

    def step_many(self, k: int, sync: bool = True) -> None:
        """Trace k spp, launched back to back from the host: ``ceil(k /
        stride)`` dispatches of ``stride`` spp each (sample mode cannot
        trace less than a stride; ``iteration`` says what ran).

        With ``sync`` the batch is timed on the device (CUDA events, which
        wait for it to finish) and ``stats`` gets its ms/frame once per spp;
        without, nothing waits and ``stats`` gets nothing (the host's
        enqueue time is the ``renderer.step_many`` span's, under a
        profiler)."""
        n_disp = max(1, -(-int(k) // self._spp_stride))
        spp = n_disp * self._spp_stride
        with self._on_device(), span("renderer.step_many"):
            if sync:
                timer = PerformanceTimer(self.device)
                timer.start()
            for _ in range(n_disp):
                self.film, alive = self._dispatch()
            if sync:
                dt_ms = timer.stop() / spp
                for _ in range(spp):
                    self.stats.add(dt_ms)
        self._alive_counts = alive
        if self.cfg.debug_nan_checks:
            self._check_finite()

    def _on_device(self):
        """The kernels launch on the CUDA runtime's current device: make it
        this Renderer's (the sharded step sets each shard's its own)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _check_finite(self) -> None:
        """Debug-config runtime checking (the reference's analogue is the
        ERRORCHECK sync-after-every-launch, src/pathtrace.cu:26-49)."""
        film = self._flat_film()
        for name, arr in (("film.r", film.x), ("film.g", film.y),
                          ("film.b", film.z)):
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
        with span("renderer.image"):
            return film_ops.to_host_image(self._flat_film(), self.static.width,
                                          self.static.height)

    def preview_image(self, out_h: int, out_w: int) -> np.ndarray:
        """[out_h, out_w, 3] normalized preview, downsampled on the device
        with the nearest-neighbor grid of the JAX package's preview."""
        h, w = self.static.height, self.static.width
        with span("renderer.preview"):
            ys = np.clip((np.arange(out_h) + 0.5) * h / out_h, 0, h - 1).astype(int)
            xs = np.clip((np.arange(out_w) + 0.5) * w / out_w, 0, w - 1).astype(int)
            # A copy from pageable host memory waits for the device.
            with host_read("preview_grid"):
                ys_t = torch.as_tensor(ys, device=self.device)
            with host_read("preview_grid"):
                xs_t = torch.as_tensor(xs, device=self.device)
            img = torch.stack(
                [a.reshape(h, w)[ys_t][:, xs_t] for a in self._flat_film()], dim=-1
            )
            img = img / float(max(1, self.iteration))
            with host_read("preview"):
                return img.cpu().numpy()

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
        """The JAX package's format: film_x/y/z, iteration, key (uint32 [2]).
        Always the flat ``[N]`` film (sample mode's films summed), so a
        checkpoint moves between the packages and between layouts."""
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        film = self._flat_film()
        np.savez_compressed(
            path,
            film_x=film.x.cpu().numpy(),
            film_y=film.y.cpu().numpy(),
            film_z=film.z.cpu().numpy(),
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
        self.film = self._layout(Vec3(*film))
        self.iteration = int(d["iteration"])
        key = np.asarray(d["key"]).astype(np.uint32).reshape(-1)
        self._base_key = (int(key[0]), int(key[1]))

    def _layout(self, flat: Vec3):
        """A flat film in this Renderer's layout.  Sample mode puts it in
        the first shard's film and zeroes the others: the summed film is
        the same, and each shard goes on with its own iterations."""
        if not self._devices:
            return flat
        films = self._new_film()
        if self.cfg.parallel_mode == "sample":
            for f, a in zip(films[0], flat):
                f.copy_(a)
            return films
        from ..parallel.shardmap import pixel_blocks

        blocks = pixel_blocks(self.static.pixel_count, len(self._devices))
        for film, b in zip(films, blocks):
            for f, a in zip(film, flat):
                f.copy_(a[b.start:b.stop])
        return films
