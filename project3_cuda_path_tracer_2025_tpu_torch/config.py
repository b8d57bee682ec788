"""Render configuration.

One frozen dataclass, field for field the JAX package's ``RenderConfig``
(``project3_cuda_path_tracer_2025_tpu/config.py``), so a configuration
moves between the two packages unchanged.  The port runs both integrators
on scenes of analytic primitives, textures and meshes of any number of tiles
of 1,024 triangles, on one device, several, or in chunks of pixels; a field
that selects a path not ported yet raises ``NotImplementedError`` here, at
construction, naming the ``ROADMAP.md`` item that will port it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, {item})")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # Feature toggles (A/B parity with src/pathtrace.cu:21-24).  They steer
    # the wavefront integrator and mesh traversal only.  stream_compaction:
    # True, False or "adaptive" (pack only once fewer than half the paths
    # are alive); images are identical across all three.
    stream_compaction: "bool | str" = "adaptive"
    material_sorting: bool = False
    bvh_acceleration: bool = True

    # "megakernel" (the default; fused kernels) or "wavefront" (the
    # reference's architecture: compaction and material sort per bounce).
    integrator: str = "megakernel"

    # "full" (kernShadeMaterialProper + scatterRay) or "fake" (the
    # reference's shadeFakeMaterial demo, src/pathtrace.cu:459-502).
    shader: str = "full"

    # Samples per Renderer.render batch; the port steps them from a host loop.
    spp_per_launch: int = 1

    # Numerical constants -- load-bearing for image parity
    # (src/utilities.h:19-20, src/intersections.h:29-32).
    baby_epsilon: float = 1e-5
    larger_epsilon: float = 1e-3
    ray_advance_epsilon: float = 1e-4

    # BVH build/traversal (meshes only).
    bvh_leaf_size: int = 4
    traversal_max_steps: Optional[int] = None
    # The native C++ BVH build is not ported (Queue 1: native/).
    native_bvh: bool = False

    # Fused bounce kernels for prim-only, untextured scenes: "auto" (on a
    # CUDA device), "on" (everywhere; on the CPU the kernel wrappers run
    # their plain PyTorch versions), "off" (the unfused torch path).
    fused_bounce: str = "auto"

    # Mesh intersector: "auto" (the MXU tables' traversals on a CUDA
    # device, the threaded BVH walk on the CPU), "mxu", "threaded", "brute".
    mesh_intersector: str = "auto"

    # Mesh-path ray sorting ("auto": on for a CUDA device, off on the CPU)
    # and traversal knobs; images are bit-identical across them.  The
    # traversals: "auto" (mono, planned, streamed or binned by mesh size),
    # or one of those by name, or "sweep" (every tile in order, no plan).
    ray_sorting: str = "auto"
    ray_sort_bits: int = 2
    ray_sort_dir_bits: int = 4
    ray_sort_mode: str = "auto"
    ray_sort_every: int = 1
    ray_sort_first_bounce: bool = True
    mxu_attr_resolve: str = "gather"
    mxu_traversal: str = "auto"
    mxu_plan: str = "auto"
    mesh_state_order: str = "auto"
    mxu_binned_tiers: tuple = (8, 4, 2)
    # Static-shape prefix tiers of the fused mesh bounce: "auto" resolves to
    # none in the port; whether they pay on the card is open (ROADMAP.md).
    bounce_prefix_tiers: "tuple | str" = "auto"

    # Split each iteration into C sequential dispatches over pixel blocks
    # (C must divide the pixel count; the same film bit for bit).  In the
    # JAX package 0 (auto) works around a fault of its remote TPU backend;
    # here 0 and 1 run unchunked (``resolved_pixel_chunks``).
    pixel_chunks: int = 0

    # Multi-device rendering (``parallel``): "pixel" splits the frame's
    # pixels over the devices, "sample" has each device render other spp
    # of the full frame.  Chunks never compose with devices.
    devices: int = 1
    parallel_mode: str = "pixel"

    # Loop lowering in the JAX package.  PyTorch runs eagerly, so the bounce
    # loop is always a Python loop and this field is ignored.
    unroll_bounces: Optional[bool] = None
    unroll_leaf: bool = True

    # Camera parity quirk: the reference re-derives the render camera from
    # spherical coordinates on the first frame (src/main.cpp:423-444).
    spherical_camera_reconstruction: bool = True

    # Output parity: saveImage writes the PNG horizontally mirrored
    # (src/main.cpp:407).
    mirror_output: bool = True

    # Debugging: check the film for non-finite values after every step.
    debug_nan_checks: bool = False

    def __post_init__(self):
        for f in ("mxu_binned_tiers", "bounce_prefix_tiers"):
            v = getattr(self, f)
            if v == "auto" and f == "bounce_prefix_tiers":
                continue
            if not isinstance(v, tuple):
                object.__setattr__(self, f, tuple(v))
        if self.mesh_state_order not in ("auto", "sorted", "pixel"):
            raise ValueError(
                f"mesh_state_order={self.mesh_state_order!r}: use "
                "'auto'/'sorted'/'pixel'"
            )
        sc = self.stream_compaction
        if isinstance(sc, str) and sc != "adaptive":
            if sc in ("on", "true", "1"):
                object.__setattr__(self, "stream_compaction", True)
            elif sc in ("off", "false", "0"):
                object.__setattr__(self, "stream_compaction", False)
            else:
                raise ValueError(
                    f"stream_compaction={sc!r}: use True/False/'adaptive'"
                )
        if self.shader not in ("full", "fake"):
            raise ValueError(f"shader={self.shader!r}: use 'full'/'fake'")
        if self.fused_bounce not in ("auto", "on", "off"):
            raise ValueError(
                f"fused_bounce={self.fused_bounce!r}: use 'auto'/'on'/'off'"
            )
        if self.integrator not in ("megakernel", "wavefront"):
            raise ValueError(
                f"integrator={self.integrator!r}: use 'megakernel'/'wavefront'"
            )
        if self.devices < 1:
            raise ValueError(f"devices={self.devices}: at least 1")
        if self.parallel_mode not in ("pixel", "sample"):
            raise ValueError(f"parallel_mode={self.parallel_mode!r}: use 'pixel'/'sample'")
        if self.pixel_chunks < 0:
            raise ValueError(f"pixel_chunks={self.pixel_chunks}: 0 (auto) or a count >= 1")
        if self.mesh_intersector not in ("auto", "mxu", "threaded", "brute"):
            raise ValueError(
                f"mesh_intersector={self.mesh_intersector!r}: use "
                "'auto'/'mxu'/'threaded'/'brute'"
            )
        if self.ray_sorting not in ("auto", "on", "off"):
            raise ValueError(f"ray_sorting={self.ray_sorting!r}: use 'auto'/'on'/'off'")
        if self.ray_sort_mode not in ("auto", "morton", "signature"):
            raise ValueError(
                f"ray_sort_mode={self.ray_sort_mode!r}: use 'auto'/'morton'/'signature'"
            )
        if self.mxu_traversal not in ("auto", "sweep", "mono", "planned", "streamed",
                                      "binned"):
            raise ValueError(f"mxu_traversal={self.mxu_traversal!r}")
        if self.mxu_plan not in ("auto", "exact", "frustum"):
            raise ValueError(f"mxu_plan={self.mxu_plan!r}: use 'auto'/'exact'/'frustum'")
        if self.mxu_plan == "frustum":
            raise NotImplementedError(
                "mxu_plan='frustum' is on the do-not-port list (ROADMAP.md, Queue 1: "
                "a TPU A/B option that measured as a loss there)"
            )
        if any(int(t) < 1 for t in self.mxu_binned_tiers):
            raise ValueError(f"mxu_binned_tiers={self.mxu_binned_tiers!r}: divisors >= 1")
        if self.mxu_attr_resolve not in ("gather", "onehot"):
            raise ValueError(f"mxu_attr_resolve={self.mxu_attr_resolve!r}")
        if self.mesh_state_order == "pixel":
            raise NotImplementedError(
                "mesh_state_order='pixel' is on the do-not-port list (ROADMAP.md, "
                "Queue 1: a TPU A/B toggle that measured as a loss there)"
            )
        if self.bounce_prefix_tiers not in ("auto", ()):
            raise _not_ported(
                f"bounce_prefix_tiers={self.bounce_prefix_tiers!r}",
                "Queue 1: prefix tiers and sorting on the card",
            )
        if self.native_bvh:
            raise _not_ported("native_bvh=True", "Queue 1: native/")

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    def resolved_prefix_tiers(self) -> tuple:
        """``bounce_prefix_tiers`` resolved: none in the port (the JAX
        package resolves "auto" to (4, 2) on a TPU and () on the CPU)."""
        return ()

    def resolved_pixel_chunks(self, pixel_count: int) -> int:
        """``pixel_chunks`` with 0 (auto) resolved to 1: the JAX package's
        auto rule works around a fault of its remote TPU backend and is on
        the do-not-port list (ROADMAP.md).  Any other value is returned as
        it is; ``Renderer`` checks that it divides ``pixel_count``."""
        del pixel_count  # the JAX package's rule reads it
        return self.pixel_chunks or 1
