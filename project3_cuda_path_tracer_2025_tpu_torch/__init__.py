"""PyTorch/CUDA port of the TPU path tracer, for one NVIDIA H100.

The JAX package ``project3_cuda_path_tracer_2025_tpu`` beside it is the
reference.  This package keeps its layout and module names, runs on torch
tensors with an explicit ``device``, and replaces each Pallas kernel on its
path with a hand-written CUDA kernel for ``sm_90a`` (``csrc/``), built with
``nvcc`` at first use.  It never imports JAX.

It does everything the JAX package does: the megakernel and wavefront
renders of scenes of analytic primitives and of triangle meshes of any size
in tiles of 1,024 triangles, textured or not (scene loading with the native
C++ BVH builder (``native/``) or NumPy's, the RNG, camera rays, box/sphere
intersection, the mesh tables and traversals, textures and bump maps, every
BSDF lobe, stream compaction and material sort, bounce prefix tiers, the
film, ``Renderer``, multi-device and chunked rendering (``parallel``), the
CLI with every flag of the JAX CLI, and the interactive shell).  Only the
TPU workarounds on ``ROADMAP.md``'s do-not-port list raise
``NotImplementedError``.

Conventional import alias::

    import project3_cuda_path_tracer_2025_tpu_torch as ptc
"""

from .config import RenderConfig
from .version import __version__

__all__ = ["RenderConfig", "__version__"]
