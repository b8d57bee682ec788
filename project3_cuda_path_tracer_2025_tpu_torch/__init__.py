"""PyTorch/CUDA port of the TPU path tracer, for one NVIDIA H100.

The JAX package ``project3_cuda_path_tracer_2025_tpu`` beside it is the
reference.  This package keeps its layout and module names, runs on torch
tensors with an explicit ``device``, and replaces each Pallas kernel on its
path with a hand-written CUDA kernel for ``sm_90a`` (``csrc/``), built with
``nvcc`` at first use.  It never imports JAX.

Ported so far: the megakernel render of untextured scenes of analytic
primitives and of triangle meshes up to 8,192 padded triangles (scene
loading, the RNG, camera rays, box/sphere intersection, the mesh tables and
intersectors, every BSDF lobe, the film, ``Renderer``, the CLI).  Larger
meshes, textures, the wavefront integrator and multi-device rendering raise
``NotImplementedError`` naming their ``ROADMAP.md`` item.

Conventional import alias::

    import project3_cuda_path_tracer_2025_tpu_torch as ptc
"""

from .config import RenderConfig
from .version import __version__

__all__ = ["RenderConfig", "__version__"]
