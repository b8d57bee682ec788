from .megakernel import megakernel_iteration
from .renderer import Renderer, RenderResult
from .wavefront import wavefront_iteration

__all__ = [
    "megakernel_iteration",
    "Renderer",
    "RenderResult",
    "wavefront_iteration",
]
