from .megakernel import megakernel_iteration
from .renderer import Renderer, RenderResult

__all__ = [
    "megakernel_iteration",
    "Renderer",
    "RenderResult",
]
