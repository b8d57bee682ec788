from . import vec, mathutil, prng, image_io, timers

__all__ = ["vec", "mathutil", "prng", "image_io", "timers"]
