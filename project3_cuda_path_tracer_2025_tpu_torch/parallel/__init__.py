"""Rendering one frame over several devices (``RenderConfig(devices=N)``).

The port of the JAX package's ``parallel/``: ``shardmap`` holds the two
modes (pixel and sample) and the sharded film, ``mesh`` the device list,
the replicated scene and ``dryrun``.
"""

from .mesh import dryrun, make_device_list, replicate_scene
from .shardmap import film_to_flat, make_sharded_step, sharded_film

__all__ = [
    "dryrun", "film_to_flat", "make_device_list", "make_sharded_step", "replicate_scene",
    "sharded_film",
]
