"""Kernels: the mesh walks' share of their roofline, in %: the least time
the card could take for one spp iteration's walks (``work.walk_work``: the
rays alive before each bounce read and their hits written, each triangle
whose own box some ray's segment up to its nearest hit enters read once,
and each such pair tested, counted by the reference over the whole frame
against the published peaks of ``work.py``) over the device time of the
walk kernels per spp frame traced.  Any exact walk whose nodes are
axis-aligned boxes tests every such pair, so the bound holds for each of
them.  Nothing to read where the count was not made or no walk kernel ran.
A ``walk_roofline_pct.<variant>`` of a later mesh cell is read here too."""

from tracing import device_ms, kernel_name
from work import bound_ms

# The walks of csrc/mesh_walk.cu.
WALK_KERNELS = ("ptt_mono_kernel", "ptt_planned_kernel", "ptt_planned_lanebest_kernel",
                "ptt_streamed_kernel", "ptt_streamed_super_kernel", "ptt_sweep_kernel",
                "ptt_binned_kernel")


def read(rec):
    if "walk_work" not in rec or not rec["frames"]:
        return None
    ms = device_ms(rec, lambda name: kernel_name(name) in WALK_KERNELS)
    if ms <= 0.0:
        return None
    return 100.0 * bound_ms(*rec["walk_work"])[0] / (ms / rec["frames"])
