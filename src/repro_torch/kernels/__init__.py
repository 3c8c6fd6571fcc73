"""The port's hand-written CUDA kernels, their plain versions and dispatch."""

from .ops import launch_counts, member_probe, reset_launch_counts, set_intersect

__all__ = ["member_probe", "set_intersect", "launch_counts", "reset_launch_counts"]
