"""The port's hand-written CUDA kernels, their plain versions and dispatch."""

from .ops import (embedding_bag, flash_attention, launch_counts, member_probe,
                  reset_launch_counts, segment_sum, set_intersect)

__all__ = ["member_probe", "set_intersect", "segment_sum", "embedding_bag", "flash_attention",
           "launch_counts", "reset_launch_counts"]
