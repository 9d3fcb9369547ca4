"""Kernel launches a frame: CUDA runtime launch events in the profiled
rounds over their frames."""

from vkbench import trace


def read(rec):
    return trace.launches_per_item(rec)
