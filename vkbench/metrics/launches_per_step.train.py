"""Kernel launches a train step: CUDA runtime launch events in the
profiled steps over their count."""

from vkbench import trace


def read(rec):
    return trace.launches_per_item(rec)
