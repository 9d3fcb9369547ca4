"""Whole step's share of the fp32 peak: the plain reference's operations
an item (a frame's forward; a train step's forward and backward), counted
on meta tensors, times the items of the profiler-off half, over its wall
time, over 67 TFLOP/s."""

from vkbench import roofline


def read(rec):
    if rec["peak_alloc"] is None:
        return None  # not a device run
    return roofline.mfu(rec["flops_per_item"] * rec["plain_items"], rec["plain_s"])
