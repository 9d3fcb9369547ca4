"""Device ms a train step of the assignment: the costs and the one
Hungarian solve, launched inside the program's `vk.train.assign` span."""

from vkbench import spans


def read(rec):
    return spans.ms_per_item(rec, ("vk.train.assign",))
