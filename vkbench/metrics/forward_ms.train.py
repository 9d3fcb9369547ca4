"""Device ms a train step of the forward: the work launched inside the
program's `vk.train.forward` span."""

from vkbench import spans


def read(rec):
    return spans.ms_per_item(rec, ("vk.train.forward",))
