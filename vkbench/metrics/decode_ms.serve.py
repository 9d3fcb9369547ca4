"""Device ms a frame of the panoptic decode, the semantic filter and the
payload casts: the work launched inside the program's `vk.serve.decode`
span."""

from vkbench import spans


def read(rec):
    return spans.ms_per_item(rec, ("vk.serve.decode",))
