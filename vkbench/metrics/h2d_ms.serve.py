"""Device ms a frame of the host-to-device copy of the frames: the work
launched inside the program's `vk.serve.h2d` span."""

from vkbench import spans


def read(rec):
    return spans.ms_per_item(rec, ("vk.serve.h2d",))
