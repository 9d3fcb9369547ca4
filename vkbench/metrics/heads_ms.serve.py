"""Device ms a frame of the heads: the kernels, copies and sets launched
inside the program's `vk.model.init_head` and `vk.model.stage` spans (the
init head and the kernel-update stages, K1 and K2 among them)."""

from vkbench import spans


def read(rec):
    return spans.ms_per_item(rec, ("vk.model.init_head", "vk.model.stage"))
