"""Device ms a train step of the backward: the work launched on any thread
while the program's `vk.train.backward` span was open (autograd launches
it from its device thread)."""

from vkbench import spans


def read(rec):
    return spans.ms_per_item(rec, ("vk.train.backward",), any_thread=True)
