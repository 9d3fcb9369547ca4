"""Device ms a train step of the loss block in the step: the work launched
inside the program's `vk.train.loss` span (its backward falls in
`backward_ms.train`)."""

from vkbench import spans


def read(rec):
    return spans.ms_per_item(rec, ("vk.train.loss",))
