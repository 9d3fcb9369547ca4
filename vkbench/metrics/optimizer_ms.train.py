"""Device ms a train step of the optimizer: zero fills, the per-group clip,
AdamW and the schedule, launched inside the program's `vk.train.optimizer`
span."""

from vkbench import spans


def read(rec):
    return spans.ms_per_item(rec, ("vk.train.optimizer",))
