"""Device idle ms a frame while the host is still enqueuing: the innermost
span open on the pipeline's thread is `vk.serve.round`, a `vk.model.*`
span, `vk.serve.decode` or `vk.serve.pack` (`spans.idle_ms_per_item`)."""

from vkbench import spans


def read(rec):
    return spans.idle_ms_per_item(rec, "launch")
