"""Device idle ms a frame while the host waits on a copy or a sync: the
innermost span open on the pipeline's thread is `vk.serve.h2d` or
`vk.serve.track` (`spans.idle_ms_per_item`)."""

from vkbench import spans


def read(rec):
    return spans.idle_ms_per_item(rec, "sync")
