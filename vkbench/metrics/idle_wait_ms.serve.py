"""Device idle ms a frame while the pipeline waits for its next round or
on a drain: the innermost span open on its thread is
`vk.serve.wait_input` or `vk.serve.wait_result` (`spans.idle_ms_per_item`)."""

from vkbench import spans


def read(rec):
    return spans.idle_ms_per_item(rec, "wait")
