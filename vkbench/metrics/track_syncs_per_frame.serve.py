"""Host waits on the device a frame inside the device tracker: CUDA
runtime synchronize events inside the program's `vk.serve.track` span, on
its thread (the greedy rounds' checks)."""

from vkbench import spans


def read(rec):
    n = spans.of(rec).syncs(("vk.serve.track",))
    return None if n is None else n / rec["profiled_items"]
