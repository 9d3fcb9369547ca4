"""Host waits on the device a frame: CUDA runtime synchronize events in
the profiled rounds over their frames."""

from vkbench import trace


def read(rec):
    if not trace.count(rec["events"], trace.LAUNCH):
        return None  # no CUDA activity traced
    return trace.count(rec["events"], trace.SYNC) / rec["profiled_items"]
