"""Peak device memory the program allocated in the profiler-off half of
the window (after `reset_peak_memory_stats` at its start), GiB."""

def read(rec):
    return None if rec["peak_alloc"] is None else rec["peak_alloc"] / 2**30
