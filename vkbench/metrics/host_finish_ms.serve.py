"""Host ms a frame in the serving pipeline's finish (segments, id-map
upsampling, look-up gathers): the pipeline's own `stats`, sum of `host_s`
over sum of `frames`, in the profiler-off half of a traced run."""

def read(rec):
    if not rec.get("host_frames"):
        return None
    return rec["host_s"] / rec["host_frames"] * 1e3
