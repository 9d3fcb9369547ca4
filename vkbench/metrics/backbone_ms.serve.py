"""Device ms a frame of the kernels launched inside the model's backbone
and neck (`extract_feat`, wrapped in a `record_function` span from outside)."""

from vkbench import trace


def read(rec):
    s = trace.span_device_s(rec["events"], rec["spans"]["backbone"])
    return s / rec["profiled_items"] * 1e3 if s > 0 else None
