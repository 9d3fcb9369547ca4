"""Readings of a `torch.profiler` trace (CPU and CUDA activities) that the
per-layer metrics share: device busy time as the union of kernel, copy and
set intervals; kernel launches and host waits counted from the CUDA
runtime's events; device time of kernels by name; device time of the
kernels launched inside a span; the breakdown of busy and idle time.
"""

from __future__ import annotations

from torch.autograd import DeviceType

LAUNCH = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
          "cudaLaunchCooperativeKernel")
SYNC = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def device_events(events):
    """Kernels, copies and sets on the device. The device-side copy of a
    `record_function` span (a user annotation, such as the optimizer's
    step) carries its host event's name, and is not work."""
    host = {e.name for e in events if e.device_type == DeviceType.CPU}
    return [e for e in events if e.device_type == DeviceType.CUDA and e.name not in host
            and not getattr(e, "is_user_annotation", False)]


def union_us(spans) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def busy_s(events) -> float:
    return union_us((e.time_range.start, e.time_range.end) for e in device_events(events)) / 1e6


def count(events, names) -> int:
    return sum(1 for e in events if e.name in names)


def launches_per_item(rec):
    """Kernel launches in the profiled part over the items (frames, steps)
    it ran; None where nothing was launched on a card."""
    n = count(rec["events"], LAUNCH)
    return n / rec["profiled_items"] if n else None


def kernel_s(events, key: str) -> float:
    """Device seconds of the kernels whose name holds `key` (their union:
    a kernel's chained launches may overlap)."""
    return union_us((e.time_range.start, e.time_range.end) for e in device_events(events)
                    if key in e.name) / 1e6


def span_device_s(events, span: str) -> float:
    """Device seconds of the kernels launched while a `record_function`
    span named `span` was open on the launching thread: each launch's
    runtime event is tied to its kernels by the correlation id."""
    spans = [(e.thread, e.time_range.start, e.time_range.end) for e in events
             if e.name == span and e.device_type == DeviceType.CPU]
    if not spans:
        return 0.0
    kernels: dict = {}
    for e in device_events(events):
        kernels.setdefault(e.id, []).append(e)
    total = 0.0
    for e in events:
        if e.device_type != DeviceType.CPU or e.name not in LAUNCH:
            continue
        t = e.time_range.start
        if any(th == e.thread and s <= t <= end for th, s, end in spans):
            total += sum(k.time_range.end - k.time_range.start for k in kernels.get(e.id, ()))
    return total / 1e6


def breakdown(events, top: int = 10) -> dict:
    """The device operations that took most time, and the longest gaps in
    the device's activity labelled by the innermost host operation open
    across the gap's middle."""
    dev = device_events(events)
    by_name: dict = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    gaps, reach = [], None
    for s, e in spans:
        if reach is not None and s > reach:
            gaps.append((s - reach, reach, s))
        reach = e if reach is None else max(reach, e)
    gaps = sorted(gaps, reverse=True)[:top]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    idle = []
    for length, a, b in gaps:
        mid = (a + b) / 2
        open_ = [e for e in host if e.time_range.start <= mid <= e.time_range.end]
        name = min(open_, key=lambda e: e.time_range.end - e.time_range.start).name if open_ \
            else "no host operation"
        idle.append([name[:120], length / 1e6])
    return {"device_ops": [[k[:120], v] for k, v in ops], "idle_gaps": idle}
