"""Readings of the program's own spans in a `torch.profiler` trace: the
`record_function` events whose names start with `vk.`, which the program
opens in the layers they name. They are found by name alone; nothing here
imports the program, so a change to it cannot move the yardstick.

`Spans(events)` indexes one trace once (a trace holds hundreds of
thousands of events); the readers of a run share it through `of(rec)`.

- `device_s`: device time of the kernels, copies and sets whose CUDA
  runtime call (a launch, `cudaMemcpyAsync`, `cudaMemsetAsync`, tied to its
  device work by the correlation id) was made while a span of the given
  names was open on the calling thread, or, with `any_thread`, while it was
  open on any thread (the backward's kernels launch on autograd's device
  thread, not the one that called `backward()`);
- `syncs`: CUDA runtime synchronize events inside such a span, on its
  thread;
- `idle_split`: the device's idle time between the profiled part's first
  and last device activity, apportioned by overlap to the innermost `vk.`
  span open on one host thread.

A trace with no such span, or with no device work, reads None: a program
that opens no span leaves the metric out.
"""

from __future__ import annotations

import bisect
import collections

from torch.autograd import DeviceType

from vkbench import trace

PREFIX = "vk."
COPY = ("cudaMemcpyAsync", "cudaMemcpy", "cudaMemcpy2DAsync", "cudaMemsetAsync", "cudaMemset")
CALLS = trace.LAUNCH + COPY
# the innermost span on the pipeline's thread, by what its idle time means
IDLE_GROUPS = {
    "launch": ("vk.serve.round", "vk.model.backbone_neck", "vk.model.init_head",
               "vk.model.stage", "vk.serve.decode", "vk.serve.pack"),
    "sync": ("vk.serve.h2d", "vk.serve.track"),
    "wait": ("vk.serve.wait_input", "vk.serve.wait_result"),
}


class Spans:
    """The events of one trace that the span readings use."""

    def __init__(self, events):
        host = [e for e in events if e.device_type == DeviceType.CPU]
        self.dev = trace.device_events(events)
        self.opened: dict = {}
        for e in host:
            if e.name.startswith(PREFIX):
                self.opened.setdefault(e.name, []).append(e)
        self.calls = [e for e in host if e.name in CALLS]
        self.sync_calls = [e for e in host if e.name in trace.SYNC]

    def host_spans(self, names):
        return [e for name in names for e in self.opened.get(name, ())]

    def _within(self, names, any_thread):
        """{thread (None: any): merged intervals of the spans of `names`}."""
        by_thread: dict = {}
        for s in self.host_spans(names):
            by_thread.setdefault(None if any_thread else s.thread, []).append(
                (s.time_range.start, s.time_range.end))
        return {k: _merge(v) for k, v in by_thread.items()}

    def device_s(self, names, any_thread: bool = False):
        """Device seconds (the union of their intervals) of the work whose
        runtime call was made inside a span of `names`; None without such a
        span or without device work in the trace."""
        inside = self._within(names, any_thread)
        if not inside or not self.dev:
            return None
        work: dict = {}
        for e in self.dev:
            work.setdefault(e.id, []).append((e.time_range.start, e.time_range.end))
        picked = []
        for e in self.calls:
            merged = inside.get(None if any_thread else e.thread)
            if e.id in work and merged and _covers(merged, e.time_range.start):
                picked += work[e.id]
        return trace.union_us(picked) / 1e6

    def syncs(self, names):
        """CUDA runtime synchronize events inside a span of `names` on the
        same thread; None without such a span or without device work. Under
        torch 2.11 the runtime calls of a thread the profiler does not
        record (a drain worker's) carry the recording thread's id: such a
        call that starts inside the span counts too."""
        inside = self._within(names, False)
        if not inside or not self.dev:
            return None
        return sum(1 for e in self.sync_calls
                   if e.thread in inside and _covers(inside[e.thread], e.time_range.start))

    def thread_of(self, name):
        """The thread that opened most spans named `name` (None: none did)."""
        count = collections.Counter(e.thread for e in self.host_spans((name,)))
        return count.most_common(1)[0][0] if count else None

    def busy_s(self) -> float:
        return trace.union_us((e.time_range.start, e.time_range.end) for e in self.dev) / 1e6

    def idle_gaps(self):
        """(start, end) of each interval with no device activity between the
        first and the last device activity, as `trace.breakdown` takes them."""
        gaps, reach = [], None
        for s, e in sorted((e.time_range.start, e.time_range.end) for e in self.dev):
            if reach is not None and s > reach:
                gaps.append((reach, s))
            reach = e if reach is None else max(reach, e)
        return gaps

    def innermost(self, thread):
        """(start, end, name) segments of the timeline by the innermost `vk.`
        span open on `thread` (name None where none is open). Spans nest:
        none straddles another's boundary."""
        spans = sorted((e.time_range.start, -e.time_range.end, e.name)
                       for opened in self.opened.values() for e in opened
                       if e.thread == thread)
        segs, stack, t = [], [], float("-inf")

        def upto(end):
            nonlocal t
            if end > t:
                segs.append((t, end, stack[-1][1] if stack else None))
                t = end

        for s, neg_end, name in spans:
            while stack and stack[-1][0] <= s:
                upto(stack[-1][0])
                stack.pop()
            upto(s)
            stack.append((-neg_end, name))
        while stack:
            upto(stack[-1][0])
            stack.pop()
        segs.append((t, float("inf"), None))
        return segs

    def idle_split(self, thread):
        """({innermost span name, None where none: idle seconds}, all idle
        seconds) over the device's idle gaps; None without device work."""
        if not self.dev:
            return None
        gaps = self.idle_gaps()
        segs = self.innermost(thread)
        split: dict = {}
        i = 0
        for a, b in gaps:
            while segs[i][1] <= a:
                i += 1
            j = i
            while j < len(segs) and segs[j][0] < b:
                s, e, name = segs[j]
                split[name] = split.get(name, 0.0) + (min(b, e) - max(a, s)) / 1e6
                j += 1
        return split, sum(b - a for a, b in gaps) / 1e6


def _merge(intervals):
    """Sorted, disjoint (starts, ends) covering `intervals`."""
    starts, ends = [], []
    for s, e in sorted(intervals):
        if ends and s <= ends[-1]:
            ends[-1] = max(ends[-1], e)
        else:
            starts.append(s)
            ends.append(e)
    return starts, ends


def _covers(merged, t) -> bool:
    starts, ends = merged
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= ends[i]


# ------------------------------------------------------------ the readers'

def of(rec) -> Spans:
    """The run's `Spans`, built by its first reader and kept in `rec`."""
    if "vk_spans" not in rec:
        rec["vk_spans"] = Spans(rec["events"])
    return rec["vk_spans"]


def ms_per_item(rec, names, any_thread: bool = False):
    s = of(rec).device_s(names, any_thread)
    return None if s is None else s / rec["profiled_items"] * 1e3


def idle_ms_per_item(rec, group: str):
    """The idle time an item whose innermost span on the pipeline's thread
    is in `group` (`IDLE_GROUPS`): its share of the profiled idle time,
    times the idle time an item as `device_idle` reckons it (wall time an
    item with the profiler off, less device busy time an item under it),
    so that the profiler's slowdown of the host cancels to first order."""
    sp = of(rec)
    thread = sp.thread_of("vk.serve.round")
    got = None if thread is None else sp.idle_split(thread)
    if got is None or not rec["plain_items"]:
        return None
    split, idle = got
    if idle <= 0:
        return 0.0
    share = sum(split.get(name, 0.0) for name in IDLE_GROUPS[group]) / idle
    per_item = rec["plain_s"] / rec["plain_items"] - sp.busy_s() / rec["profiled_items"]
    return share * per_item * 1e3
