"""`vkbench/spans.py` against synthetic profiler events: attribution by
thread and, for the backward, by interval on any thread; copies and sets
tied to their runtime calls by the correlation id; synchronize counts; the
device's idle time split by the innermost span, by overlap."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from vkbench import spans

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def ev(name, start, end, thread=1, id=0, device=CPU):
    return SimpleNamespace(name=name, device_type=device, thread=thread, id=id,
                           time_range=SimpleNamespace(start=start, end=end))


def host_and_device(name, at, corr, dev_start, dev_end, thread=1, dev_name="kernel"):
    """A runtime call at `at` on `thread` and the device work it enqueued."""
    return [ev(name, at, at + 1, thread, corr),
            ev(dev_name, dev_start, dev_end, 0, corr, CUDA)]


def launches():
    return [
        ev("vk.train.backward", 0, 100, thread=1),
        # the span's device-side annotation is no work
        ev("vk.train.backward", 200, 400, thread=0, device=CUDA),
        *host_and_device("cudaLaunchKernel", 10, 1, 200, 230, thread=1),
        *host_and_device("cudaLaunchKernel", 20, 2, 230, 250, thread=2),  # autograd's thread
        *host_and_device("cudaLaunchKernel", 150, 3, 260, 270, thread=1),  # after the span
        *host_and_device("cudaLaunchKernel", 150, 4, 270, 280, thread=2),
    ]


def test_work_is_attributed_by_the_launching_thread():
    assert spans.Spans(launches()).device_s(("vk.train.backward",)) == pytest.approx(30e-6)


def test_the_backward_takes_launches_on_any_thread_within_its_interval():
    got = spans.Spans(launches()).device_s(("vk.train.backward",), any_thread=True)
    assert got == pytest.approx(50e-6)


def test_copies_and_sets_are_tied_by_the_correlation_id():
    events = [
        ev("vk.serve.h2d", 0, 50),
        *host_and_device("cudaMemcpyAsync", 5, 7, 100, 140, dev_name="Memcpy HtoD (Pageable)"),
        *host_and_device("cudaMemsetAsync", 30, 8, 140, 145, dev_name="Memset (Device)"),
        # another call's work with no runtime call in the span
        *host_and_device("cudaMemcpyAsync", 60, 9, 150, 190, dev_name="Memcpy DtoH"),
        ev("aten::copy_", 4, 45, id=7),  # an op's id is no runtime call
    ]
    assert spans.Spans(events).device_s(("vk.serve.h2d",)) == pytest.approx(45e-6)


def test_overlapping_work_counts_once_and_spans_of_several_names_add():
    events = [
        ev("vk.model.init_head", 0, 10), ev("vk.model.stage", 10, 20),
        *host_and_device("cudaLaunchKernel", 2, 1, 100, 130),
        *host_and_device("cudaLaunchKernelExC", 12, 2, 120, 140),  # overlaps the one before
    ]
    got = spans.Spans(events).device_s(("vk.model.init_head", "vk.model.stage"))
    assert got == pytest.approx(40e-6)


def test_nothing_to_read_reads_none():
    assert spans.Spans(launches()).device_s(("vk.serve.decode",)) is None
    host_only = [ev("vk.serve.decode", 0, 10), ev("aten::add", 1, 2)]
    assert spans.Spans(host_only).device_s(("vk.serve.decode",)) is None
    assert spans.Spans(host_only).syncs(("vk.serve.decode",)) is None
    assert spans.Spans(host_only).idle_split(1) is None


def test_syncs_inside_a_span_on_its_thread():
    events = [
        ev("vk.serve.track", 0, 100, thread=1),
        *host_and_device("cudaLaunchKernel", 1, 1, 0, 5),
        ev("cudaStreamSynchronize", 10, 20, thread=1),
        ev("cudaStreamSynchronize", 30, 40, thread=1),
        ev("cudaEventSynchronize", 50, 60, thread=3),  # a drain worker's wait
        ev("cudaStreamSynchronize", 120, 130, thread=1),  # after the span
    ]
    assert spans.Spans(events).syncs(("vk.serve.track",)) == 2


def idle_events():
    """Device work 0-10, 20-30, 50-60; on thread 1 a round over 5-45 with a
    copy over 12-18 inside it, then the wait for the next round over 45-60;
    a span on thread 2 that the split must not see."""
    work = [(0, 10), (20, 30), (50, 60)]
    return [ev("k", s, e, 0, i, CUDA) for i, (s, e) in enumerate(work)] + [
        ev("vk.serve.round", 5, 45), ev("vk.serve.h2d", 12, 18),
        ev("vk.serve.wait_input", 45, 60), ev("vk.serve.pack", 0, 60, thread=2)]


def test_idle_gaps_lie_between_the_first_and_last_device_activity():
    assert spans.Spans(idle_events()).idle_gaps() == [(10, 20), (30, 50)]


def test_idle_is_split_by_the_innermost_span_by_overlap():
    split, idle = spans.Spans(idle_events()).idle_split(1)
    assert idle == pytest.approx(30e-6)
    # gap 10-20: round 2, copy 6, round 2; gap 30-50: round 15, wait 5
    assert split == pytest.approx({"vk.serve.round": 19e-6, "vk.serve.h2d": 6e-6,
                                   "vk.serve.wait_input": 5e-6})
    split, _ = spans.Spans(idle_events()).idle_split(2)
    assert split == pytest.approx({"vk.serve.pack": 30e-6})


def test_idle_outside_every_span_is_put_down_to_none():
    events = idle_events()[:3] + [ev("vk.serve.round", 12, 16)]
    split, _ = spans.Spans(events).idle_split(1)
    assert split == pytest.approx({None: 26e-6, "vk.serve.round": 4e-6})


def test_idle_ms_a_frame_scales_the_share_to_the_unprofiled_idle_time():
    # busy 30 us over 2 frames under the profiler (15 us a frame); 40 us a
    # frame of wall with it off: 25 us idle a frame, of which the copy's
    # 6 of 30 and the waits' 5 of 30
    rec = dict(events=idle_events(), profiled_items=2, plain_s=400e-6, plain_items=10)
    assert spans.idle_ms_per_item(rec, "sync") == pytest.approx(25e-3 * 6 / 30)
    assert spans.idle_ms_per_item(rec, "wait") == pytest.approx(25e-3 * 5 / 30)
    assert spans.idle_ms_per_item(rec, "launch") == pytest.approx(25e-3 * 19 / 30)
    no_round = [e for e in idle_events() if e.name != "vk.serve.round"]
    rec = dict(rec, events=no_round, vk_spans=spans.Spans(no_round))
    assert spans.idle_ms_per_item(rec, "wait") is None  # no round: no pipeline thread
