"""The port's program spans (`video_knet_tpu_torch/utils/profiling.py`), on
the CPU and without JAX.

- With the profiler off `span` returns one shared null context; the names
  the package opens are `SPANS`, no more and no fewer.
- Two streams served for three rounds under `torch.profiler`: every
  serving span lies on the calling thread, in the counts and the nesting a
  round implies, none straddling another's boundary, none open across the
  pipeline's yields; the results are bit-equal to an unprofiled run.
- One VPS train step under the profiler: forward, loss (the assignment
  inside it), backward and optimizer lie inside the step, in that order,
  and the losses and parameters equal an unprofiled step's.
"""

import contextlib
import dataclasses
import os
import re

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

import video_knet_tpu_torch
from video_knet_tpu_torch import config as tc
from video_knet_tpu_torch.models.video.inference import MultiStreamVPSPipeline
from video_knet_tpu_torch.models.video.knet_vps import VideoKNet
from video_knet_tpu_torch.tools import trained_golden as tg
from video_knet_tpu_torch.train.optim import make_optimizer
from video_knet_tpu_torch.train.train_state import create_train_state
from video_knet_tpu_torch.train.vps import make_synthetic_batch, train_step
from video_knet_tpu_torch.utils import profiling

PKG = os.path.dirname(video_knet_tpu_torch.__file__)
HW = (64, 96)  # the serving golden's frame size
ROUNDS = 3
CALLER = "test.caller"


def _traced(fn):
    """(fn's result, the `vk.` spans and the caller's span) under the CPU
    profiler, fn called inside the caller's span."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(CALLER):
            out = fn()
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    caller = [e for e in events if e.name == CALLER]
    assert len(caller) == 1
    return out, [e for e in events if e.name.startswith("vk.")], caller[0]


def _inside(inner, outer) -> bool:
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def _assert_nested(spans):
    """Any two spans are disjoint or one holds the other."""
    for i, a in enumerate(spans):
        for b in spans[i + 1:]:
            disjoint = (a.time_range.end <= b.time_range.start
                        or b.time_range.end <= a.time_range.start)
            assert disjoint or _inside(a, b) or _inside(b, a), (a.name, b.name)


def test_span_off_is_the_one_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    off = profiling.span("vk.serve.round")
    assert isinstance(off, contextlib.nullcontext)
    assert profiling.span("vk.train.step") is off
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = profiling.span("vk.train.step")
        with on:
            pass
    assert on is not off
    assert [e.name for e in prof.events()].count("vk.train.step") == 1


def test_the_package_opens_exactly_the_spans_it_lists():
    found = set()
    for root, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    found |= set(re.findall(r'\bspan\("([^"]+)"\)', f.read()))
    assert len(set(profiling.SPANS)) == len(profiling.SPANS)
    assert found == set(profiling.SPANS)


def _golden_cfg():
    """The serving golden's config (score gates at zero)."""
    base = tc.VideoKNetConfig(max_insts=8)
    return dataclasses.replace(
        base, test=dataclasses.replace(base.test, instance_score_thr=0.0),
        tracker=dataclasses.replace(base.tracker, init_score_thr=0.0, obj_score_thr=0.0,
                                    match_score_thr=0.05))


@pytest.fixture(scope="module")
def served():
    cfg = _golden_cfg()
    model = VideoKNet(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.RandomState(0)
    rounds = [rng.randn(2, *HW, 3).astype(np.float32) for _ in range(ROUNDS)]

    def serve():
        pipe = MultiStreamVPSPipeline(model, cfg, HW, 2, device="cpu")
        try:
            return list(pipe.run_batched_sequence(iter(rounds), depth=1, window=1))
        finally:
            pipe.close()

    plain = serve()
    traced, spans, caller = _traced(serve)
    return dict(plain=plain, traced=traced, spans=spans, caller=caller,
                stages=model.num_stages)


def test_serving_spans_nest_on_the_calling_thread(served):
    spans, caller = served["spans"], served["caller"]
    assert all(e.thread == caller.thread and _inside(e, caller) for e in spans)
    _assert_nested(spans)
    by = {}
    for e in spans:
        by.setdefault(e.name, []).append(e)
    counts = {k: len(v) for k, v in by.items()}
    # window=1, depth=1: a pack and a wait on a drain a round; the source
    # is pulled once more to find it empty
    assert counts == {
        "vk.serve.wait_input": ROUNDS + 1, "vk.serve.round": ROUNDS, "vk.serve.h2d": ROUNDS,
        "vk.model.backbone_neck": ROUNDS, "vk.model.init_head": ROUNDS,
        "vk.model.stage": ROUNDS * served["stages"], "vk.serve.decode": ROUNDS,
        "vk.serve.track": ROUNDS, "vk.serve.pack": ROUNDS, "vk.serve.wait_result": ROUNDS}
    top = ("vk.serve.wait_input", "vk.serve.round", "vk.serve.pack", "vk.serve.wait_result")
    for e in spans:
        holders = [o for o in spans if o is not e and _inside(e, o)]
        if e.name in top:  # the loop's own steps: nothing holds them
            assert not holders, e.name
        else:  # a round's work: inside its round and nothing else
            assert [o.name for o in holders] == ["vk.serve.round"], e.name
    for r in by["vk.serve.round"]:
        held = sorted((e for e in spans if e is not r and _inside(e, r)),
                      key=lambda e: e.time_range.start)
        assert [e.name for e in held] == (
            ["vk.serve.h2d", "vk.model.backbone_neck", "vk.model.init_head"]
            + ["vk.model.stage"] * served["stages"] + ["vk.serve.decode", "vk.serve.track"])


def test_serving_under_the_profiler_is_bit_equal(served):
    plain, traced = served["plain"], served["traced"]
    assert len(plain) == len(traced) == ROUNDS
    for a_round, b_round in zip(plain, traced):
        for a, b in zip(a_round, b_round, strict=True):
            for field in ("panoptic_seg", "semantic_map", "track_map"):
                np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
            assert a.segments_info == b.segments_info


def _train_state():
    cfg = tg.tiny_cfg()
    model = VideoKNet(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    return create_train_state(model, make_optimizer(model, steps_per_epoch=10))


def test_train_step_spans_in_order_and_the_step_unchanged():
    batch = make_synthetic_batch(tg.tiny_cfg(), 1, HW, seed=3, device="cpu")
    plain_state, plain = train_step(_train_state(), batch)
    (state, losses), spans, caller = _traced(lambda: train_step(_train_state(), batch))
    assert all(e.thread == caller.thread for e in spans)
    by = {}
    for e in spans:
        by.setdefault(e.name, []).append(e)
    parts = ("vk.train.forward", "vk.train.loss", "vk.train.backward", "vk.train.optimizer")
    assert all(len(by[n]) == 1 for n in ("vk.train.step", "vk.train.assign") + parts)
    step = by["vk.train.step"][0]
    assert all(_inside(by[n][0], step) for n in parts)
    for a, b in zip(parts, parts[1:]):
        assert by[a][0].time_range.end <= by[b][0].time_range.start, (a, b)
    assert _inside(by["vk.train.assign"][0], by["vk.train.loss"][0])
    _assert_nested(spans)
    assert set(losses) == set(plain)
    for k in plain:
        assert torch.equal(losses[k], plain[k]), k
    for (name, p), q in zip(state.model.named_parameters(),
                            plain_state.model.parameters(), strict=True):
        assert torch.equal(p, q), name
