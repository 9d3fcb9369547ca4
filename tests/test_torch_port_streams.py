"""The port's windowed and multi-stream serving, on the CPU, on the trained
tiny model (`video_knet_tpu_torch/tools/trained_golden.py`).

- `run_sequence` (windows of 2 and 3, a sequence boundary mid-stream, both
  tracker paths) equals `run_frame` bit for bit.
- `MultiStreamVPSPipeline` (B=2, stream 1 restarting at round 3): each
  stream against the single-stream pipeline on the same frames, same track
  id sets and more than 0.95 pixel agreement (the check of
  `tests/test_video_knet.py:212-248`); `run_batched_sequence` (T=6,
  window=4) equals `run_frames` bit for bit; host worker threads change
  nothing.
- The batched decode and the batched device-tracker step against JAX's.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import trained_golden_common as jtg
from torch_port_common import assert_rel_close, n, t

from video_knet_tpu.config import KNetConfig as JKNetConfig
from video_knet_tpu.config import TestCfg as JTestCfg
from video_knet_tpu.models import knet as jknet
from video_knet_tpu.models.video import inference as jinf
from video_knet_tpu.models.video.knet_vps import VideoKNet as JVideoKNet
from video_knet_tpu_torch import config as tc
from video_knet_tpu_torch.models import knet as tknet
from video_knet_tpu_torch.models.video import inference as tinf
from video_knet_tpu_torch.models.video.inference import (
    MultiStreamVPSPipeline,
    VPSInferencePipeline,
)
from video_knet_tpu_torch.tools import trained_golden as tg

TRACKERS = ("quasi_dense", "quasi_dense_host")
BOUNDARY = 5  # a sequence restarts at this frame


@pytest.fixture(scope="module")
def tiny():
    return dict(model=tg.tiny_model("cpu"), cfg=tg.tiny_cfg(), frames=tg.eval_frames())


def _pipe(s, tracker_type):
    return VPSInferencePipeline(s["model"], s["cfg"], tg.HW, tracker_type=tracker_type,
                                device="cpu")


def _assert_same(got, want, what):
    assert len(got) == len(want), what
    a, b = tg.flatten_results(got), tg.flatten_results(want)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


@pytest.mark.parametrize("tracker_type", TRACKERS)
@pytest.mark.parametrize("window", [2, 3])
def test_run_sequence_equals_run_frame(tiny, tracker_type, window):
    flags = [i in (0, BOUNDARY) for i in range(tg.N_FRAMES)]
    pipe = _pipe(tiny, tracker_type)
    want = [pipe.run_frame(f, isf) for f, isf in zip(tiny["frames"], flags)]
    stats = []
    got = list(_pipe(tiny, tracker_type).run_sequence(tiny["frames"], flags, window=window,
                                                       depth=2, stats=stats))
    _assert_same(got, want, f"{tracker_type} window {window}")
    assert sum(s["frames"] for s in stats) == tg.N_FRAMES
    # the boundary flushes a short window: no window spans two sequences
    assert max(s["frames"] for s in stats) == window
    assert any((r.track_map > 0).any() for r in got)


def _streams(frames):
    """Two streams of 6 rounds: stream 0 is frames 0-5; stream 1 is frames
    6-8, then restarts at round 3 on frames 9-11."""
    rounds = [np.concatenate([frames[r], frames[6 + r]]) for r in range(6)]
    flags = [[r == 0, r in (0, 3)] for r in range(6)]
    return rounds, flags


def _single(s, tracker_type, frames, flags):
    pipe = _pipe(s, tracker_type)
    return [pipe.run_frame(f, isf) for f, isf in zip(frames, flags)]


@pytest.mark.parametrize("tracker_type", TRACKERS)
def test_multi_stream_matches_single_stream(tiny, tracker_type):
    rounds, flags = _streams(tiny["frames"])
    ms = MultiStreamVPSPipeline(tiny["model"], tiny["cfg"], tg.HW, 2,
                                tracker_type=tracker_type, device="cpu")
    per_round = [ms.run_frames(r, f) for r, f in zip(rounds, flags)]
    for b in range(2):
        single = _single(tiny, tracker_type, [r[b:b + 1] for r in rounds],
                         [f[b] for f in flags])
        for i, (m, s1) in enumerate(zip([pr[b] for pr in per_round], single)):
            ids_m = set(np.unique(m.track_map[m.track_map > 0]).tolist())
            ids_s = set(np.unique(s1.track_map[s1.track_map > 0]).tolist())
            assert ids_m == ids_s, (b, i, ids_m, ids_s)
            for key in ("panoptic_seg", "semantic_map", "track_map"):
                agree = float(np.mean(getattr(m, key) == getattr(s1, key)))
                assert agree > 0.95, (b, i, key, agree)
    # stream 1's restart at round 3 gave it fresh ids from 1
    ids_after = np.unique(per_round[3][1].track_map)
    assert ids_after.max() <= 2, ids_after


@pytest.mark.parametrize("tracker_type", TRACKERS)
def test_run_batched_sequence_equals_run_frames(tiny, tracker_type):
    rounds, flags = _streams(tiny["frames"])
    ms = MultiStreamVPSPipeline(tiny["model"], tiny["cfg"], tg.HW, 2,
                                tracker_type=tracker_type, device="cpu")
    want = [ms.run_frames(r, f) for r, f in zip(rounds, flags)]
    ms2 = MultiStreamVPSPipeline(tiny["model"], tiny["cfg"], tg.HW, 2,
                                 tracker_type=tracker_type, device="cpu", host_workers=2)
    stats = []
    got = list(ms2.run_batched_sequence(rounds, flags, depth=2, stats=stats, window=4))
    ms2.close()
    assert [s["frames"] for s in stats] == [8, 4]
    for b in range(2):
        _assert_same([g[b] for g in got], [w[b] for w in want], f"{tracker_type} stream {b}")


def test_multi_stream_defaults_to_cuda(tiny):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        MultiStreamVPSPipeline(tiny["model"], tiny["cfg"], tg.HW, 2)
    with pytest.raises(RuntimeError):
        VPSInferencePipeline(tiny["model"], tiny["cfg"], tg.HW, tracker_type="quasi_dense_host")


@pytest.mark.parametrize("fast_decode,out_hw", [(True, None), (False, (32, 48))])
def test_panoptic_decode_batch_matches_jax(fast_decode, out_hw):
    rng = np.random.RandomState(1)
    b, n_prop, n_tot = 2, 6, 6 + 17
    cls = (rng.randn(b, n_tot, 19) * 2).astype(np.float32)
    masks = (rng.randn(b, n_tot, 4, 6) * 4).repeat(4, 2).repeat(4, 3).astype(np.float32)
    obj = rng.randn(b, n_tot, 1, 8).astype(np.float32)
    seg = rng.randn(b, 4, 6, 19).astype(np.float32)
    test_kw = dict(instance_score_thr=0.05, fast_decode=fast_decode)
    jcfg = JKNetConfig(num_proposals=n_prop, test=JTestCfg(**test_kw))
    tcfg = tc.KNetConfig(num_proposals=n_prop, test=tc.TestCfg(**test_kw))

    def inputs(a):
        last = types.SimpleNamespace(cls_score=a(cls), scaled_mask_preds=a(masks),
                                     object_feats=a(obj))
        return types.SimpleNamespace(seg_preds=a(seg)), [last]

    want = jknet.panoptic_decode_batch(*inputs(jnp.asarray), jcfg, out_hw)
    got = tknet.panoptic_decode_batch(*inputs(t), tcfg, out_hw)
    for name in want.result._fields:
        a, w = n(getattr(got.result, name)), np.asarray(getattr(want.result, name))
        if name == "scores":
            assert_rel_close(a, w, 1e-6, name)
        else:
            np.testing.assert_array_equal(a, w, err_msg=name)
    np.testing.assert_array_equal(n(got.thing_mask_idx), np.asarray(want.thing_mask_idx))
    np.testing.assert_array_equal(n(got.thing_kernels), np.asarray(want.thing_kernels))


def test_batched_device_tracker_step_matches_jax(tiny):
    """Two rounds of the B=2 device-tracker step (stream 1 restarting on the
    second): id maps, LUTs and carried tracker memory against JAX's vmapped
    step."""
    from video_knet_tpu.models.video import device_tracker as jdt
    from video_knet_tpu_torch.models.video import device_tracker as tdt

    jcfg = jtg.tiny_cfg()
    jm = JVideoKNet(jcfg, train=False)
    jstep = jinf.make_device_tracker_frame_step(jm, jtg.load_weights(), jcfg, tg.HW,
                                                batched=True)
    pstep = tinf.make_device_tracker_frame_step(tiny["model"], tiny["cfg"], tg.HW,
                                                batched=True)
    one = jdt.init_tracker_state(jcfg.tracker, 20, 64)
    jst = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (2, *x.shape)), one)
    pone = tdt.init_tracker_state(tiny["cfg"].tracker, 20, 64)
    pst = tdt.TrackerState(*[torch.stack([x, x]) for x in pone])
    jprev = jnp.zeros((2, 37, 1, 64))
    pprev = torch.zeros((2, 37, 1, 64))
    fr = tiny["frames"]
    for r, flags in enumerate(([True, True], [False, True])):
        img = np.concatenate([fr[r], fr[6 + r]])
        want = jstep(jnp.asarray(img), jprev, jst, jnp.asarray(flags))
        got = pstep(t(img), pprev, pst, flags)
        jprev, jst = want.pop("new_obj_feats"), want.pop("track_state")
        pprev, pst = got.pop("new_obj_feats"), got.pop("track_state")
        assert set(got) == set(want)
        for key, w in want.items():
            a, w = n(got[key]), np.asarray(w)
            if w.dtype.kind == "f":
                assert_rel_close(a, w, 1e-5, f"round {r} {key}")
            else:
                np.testing.assert_array_equal(a.astype(w.dtype), w, err_msg=f"round {r} {key}")
        for name in one._fields:
            a, w = n(getattr(pst, name)), np.asarray(getattr(jst, name))
            if w.dtype.kind == "f":
                assert_rel_close(a, w, 1e-5, f"round {r} state {name}")
            else:
                np.testing.assert_array_equal(a, w, err_msg=f"round {r} state {name}")
        assert_rel_close(pprev, jprev, 1e-4, f"round {r} new_obj_feats")
