"""Port parity of the panoptic decode and the device tracker: merge_joint,
panoptic_decode_single and tracker_match over a short synthetic sequence.

Integer outputs (ids, labels, keep masks, id maps) must be equal; float
outputs (scores, embeddings, boxes) agree to 1e-5 relative.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import assert_rel_close, n, t

from video_knet_tpu.config import KNetConfig as JKNetConfig
from video_knet_tpu.config import TestCfg as JTestCfg
from video_knet_tpu.config import TrackerConfig as JTrackerConfig
from video_knet_tpu.models import knet as jknet
from video_knet_tpu.models.video import device_tracker as jdt
from video_knet_tpu.ops import panoptic as jpan
from video_knet_tpu_torch import config as tc
from video_knet_tpu_torch.models import knet as tknet
from video_knet_tpu_torch.models.video import device_tracker as tdt
from video_knet_tpu_torch.ops import panoptic as tpan


def _assert_result_equal(got, want):
    for name in want._fields:
        a, b = n(getattr(got, name)), np.asarray(getattr(want, name))
        if name == "scores":
            assert_rel_close(a, b, 1e-6, name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def _masks(rng, k, h, w):
    """Blobby probability maps: smooth random fields through a sigmoid."""
    coarse = rng.randn(k, h // 4, w // 4) * 4
    return (1 / (1 + np.exp(-np.kron(coarse, np.ones((4, 4)))))).astype(np.float32)


@pytest.mark.parametrize("tied", [False, True])
def test_merge_joint_matches(tied):
    rng = np.random.RandomState(0)
    k = 14
    masks = _masks(rng, k, 16, 24)
    scores = rng.uniform(0.1, 1.0, k).astype(np.float32)
    if tied:  # equal scores: ids follow the stable sort
        scores[3:7] = scores[2]
    labels = rng.randint(0, 19, k).astype(np.int32)
    kw = dict(num_thing_classes=2, instance_score_thr=0.25, overlap_thr=0.6)
    want = jpan.merge_joint(jnp.asarray(masks), jnp.asarray(scores), jnp.asarray(labels), **kw)
    got = tpan.merge_joint(t(masks), t(scores), t(labels), **kw)
    _assert_result_equal(got, want)
    assert int(n(got.keep).sum()) > 0
    host = jpan.segments_to_host(jpan.PanopticResult(*[np.asarray(x) for x in want]), 2)
    port = tpan.segments_to_host(tpan.PanopticResult(*[n(x) for x in got]), 2)
    np.testing.assert_array_equal(port[0], host[0])
    assert port[1] == host[1]


@pytest.mark.parametrize("fast_decode,out_hw", [(True, None), (True, (32, 48)),
                                                (False, (32, 48))])
def test_panoptic_decode_single_matches(fast_decode, out_hw):
    rng = np.random.RandomState(1)
    n_prop, n_tot = 6, 6 + 17
    cls = (rng.randn(n_tot, 19) * 2).astype(np.float32)
    cls[2, :2] = cls[0, 0]  # tied thing scores: top-k keeps the lower index first
    masks = (rng.randn(n_tot, 4, 6) * 4).repeat(4, 1).repeat(4, 2).astype(np.float32)
    obj = rng.randn(n_tot, 1, 8).astype(np.float32)
    seg = rng.randn(4, 6, 19).astype(np.float32)
    test_kw = dict(instance_score_thr=0.05, fast_decode=fast_decode)
    jcfg = JKNetConfig(num_proposals=n_prop, test=JTestCfg(**test_kw))
    tcfg = tc.KNetConfig(num_proposals=n_prop, test=tc.TestCfg(**test_kw))
    want = jknet.panoptic_decode_single(cls, masks, obj, seg, jcfg, out_hw)
    got = tknet.panoptic_decode_single(t(cls), t(masks), t(obj), t(seg), tcfg, out_hw)
    _assert_result_equal(got.result, want.result)
    np.testing.assert_array_equal(n(got.thing_mask_idx), np.asarray(want.thing_mask_idx))
    np.testing.assert_array_equal(n(got.thing_kernels), np.asarray(want.thing_kernels))


def test_top_k_breaks_ties_toward_lower_index():
    x = t(np.array([0.5, 0.9, 0.5, 0.9, 0.1, 0.5], np.float32))
    vals, idx = tknet.top_k(x, 4)
    assert n(idx).tolist() == [1, 3, 0, 2]


def test_thing_detections_and_tables_match():
    rng = np.random.RandomState(2)
    k = 9
    pan = rng.randint(0, k + 2, size=(16, 24)).astype(np.int32)
    seg_ids = rng.permutation(np.arange(1, k + 1)).astype(np.int32)
    seg_ids[4] = 0
    valid = rng.rand(k) > 0.3
    scores = rng.rand(k).astype(np.float32)
    semth = rng.rand(16, 24) > 0.2
    want = jdt.thing_detections_from_decode(pan, seg_ids, valid, scores, semth, (4.0, 2.5))
    got = tdt.thing_detections_from_decode(t(pan), t(seg_ids), t(valid), t(scores), t(semth),
                                           (4.0, 2.5))
    np.testing.assert_array_equal(n(got), np.asarray(want))
    for args in ((2, 17, (11, 13)), (8, 11, None)):
        np.testing.assert_array_equal(tdt.dataset_class_table(*args),
                                      jdt.dataset_class_table(*args))
    boxes = rng.rand(7, 4).astype(np.float32) * 10
    boxes[:, 2:] += boxes[:, :2]
    assert_rel_close(tdt.boxes_iou(t(boxes), t(boxes[:5])),
                     jdt.boxes_iou(boxes, boxes[:5]), 1e-6, "boxes_iou")


def _sequence(seed, frames=7, k=10, d=16):
    """Detections of 6 identities moving across frames, with duplicates,
    invalid rows, and one frame without detections."""
    rng = np.random.RandomState(seed)
    ident = rng.randn(6, d).astype(np.float32)
    pos = rng.uniform(0, 80, (6, 2))
    seq = []
    for f in range(frames):
        who = rng.choice(6, size=k, replace=True)
        xy = pos[who] + f * 3 + rng.randn(k, 2)
        wh = rng.uniform(8, 20, (k, 2))
        boxes = np.concatenate([xy, xy + wh, rng.uniform(0.2, 1.0, (k, 1))], 1)
        emb = ident[who] + 0.3 * rng.randn(k, d)
        labels = (who % 2).astype(np.int32)
        valid = rng.rand(k) > 0.2
        if f == 3:
            valid[:] = False
        seq.append((boxes.astype(np.float32), labels, emb.astype(np.float32), valid))
    return seq


@pytest.mark.parametrize("gates", ["release", "zero"])
def test_tracker_match_sequence_matches(gates):
    kw = dict(memo_capacity=16)
    if gates == "zero":
        kw.update(init_score_thr=0.0, obj_score_thr=0.0, match_score_thr=0.05)
    jcfg, tcfg = JTrackerConfig(**kw), tc.TrackerConfig(**kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    js = jdt.init_tracker_state(jcfg, 10, 16)
    ts = tdt.init_tracker_state(tcfg, 10, 16)
    matched = 0
    for f, (boxes, labels, emb, valid) in enumerate(_sequence(3)):
        js = jdt.reset_state(js, jnp.asarray(f == 0))
        ts = tdt.reset_state(ts, torch.tensor(f == 0))
        js, jids, jsurv = jdt.tracker_match(js, boxes, labels, emb, valid, jcfg)
        ts, tids, tsurv = tdt.tracker_match(ts, t(boxes), t(labels), t(emb), t(valid), tcfg)
        np.testing.assert_array_equal(n(tids), np.asarray(jids), err_msg=f"ids frame {f}")
        np.testing.assert_array_equal(n(tsurv), np.asarray(jsurv), err_msg=f"survived {f}")
        for name in js._fields:
            a, b = n(getattr(ts, name)), np.asarray(getattr(js, name))
            if a.dtype.kind == "f":
                assert_rel_close(a, b, 1e-5, f"{name} frame {f}")
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{name} frame {f}")
        matched += int((n(tids) >= 0).sum())
    assert matched > 0
