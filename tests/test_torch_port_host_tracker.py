"""The port's host-tracker serving path against the JAX package, on the CPU.

- `models/video/tracker.py` (own numpy copy): ids, selections and memo equal
  the reference's on seeded sequences with duplicates, tied scores,
  backdrops and memo expiry.
- `make_frame_step` payloads, compact (`fast_decode`) and full
  (`fast_decode=False`), single-stream and batched, on the trained tiny
  model: integer fields equal, floats within 1e-5 relative, the bf16
  embeddings equal (torch's round-to-nearest-even cast is XLA's).
- `semantic_map_from_panoptic` equal; the `fast_decode=False` serving path
  (host tracker by fallback) equal to the JAX pipeline's on the trained
  sequence.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import trained_golden_common as jtg
from torch_port_common import assert_rel_close, n, t

from video_knet_tpu.config import TrackerConfig as JTrackerConfig
from video_knet_tpu.models.video import inference as jinf
from video_knet_tpu.models.video import tracker as jtr
from video_knet_tpu.models.video.knet_vps import VideoKNet as JVideoKNet
from video_knet_tpu_torch import config as tc
from video_knet_tpu_torch.models.video import inference as tinf
from video_knet_tpu_torch.models.video import tracker as ttr
from video_knet_tpu_torch.tools import trained_golden as tg


def _detections(seed, frames=12, k=9, d=16):
    """Detections of 5 identities: identity 4 leaves after frame 2 (its
    tracklet expires), duplicates of a detection with a lower or tied
    score, low-score backdrops, and one empty frame."""
    rng = np.random.RandomState(seed)
    ident = rng.randn(5, d).astype(np.float32)
    pos = rng.uniform(0, 80, (5, 2))
    seq = []
    for f in range(frames):
        if f == 6:
            seq.append((np.zeros((0, 5), np.float32), np.zeros(0, np.int64),
                        np.zeros((0, d), np.float32)))
            continue
        pool = 5 if f <= 2 else 4
        who = rng.choice(pool, size=k, replace=True)
        xy = pos[who] + f * 3 + rng.randn(k, 2)
        wh = rng.uniform(8, 20, (k, 2))
        score = rng.uniform(0.1, 1.0, k)
        score[1] = score[0]  # a tie (the unstable argsort must order it as numpy does)
        boxes = np.concatenate([xy, xy + wh, score[:, None]], 1)
        boxes[2, :4] = boxes[0, :4] + 0.5  # a duplicate of row 0
        emb = ident[who] + 0.3 * rng.randn(k, d)
        seq.append((boxes.astype(np.float32), (who % 2).astype(np.int64),
                    emb.astype(np.float32)))
    return seq


@pytest.mark.parametrize("seed,gates", [(0, "release"), (1, "release"), (2, "zero")])
def test_host_tracker_matches_jax(seed, gates):
    kw = {}
    if gates == "zero":
        kw = dict(init_score_thr=0.0, obj_score_thr=0.0, match_score_thr=0.05)
    jt = jtr.QuasiDenseEmbedTracker(JTrackerConfig(**kw))
    pt = ttr.QuasiDenseEmbedTracker(tc.TrackerConfig(**kw))
    assigned = 0
    for f, (boxes, labels, emb) in enumerate(_detections(seed)):
        jsel, jlab, jids = jt.match(boxes, labels, emb, f)
        psel, plab, pids = pt.match(boxes, labels, emb, f)
        np.testing.assert_array_equal(psel, jsel, err_msg=f"sel frame {f}")
        np.testing.assert_array_equal(plab, jlab, err_msg=f"labels frame {f}")
        np.testing.assert_array_equal(pids, jids, err_msg=f"ids frame {f}")
        assert sorted(pt.tracklets) == sorted(jt.tracklets), f"memo frame {f}"
        for k, v in jt.tracklets.items():
            np.testing.assert_array_equal(pt.tracklets[k]["embed"], v["embed"])
            assert pt.tracklets[k]["last_frame"] == v["last_frame"]
        assert len(pt.backdrops) == len(jt.backdrops)
        assigned += int((pids >= 0).sum())
    assert assigned > 0 and pt.num_tracklets == jt.num_tracklets


def test_boxes_and_overlaps_match_jax():
    rng = np.random.RandomState(4)
    masks = rng.rand(6, 20, 30) > 0.97
    masks[2] = False  # an empty mask gives a zero box
    np.testing.assert_array_equal(ttr.masks_to_boxes(masks), jtr.masks_to_boxes(masks))
    a = rng.rand(5, 4).astype(np.float32) * 10
    a[:, 2:] += a[:, :2]
    np.testing.assert_array_equal(ttr.bbox_overlaps(a, a[:3]), jtr.bbox_overlaps(a, a[:3]))
    np.testing.assert_array_equal(ttr._softmax(a, 0), jtr._softmax(a, 0))
    np.testing.assert_array_equal(ttr._l2n(a), jtr._l2n(a))


def test_semantic_map_from_panoptic_matches_jax():
    rng = np.random.RandomState(5)
    pan = rng.randint(0, 7, (16, 24)).astype(np.int32)
    segs = [dict(id=i, isthing=i <= 2, category_id=(i - 1) % 2 if i <= 2 else i + 3)
            for i in range(1, 7)]
    for ids in ((11, 13), None):
        kw = dict(num_thing_classes=2, num_stuff_classes=17, thing_ids_in_orig=ids)
        np.testing.assert_array_equal(tinf.semantic_map_from_panoptic(pan, segs, **kw),
                                      jinf.semantic_map_from_panoptic(pan, segs, **kw))


def test_bf16_cast_matches_xla():
    """The compact payload's fp32 -> bf16 cast: round to nearest even in both
    packages, halfway cases included."""
    rng = np.random.RandomState(7)
    x = rng.randn(4096).astype(np.float32)
    bits = x.view(np.uint32)
    bits[:1024] = (bits[:1024] & 0xFFFF0000) | 0x8000  # exactly halfway
    bits[1024:1100] = (bits[1024:1100] & 0xFFFF0000) | 0x7FFF
    got = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16), np.float32)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def trained():
    """The trained tiny model in both packages, and its frames."""
    jcfg = jtg.tiny_cfg()
    variables = jtg.load_weights()
    return dict(jcfg=jcfg, jm=JVideoKNet(jcfg, train=False), variables=variables,
                model=tg.tiny_model("cpu"), frames=tg.eval_frames())


def _fast_decode(cfg, on: bool):
    return dataclasses.replace(cfg, test=dataclasses.replace(cfg.test, fast_decode=on))


def _compare_payload(got, want, what):
    for key, w in want.items():
        if key == "pred":
            for name, a, b in zip(w.result._fields, got[key].result, w.result):
                _compare_leaf(a, b, f"{what} pred.{name}")
            _compare_leaf(got[key].thing_mask_idx, w.thing_mask_idx, f"{what} thing_mask_idx")
            _compare_leaf(got[key].thing_kernels, w.thing_kernels, f"{what} thing_kernels")
        elif key == "embeds" and w.dtype == jnp.bfloat16:
            # the cast itself is exact (test_bf16_cast_matches_xla); the fp32
            # embeddings differ at rounding level, so an element next to a
            # bf16 rounding boundary may land one bf16 ulp away
            assert got[key].dtype == torch.bfloat16, what
            a, b = n(got[key].float()), np.asarray(w, np.float32)
            assert np.all(np.abs(a - b) <= np.abs(b) * 2.0 ** -7), f"{what} bf16 embeds"
            assert np.mean(a != b) <= 0.01, f"{what} bf16 embeds: {np.mean(a != b)}"
        else:
            _compare_leaf(got[key], w, f"{what} {key}")


def _compare_leaf(a, b, what):
    a, b = n(a), np.asarray(b)
    if b.dtype.kind == "f":
        assert_rel_close(a, b, 1e-5, what)
    else:
        assert a.shape == b.shape, what
        np.testing.assert_array_equal(a.astype(b.dtype), b, err_msg=what)


@pytest.mark.parametrize("compact,batched", [(True, False), (False, False), (True, True)])
def test_frame_step_payload_matches_jax(trained, compact, batched):
    s = trained
    jcfg = _fast_decode(s["jcfg"], compact)
    cfg = _fast_decode(tg.tiny_cfg(), compact)
    rng = np.random.RandomState(6)
    bsz = 2 if batched else 1
    img = np.concatenate(s["frames"][3:3 + bsz])
    prev = rng.randn(bsz, 37, 1, 64).astype(np.float32)
    jstep = jinf.make_frame_step(s["jm"], s["variables"], jcfg, tg.HW, batched=batched,
                                 compact_host=compact)
    pstep = tinf.make_frame_step(s["model"], cfg, tg.HW, batched=batched, compact_host=compact)
    flags = [True, False][:bsz] if batched else False
    want = jstep(jnp.asarray(img), jnp.asarray(prev),
                 jnp.asarray(flags) if batched else jnp.asarray(False))
    got = pstep(t(img), t(prev), flags)
    assert set(got) == set(want)
    _compare_payload(got, want, f"compact={compact} batched={batched}")


def test_full_decode_serving_matches_jax(trained):
    """fast_decode=False: `quasi_dense` falls back to the host tracker on both
    sides; the outputs of the trained sequence agree."""
    s = trained
    jcfg = _fast_decode(s["jcfg"], False)
    cfg = _fast_decode(tg.tiny_cfg(), False)
    jpipe = jinf.VPSInferencePipeline(s["jm"], s["variables"], jcfg, out_hw=tg.HW)
    ppipe = tinf.VPSInferencePipeline(s["model"], cfg, tg.HW, device="cpu")
    assert not ppipe.device_tracker and not jpipe.device_tracker
    frames = s["frames"][:6]
    want = jtg.flatten_results([jpipe.run_frame(jnp.asarray(f), i == 0)
                                for i, f in enumerate(frames)])
    got = tg.flatten_results([ppipe.run_frame(f, i == 0) for i, f in enumerate(frames)])
    assert ppipe.frame_id == len(frames)
    for k in want:
        if k.startswith("seg_score_"):
            np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert any((got[f"trk_{i}"] > 0).any() for i in range(len(frames)))
