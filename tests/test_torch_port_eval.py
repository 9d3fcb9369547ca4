"""The port's evaluation against the JAX package's, on the CPU.

`video_knet_tpu_torch/eval` (windowed VPQ, STQ / DSTQ, mIoU and video
consistency, the COCO instance results) and `data/rle.py` on the same
inputs as `video_knet_tpu/eval` and `data/rle.py`:
- every case of `tests/test_metrics.py` (perfect match, IoU threshold, void
  discount, ignored prediction, window concat, STQ perfect, id switch, DSTQ
  depth, mIoU, video consistency), with that file's expected values;
- seeded synthetic sequences (`tools/eval_check.py`: things with persistent
  track ids, one leaving and one entering, a crowd, stuff, void) at 64x96
  and 384x1248, with depth maps, scored by every metric;
- the trained tiny model's golden maps (`tests/golden/serving_trained_
  tiny_64x96.npz`) against a seeded GT sequence;
- RLE counts and strings, and the COCO results JSON.
Tolerance: integer counts equal; floats within 1e-12 relative (the same
numpy operations in the same order; they come out equal); the JSON equal
byte for byte.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch_port_common  # noqa: F401  (one torch thread)

from video_knet_tpu.data import rle as jrle
from video_knet_tpu.eval import coco_instance as jcoco
from video_knet_tpu.eval import miou as jmiou
from video_knet_tpu.eval import stq as jstq
from video_knet_tpu.eval import vpq as jvpq
from video_knet_tpu_torch.data import rle as trle
from video_knet_tpu_torch.eval import coco_instance as tcoco
from video_knet_tpu_torch.tools import eval_check as ec

JAX = SimpleNamespace(vpq=jvpq, stq=jstq, miou=jmiou)
PORT = ec.port_metrics()
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "serving_trained_tiny_64x96.npz")
REL = 1e-12


def assert_same(got: dict, want: dict) -> None:
    got, want = ec.flatten(got), ec.flatten(want)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if w.dtype.kind in "iub" or w.dtype == object:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=k)
            ok = ~np.isnan(w)
            scale = max(float(np.abs(w[ok]).max()) if ok.any() else 0.0, 1e-300)
            assert float(np.abs(g[ok] - w[ok]).max(initial=0.0)) <= REL * scale, k


# ------------------------------------------- the cases of tests/test_metrics.py


def _pan(m, cat, ins):
    return cat * m.vpq.MAX_INS + ins


def _encode(sem, ins, shift=16):
    return (np.asarray(sem).astype(np.int64) << shift) + np.asarray(ins).astype(np.int64)


def case_vpq_perfect_match(m):
    gt = np.full((8, 8), _pan(m, 3, 1), np.int64)
    s = m.vpq.vpq_stats(gt, gt, num_cat=5)
    assert s.tp[3] == 1 and s.iou[3] == 1.0 and s.fn.sum() == 0 and s.fp.sum() == 0
    return {"stats": s}


def case_vpq_iou_threshold(m):
    gt = np.zeros((10, 10), np.int64) + _pan(m, 1, 1)
    pred = np.zeros((10, 10), np.int64) + _pan(m, 1, 1)
    pred[:, :6] = _pan(m, 1, 2)  # 60 of the GT's 100 pixels: TP; the other 40: FP
    s = m.vpq.vpq_stats(pred, gt, num_cat=3)
    assert (s.tp[1], s.fp[1], s.fn[1]) == (1, 1, 0)
    return {"stats": s}


def case_vpq_void_discount(m):
    gt = np.full((10, 10), 255 * m.vpq.MAX_INS, np.int64)
    gt[:5] = _pan(m, 2, 1)
    pred = np.full((10, 10), _pan(m, 2, 1), np.int64)
    s = m.vpq.vpq_stats(pred, gt, num_cat=5)
    assert s.tp[2] == 1 and s.iou[2] == pytest.approx(1.0)
    return {"stats": s}


def case_vpq_ignored_pred_not_fp(m):
    gt = np.full((10, 10), 255 * m.vpq.MAX_INS, np.int64)
    pred = np.full((10, 10), _pan(m, 1, 7), np.int64)
    s = m.vpq.vpq_stats(pred, gt, num_cat=3)
    assert s.fp.sum() == 0
    return {"stats": s}


def case_window_vpq_concat(m):
    cat = np.ones((4, 4), np.int64)
    ins = np.ones((4, 4), np.int64)
    gt = _pan(m, cat, ins)
    s = m.vpq.window_vpq([cat, cat], [ins, ins], [gt, gt], eval_frames=2, num_cat=3)
    assert s.tp[1] == 1
    res = m.vpq.vpq_from_stats(s, num_classes=2)
    assert res["PQ"] > 0
    return {"stats": s, "res": res}


def case_stq_perfect(m):
    q = m.stq.STQuality(num_classes=3, things_list=[1], ignore_label=255,
                        label_bit_shift=16, offset=2**24)
    sem = np.zeros((8, 8), np.int64)
    sem[:4] = 1
    ins = np.zeros((8, 8), np.int64)
    ins[:4] = 5
    y = _encode(sem, ins)
    q.update_state(y, y, 0)
    q.update_state(y, y, 0)
    r = dict(q.result())
    assert r["AQ"] == pytest.approx(1.0) and r["IoU"] == pytest.approx(1.0)
    assert r["STQ"] == pytest.approx(1.0)
    return r


def case_stq_id_switch(m):
    q = m.stq.STQuality(num_classes=2, things_list=[1], ignore_label=255,
                        label_bit_shift=16, offset=2**24)
    sem = np.ones((4, 4), np.int64)
    gt = _encode(sem, np.full((4, 4), 3))
    q.update_state(gt, _encode(sem, np.full((4, 4), 8)), 0)
    q.update_state(gt, _encode(sem, np.full((4, 4), 9)), 0)  # an id switch
    r = dict(q.result())
    assert r["AQ"] == pytest.approx(0.5) and r["STQ"] == pytest.approx(np.sqrt(0.5))
    return r


def case_dstq_depth(m):
    d = m.stq.DSTQuality(num_classes=2, things_list=[1], ignore_label=255,
                         label_bit_shift=16, offset=2**24, depth_threshold=(1.25, 1.1))
    y = _encode(np.ones((4, 4), np.int64), np.full((4, 4), 1))
    depth_gt = np.full((4, 4), 10.0)
    d.update_state(y, y, depth_gt, depth_gt * 1.2, 0)  # an inlier at 1.25, not at 1.1
    r = dict(d.result())
    assert (r["DQ@1.25"], r["DQ@1.1"]) == (pytest.approx(1.0), pytest.approx(0.0))
    return r


def case_miou(m):
    cm = m.miou.ConfusionMeter(num_classes=3, ignore_label=255)
    cm.update(np.array([[0, 1, 1, 2]]), np.array([[0, 1, 2, 255]]))
    r = cm.result()
    assert r["mIoU"] == pytest.approx((1.0 + 0.5 + 0.0) / 3)
    return r


def case_video_consistency(m):
    gt = [np.ones((4, 4), np.int64)] * 3
    pred = [np.ones((4, 4), np.int64), np.ones((4, 4), np.int64), np.zeros((4, 4), np.int64)]
    r = {f"w{w}": m.miou.video_consistency(pred, gt, window=w) for w in (2, 3, 4)}
    assert r["w2"] == pytest.approx(0.5) and r["w3"] == pytest.approx(0.0)
    assert np.isnan(r["w4"])  # fewer frames than the window
    return r


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_metric_case_matches_jax(case):
    assert_same(CASES[case](PORT), CASES[case](JAX))


# ------------------------------------------------------- seeded sequences


def _depth(hw, n, seed):
    rng = np.random.RandomState(seed)
    true = [np.where(rng.rand(*hw) < 0.1, 0.0, rng.uniform(1, 80, hw)) for _ in range(n)]
    pred = [t * rng.uniform(0.8, 1.3, hw) for t in true]
    return true, pred


@pytest.mark.parametrize("hw,n", [((64, 96), 8), ((384, 1248), 4)], ids=["64x96", "384x1248"])
def test_seeded_sequence_scores_match_jax(hw, n):
    gs, gi = ec.synthetic_sequence(hw, n, seed=0)
    ps, pi = ec.perturb(gs, gi, seed=1)
    depth = _depth(hw, n, seed=2)
    got, _ = ec.score(ps, pi, gs, gi, depth=depth)
    want, _ = ec.score(ps, pi, gs, gi, depth=depth, metrics=JAX)
    assert_same(got, want)
    # the sequence exercises matches and misses, the id switch and the depth
    for k in ("vpq_k1", "vpq_k2"):
        s = got[k]["stats"]
        assert s.tp.sum() > 0 and s.fp.sum() > 0 and s.fn.sum() > 0
    assert 0 < got["stq"]["AQ"] < 1 and 0 < got["stq"]["DSTQ"] < 1
    assert 0 < got["miou"]["mIoU"] < 1


def test_stq_sequences_and_crowd_match_jax():
    """Two sequence ids, interleaved, and the ignore label inside the class
    range (its row of the confusion matrix left out)."""
    gs, gi = ec.synthetic_sequence((32, 48), 6, seed=4)
    ps, pi = ec.perturb(gs, gi, seed=5)
    out = []
    for m in (PORT, JAX):
        q = m.stq.STQuality(20, [11, 13], 19, 16, 2**25)
        for t in range(6):
            g = np.where(gs[t] == 255, 19, gs[t])
            q.update_state(_encode(g, gi[t]), _encode(ps[t], pi[t]), sequence_id=t % 2)
        out.append(dict(q.result()))
    assert_same(*out)
    assert out[0]["ID_per_seq"] == [0, 1] and out[0]["Length_per_seq"] == [3, 3]


def test_golden_maps_score_as_jax():
    """The trained tiny model's served maps (the golden both packages
    reproduce) against a seeded GT of the same size."""
    gold = np.load(GOLDEN)
    n = sum(k.startswith("sem_") for k in gold.files)
    ps = [gold[f"sem_{i}"].astype(np.int32) for i in range(n)]
    pi = [gold[f"trk_{i}"].astype(np.int32) for i in range(n)]
    gs, gi = ec.synthetic_sequence(ps[0].shape, n, seed=3)
    got, _ = ec.score(ps, pi, gs, gi)
    want, _ = ec.score(ps, pi, gs, gi, metrics=JAX)
    assert_same(got, want)


# ------------------------------------------------------------ RLE and COCO


def _masks():
    rng = np.random.RandomState(0)
    out = [np.zeros((5, 7), bool), np.ones((5, 7), bool)]
    m = np.zeros((6, 9), bool)
    m[0, 0] = True  # the first run is of ones
    out.append(m)
    for hw in ((64, 96), (384, 1248)):
        blob = np.zeros(hw, bool)
        for _ in range(5):
            y, x = rng.randint(0, hw[0] - 8), rng.randint(0, hw[1] - 8)
            blob[y:y + rng.randint(2, hw[0] // 2), x:x + rng.randint(2, hw[1] // 2)] = True
        out += [blob, rng.rand(*hw) < 0.5]
    return out


MASKS = _masks()


@pytest.mark.parametrize("i", range(len(MASKS)))
def test_rle_matches_jax_and_round_trips(i):
    m = MASKS[i]
    counts = trle.mask_to_counts(m)
    np.testing.assert_array_equal(counts, jrle.mask_to_counts(m))
    assert counts.dtype == np.int64
    s = trle.counts_to_string(counts)
    assert s == jrle.counts_to_string(counts)
    np.testing.assert_array_equal(trle.string_to_counts(s), jrle.string_to_counts(s))
    rle = trle.encode_mask(m)
    assert rle == jrle.encode_mask(m)
    np.testing.assert_array_equal(trle.decode_mask(rle), m)
    np.testing.assert_array_equal(trle.decode_mask(rle), jrle.decode_mask(rle))
    as_bytes = dict(rle, counts=rle["counts"].encode())
    as_list = dict(rle, counts=counts.tolist())
    for r in (rle, as_bytes, as_list):
        assert trle.rle_area(r) == jrle.rle_area(r) == int(m.sum())
    np.testing.assert_array_equal(trle.decode_mask(as_list), m)


def test_rle_of_an_empty_mask_is_one_zero_run():
    """pycocotools' form (JAX's native encoder gives the same; its numpy
    fallback gives no run at all)."""
    m = np.zeros((0, 4), bool)
    np.testing.assert_array_equal(trle.mask_to_counts(m), [0])
    assert trle.encode_mask(m) == {"size": [0, 4], "counts": "0"}
    assert trle.decode_mask(trle.encode_mask(m)).shape == (0, 4)


def _detections(k=7, hw=(48, 64), seed=0):
    rng = np.random.RandomState(seed)
    probs = rng.rand(k, *hw).astype(np.float32) ** 3
    probs[2] = 0.0  # an empty mask: a zero box
    labels = rng.randint(0, 5, size=k)
    scores = rng.rand(k).astype(np.float32)
    return probs, labels, scores


@pytest.mark.parametrize("score_thr", [0.0, 0.4])
def test_coco_results_match_jax_byte_for_byte(tmp_path, score_thr):
    probs, labels, scores = _detections()
    cat_ids = [1, 3, 7, 9, 11]
    want_b, want_s = jcoco.segm2result(probs, labels, scores, num_classes=5,
                                       score_thr=score_thr)
    for args in ((probs, labels, scores),
                 tuple(torch.from_numpy(np.asarray(x)) for x in (probs, labels, scores))):
        got_b, got_s = tcoco.segm2result(*args, num_classes=5, score_thr=score_thr)
        for g, w in zip(got_b, want_b):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
        assert [len(x) for x in got_s] == [len(x) for x in want_s]
        for g, w in zip(sum(got_s, []), sum(want_s, [])):
            np.testing.assert_array_equal(g, w)
        got = [tcoco.instances_to_coco_json(i, *args, cat_ids, score_thr=score_thr)
               for i in (0, 5)]
        want = [jcoco.instances_to_coco_json(i, probs, labels, scores, cat_ids,
                                             score_thr=score_thr) for i in (0, 5)]
        assert json.dumps(got) == json.dumps(want)
    flat = sum(got, [])
    assert flat
    p_port = tcoco.write_coco_results(flat, str(tmp_path / "port"))
    p_jax = jcoco.write_coco_results(sum(want, []), str(tmp_path / "jax"))
    assert open(p_port, "rb").read() == open(p_jax, "rb").read()
    # every RLE decodes back to its thresholded mask
    kept = [k for k in range(len(scores)) if scores[k] >= score_thr]
    for r, k in zip(got[0], kept):
        np.testing.assert_array_equal(trle.decode_mask(r["segmentation"]), probs[k] > 0.5)
