"""The port's other host trackers against the JAX package, on the CPU.

- `tracker_variants.py` (`SimpleMaskTracker`, `OverlapTracker`, `_lsa`,
  `generalized_box_iou`, `mask_iou_matrix`), `tao_tracker.py` (`TaoTracker`,
  both match metrics) and `unitrack.py` (`MaskAssociationTracker`,
  `KalmanFilter`, `mask_pool_embeddings`): ids bit-equal to the reference's
  on seeded detection sequences with duplicates (tied costs), tied scores,
  an identity that leaves, one that is born, and an empty frame. `_lsa`'s
  two branches are both held: scipy's `linear_sum_assignment`, and the
  greedy loop, forced on both sides by hiding `scipy.optimize`.
- `VPSInferencePipeline` with `tao`, `simple`, `overlap` and `unitrack` (fed
  the same numpy appearance features a frame through `appearance_fn`) on the
  trained tiny model's first frames: integer maps and segments_info
  bit-equal to JAX's pipeline, which shares one compiled frame step across
  the four; `run_sequence` equal to `run_frame`; the multi-stream pipeline
  on the host trackers; an unknown `tracker_type` raises ValueError.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import trained_golden_common as jtg
from torch_port_common import n

from video_knet_tpu.models.video import inference as jinf
from video_knet_tpu.models.video import tao_tracker as jtao
from video_knet_tpu.models.video import tracker_variants as jtv
from video_knet_tpu.models.video import unitrack as jut
from video_knet_tpu.models.video.knet_vps import VideoKNet as JVideoKNet
from video_knet_tpu_torch.models.video import inference as tinf
from video_knet_tpu_torch.models.video import tao_tracker as ttao
from video_knet_tpu_torch.models.video import tracker_variants as ttv
from video_knet_tpu_torch.models.video import unitrack as tut
from video_knet_tpu_torch.tools import trained_golden as tg

MASK_HW = (32, 48)
PIPE_FRAMES = 4
APP_SHAPE = (1, 8, 12, 16)  # appearance features of a 64x96 frame (stride 8)


def _sequence(seed, frames=10, k=7, d=8):
    """Per frame (masks [k, H, W] bool, scores [k], labels [k], embeds
    [k, d]): 5 identities as moving rectangles; identity 4 leaves after frame
    2, identity 3 is born at frame 5; frame 4 is empty; each frame repeats a
    detection exactly (tied costs) and ties two scores."""
    rng = np.random.RandomState(seed)
    h, w = MASK_HW
    ident = rng.randn(5, d).astype(np.float32)
    pos = rng.uniform([0, 0], [h - 12, w - 14], (5, 2))
    vel = rng.randn(5, 2)
    size = rng.randint(6, 12, (5, 2))
    seq = []
    for f in range(frames):
        if f == 4:
            seq.append((np.zeros((0, h, w), bool), np.zeros(0, np.float32),
                        np.zeros(0, np.int64), np.zeros((0, d), np.float32)))
            continue
        alive = [i for i in range(5) if (i != 4 or f <= 2) and (i != 3 or f >= 5)]
        who = rng.choice(alive, size=k)
        masks = np.zeros((k, h, w), bool)
        for j, i in enumerate(who):
            y, x = np.clip(pos[i] + vel[i] * f + rng.randn(2) * 0.7, 0, [h - 2, w - 2]).astype(int)
            masks[j, y:y + size[i, 0], x:x + size[i, 1]] = True
        masks[-1] = masks[0]
        scores = rng.uniform(0.05, 1.0, k).astype(np.float32)
        scores[2] = scores[1]
        embeds = (ident[who] + 0.3 * rng.randn(k, d)).astype(np.float32)
        embeds[-1] = embeds[0]
        seq.append((masks, scores, (who % 2).astype(np.int64), embeds))
    return seq


@pytest.fixture(params=["scipy", "greedy"])
def lsa(request, monkeypatch):
    """`_lsa`'s branch: scipy's solver, or (scipy.optimize hidden, so its
    import fails on both sides) the greedy loop."""
    if request.param == "greedy":
        monkeypatch.setitem(sys.modules, "scipy.optimize", None)
    return request.param


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["simple", "overlap"])
def test_mask_trackers_match_jax(kind, seed, lsa):
    make = {"simple": (jtv.SimpleMaskTracker, ttv.SimpleMaskTracker),
            "overlap": (jtv.OverlapTracker, ttv.OverlapTracker)}[kind]
    jt, tt = make[0](), make[1]()
    kept = 0
    for f, (masks, scores, _, _) in enumerate(_sequence(seed)):
        want, got = jt.step(masks, scores), tt.step(masks, scores)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, f"{kind} frame {f}")
        kept += int(np.sum(want > 0))
    assert (tt.id_count, [t.tid for t in tt.tracks]) == (jt.id_count, [t.tid for t in jt.tracks])
    assert jt.id_count < kept  # some detections continued a track


@pytest.mark.parametrize("seed", [0, 1])
def test_unitrack_matches_jax(seed, lsa):
    jt, tt = jut.MaskAssociationTracker(), tut.MaskAssociationTracker()
    for f, (masks, scores, _, embeds) in enumerate(_sequence(seed)):
        want, got = jt.step(masks, embeds, scores), tt.step(masks, embeds, scores)
        np.testing.assert_array_equal(got, want, f"unitrack frame {f}")
    assert [(t.tid, t.state, t.frames_lost) for t in tt.tracks] == [
        (t.tid, t.state, t.frames_lost) for t in jt.tracks]
    for a, b in zip(tt.tracks, jt.tracks):
        np.testing.assert_array_equal(a.mean, b.mean)
        np.testing.assert_array_equal(a.cov, b.cov)
    assert tt.next_id == jt.next_id > 5  # ids were reused across frames and new ones born


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("metric,with_cosine", [("bisoftmax", True), ("bisoftmax", False),
                                                ("cosine", False)])
def test_tao_tracker_matches_jax(metric, with_cosine, seed):
    kw = dict(match_metric=metric, match_with_cosine=with_cosine, init_score_thr=0.2)
    jt = jtao.TaoTracker(jtao.TaoTrackerConfig(**kw))
    tt = ttao.TaoTracker(ttao.TaoTrackerConfig(**kw))
    kept = 0
    for f, (masks, scores, labels, embeds) in enumerate(_sequence(seed)):
        boxes = np.concatenate([ttv.masks_to_boxes(masks), scores[:, None]], axis=1)
        want = jt.match(boxes, labels, embeds, f)
        got = tt.match(boxes, labels, embeds, f)
        for a, b, what in zip(got, want, ("sel", "labels", "ids")):
            assert a.dtype == b.dtype, what
            np.testing.assert_array_equal(a, b, f"tao frame {f} {what}")
        kept += int(np.sum(want[2] >= 0))
    assert tt.num_tracklets == jt.num_tracklets < kept  # some detections matched a tracklet
    assert sorted(tt.tracklets) == sorted(jt.tracklets)
    for k, v in jt.tracklets.items():
        np.testing.assert_array_equal(tt.tracklets[k]["embed"], v["embed"])


def test_lsa_branches_match_jax(monkeypatch):
    """Tie-heavy costs: scipy's answer, then the greedy loop's, equal."""
    rng = np.random.RandomState(3)
    for shape in ((5, 5), (4, 7), (7, 3)):
        cost = rng.randint(0, 3, shape).astype(np.float64)
        for a, b in zip(ttv._lsa(cost), jtv._lsa(cost)):
            np.testing.assert_array_equal(a, b)
    monkeypatch.setitem(sys.modules, "scipy.optimize", None)
    for shape in ((5, 5), (4, 7), (7, 3)):
        cost = rng.randint(0, 3, shape).astype(np.float64)
        got, want = ttv._lsa(cost), jtv._lsa(cost)
        assert len(got[0]) == min(shape)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    # the greedy loop, not the optimum (which pairs 0-1 and 1-0)
    greedy = ttv._lsa(np.array([[1.0, 2.0], [2.0, 100.0]]))
    assert [list(x) for x in greedy] == [[0, 1], [0, 1]]


def test_box_and_mask_costs_match_jax():
    rng = np.random.RandomState(4)
    a = np.sort(rng.uniform(0, 50, (6, 4)).reshape(6, 2, 2), axis=1).transpose(0, 2, 1)
    b = np.sort(rng.uniform(0, 50, (5, 4)).reshape(5, 2, 2), axis=1).transpose(0, 2, 1)
    a, b = a.reshape(6, 4)[:, [0, 2, 1, 3]], b.reshape(5, 4)[:, [0, 2, 1, 3]]
    np.testing.assert_array_equal(ttv.generalized_box_iou(a, b), jtv.generalized_box_iou(a, b))
    masks = rng.rand(6, 20, 30) > 0.6
    np.testing.assert_array_equal(ttv.mask_iou_matrix(masks, masks[:4]),
                                  jtv.mask_iou_matrix(masks, masks[:4]))


def test_kalman_and_mask_pool_match_jax():
    rng = np.random.RandomState(5)
    jk, tk = jut.KalmanFilter(), tut.KalmanFilter()
    meas = [np.array([20.0, 15.0, 0.7, 12.0]) + rng.randn(4) for _ in range(4)]
    (jm, jc), (tm, tc) = jk.initiate(meas[0]), tk.initiate(meas[0])
    for z in meas[1:]:
        jm, jc = jk.update(*jk.predict(jm, jc), z)
        tm, tc = tk.update(*tk.predict(tm, tc), z)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tc, jc)
    probes = meas[0] + rng.randn(5, 4)
    np.testing.assert_array_equal(tk.gating_distance(tm, tc, probes),
                                  jk.gating_distance(jm, jc, probes))
    feats = rng.randn(8, 12, 16).astype(np.float32)
    masks = rng.rand(5, 32, 48) > 0.7
    masks[2] = False  # an empty mask pools nothing
    np.testing.assert_array_equal(tut.mask_pool_embeddings(feats, masks),
                                  jut.mask_pool_embeddings(feats, masks))


# ------------------------------------------------------------- pipelines


class _Features:
    """appearance_fn: the same seeded numpy features, frame by frame, in both
    packages."""

    def __init__(self):
        self.rng = np.random.RandomState(7)

    def __call__(self, img):
        return self.rng.randn(*APP_SHAPE).astype(np.float32)


@pytest.fixture(scope="module")
def trained():
    jcfg = jtg.tiny_cfg()
    variables = jtg.load_weights()
    jm = JVideoKNet(jcfg, train=False)
    return dict(jcfg=jcfg, jm=jm, variables=variables,
                jstep=jinf.make_frame_step(jm, variables, jcfg, tg.HW, compact_host=True),
                model=tg.tiny_model("cpu"), frames=tg.eval_frames()[:PIPE_FRAMES])


@pytest.mark.parametrize("tracker_type", ["tao", "simple", "overlap", "unitrack"])
def test_pipeline_matches_jax(trained, tracker_type):
    s = trained
    app = tracker_type == "unitrack"
    jpipe = jinf.VPSInferencePipeline(s["jm"], s["variables"], s["jcfg"], out_hw=tg.HW,
                                      tracker_type=tracker_type, step_fn=s["jstep"],
                                      appearance_fn=_Features() if app else None)
    ppipe = tinf.VPSInferencePipeline(s["model"], tg.tiny_cfg(), tg.HW,
                                      tracker_type=tracker_type, device="cpu",
                                      appearance_fn=_Features() if app else None)
    want = jtg.flatten_results([jpipe.run_frame(jnp.asarray(f), i == 0)
                                for i, f in enumerate(s["frames"])])
    results = [ppipe.run_frame(f, i == 0) for i, f in enumerate(s["frames"])]
    got = tg.flatten_results(results)
    for k in want:
        if k.startswith("seg_score_"):
            np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert all(len(np.unique(got[f"trk_{i}"][got[f"trk_{i}"] > 0])) >= 2
               for i in range(PIPE_FRAMES))
    # the window path carries app_feat in the packed payload as run_frame does
    seq_pipe = tinf.VPSInferencePipeline(s["model"], tg.tiny_cfg(), tg.HW,
                                         tracker_type=tracker_type, device="cpu",
                                         appearance_fn=_Features() if app else None)
    seq = tg.flatten_results(list(seq_pipe.run_sequence(s["frames"], window=3)))
    for k in got:
        np.testing.assert_array_equal(seq[k], got[k], err_msg=f"run_sequence {k}")


def test_appearance_features_ride_in_the_payload(trained):
    """With an appearance_fn the unitrack payload carries app_feat; the
    pooled features, not the head's embeddings, reach the tracker."""
    s = trained
    pipe = tinf.VPSInferencePipeline(s["model"], tg.tiny_cfg(), tg.HW, tracker_type="unitrack",
                                     device="cpu", appearance_fn=_Features())
    payload = pipe._step(pipe._to_device(s["frames"][0]), True)
    assert tuple(payload["app_feat"].shape) == APP_SHAPE
    np.testing.assert_array_equal(n(payload["app_feat"]), _Features()(None))


@pytest.mark.parametrize("tracker_type", ["tao", "simple", "overlap", "unitrack"])
def test_multi_stream_host_trackers(trained, tracker_type):
    """Two streams through one batched step: each stream's track maps equal
    a single-stream pipeline's on the same frames, up to the batched
    forward's fp32 rounding (>= 0.95 of pixels, ids the same sets)."""
    s = trained
    frames = s["frames"]
    rounds = [np.concatenate([frames[t], frames[-1 - t]]) for t in range(len(frames))]
    ms = tinf.MultiStreamVPSPipeline(s["model"], tg.tiny_cfg(), tg.HW, 2,
                                     tracker_type=tracker_type, device="cpu")
    multi = [ms.run_frames(r, [t == 0, t == 0]) for t, r in enumerate(rounds)]
    for st in range(2):
        single = tinf.VPSInferencePipeline(s["model"], tg.tiny_cfg(), tg.HW,
                                           tracker_type=tracker_type, device="cpu")
        for t, r in enumerate(rounds):
            one = single.run_frame(r[st:st + 1], t == 0)
            a, b = multi[t][st].track_map, one.track_map
            assert set(np.unique(a)) == set(np.unique(b)), (tracker_type, st, t)
            assert np.mean(a == b) >= 0.95


def test_unknown_tracker_type_raises(trained):
    with pytest.raises(ValueError, match="tracker_type"):
        tinf.VPSInferencePipeline(trained["model"], tg.tiny_cfg(), tg.HW, tracker_type="sort",
                                  device="cpu")
    with pytest.raises(ValueError, match="tracker_type"):
        tinf.MultiStreamVPSPipeline(trained["model"], tg.tiny_cfg(), tg.HW, 2,
                                    tracker_type="sort", device="cpu")
