"""TaoTracker: long-tail (TAO-style) tracklet association on the host.

Own copy of `video_knet_tpu/models/video/tao_tracker.py`, numpy call for
numpy call, so the ids equal the reference's bit for bit. What sets it
apart from the quasi-dense tracker (`tracker.py`):

- distractor NMS: only detections below `distractor_score_thr` may be
  suppressed, and only by a same-category detection of lower input index;
- masked-exponential bisoftmax: exp(sims) masked by category before the
  row and column normalizations (denominator + 1e-6), optionally averaged
  with a category-masked cosine matrix;
- an object-score gate on matches (|det score - memo score| below
  `obj_score_diff_thr`), and matched scores blended into the memo's with
  `momentum_obj_score`;
- no backdrop memory; the memo embeddings move by `momentum_embed` towards
  the new embedding, and expire after `memo_frames`.

Per detection the greedy pass takes the row's argmax and zeroes that memo
column for every other detection, in input order, as the reference does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from video_knet_tpu_torch.models.video.tracker import _l2n, bbox_overlaps


@dataclass
class TaoTrackerConfig:
    """Constructor surface of the reference (tao_tracker.py:21-45)."""

    init_score_thr: float = 0.0001
    obj_score_thr: float = 0.0001
    match_score_thr: float = 0.5
    memo_frames: int = 10
    momentum_embed: float = 0.8
    momentum_obj_score: float = 0.5
    obj_score_diff_thr: float = 1.0
    distractor_nms_thr: float = 0.3
    distractor_score_thr: float = 0.5
    match_metric: str = "bisoftmax"  # or 'cosine'
    match_with_cosine: bool = True


class TaoTracker:
    def __init__(self, cfg: TaoTrackerConfig | None = None):
        self.cfg = cfg or TaoTrackerConfig()
        assert self.cfg.match_metric in ("bisoftmax", "cosine")
        self.reset()

    def reset(self):
        self.num_tracklets = 0
        self.tracklets: dict[int, dict] = {}

    @property
    def empty(self) -> bool:
        return not self.tracklets

    def _memo(self):
        ids, bboxes, labels, embeds = [], [], [], []
        for k, v in self.tracklets.items():
            ids.append(k)
            bboxes.append(v["bboxes"][-1])
            labels.append(v["labels"][-1])
            embeds.append(v["embed"])
        d = len(embeds[0]) if embeds else 0
        return (
            np.asarray(bboxes, np.float32).reshape(-1, 5),
            np.asarray(labels, np.int64),
            np.asarray(embeds, np.float32).reshape(-1, d),
            np.asarray(ids, np.int64),
        )

    def match(
        self,
        bboxes: np.ndarray,  # [N, 5] xyxy + score
        labels: np.ndarray,  # [N]
        embeds: np.ndarray,  # [N, D]
        frame_id: int,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (sel, labels, ids). `sel` indexes the INPUT arrays for the
        detections that survive distractor NMS (the reference returns the
        filtered bboxes themselves; indices let callers align masks). id -1 =
        below init_score_thr and unmatched (reference convention)."""
        c = self.cfg
        bboxes = np.asarray(bboxes, np.float32).copy()  # scores are blended
        labels = np.asarray(labels, np.int64)
        embeds = np.asarray(embeds, np.float32)
        n = len(bboxes)

        # distractor NMS (tao_tracker.py:139-148): a low-score detection is
        # dropped if it overlaps an earlier-indexed detection of its category
        valid = np.ones(n, bool)
        low = np.nonzero(bboxes[:, -1] < c.distractor_score_thr)[0]
        if len(low) > 0 and n > 0:
            ious = bbox_overlaps(bboxes[low, :4], bboxes[:, :4])
            ious *= labels[low][:, None] == labels[None, :]
            for row, ind in enumerate(low):
                if (ious[row, :ind] > c.distractor_nms_thr).any():
                    valid[ind] = False
        sel = np.nonzero(valid)[0]
        bboxes, labels, embeds = bboxes[sel], labels[sel], embeds[sel]

        ids = np.full(len(bboxes), -1, np.int64)
        if len(bboxes) > 0 and not self.empty:
            memo_bboxes, memo_labels, memo_embeds, memo_ids = self._memo()
            cat_same = labels[:, None] == memo_labels[None, :]
            if c.match_metric == "bisoftmax":
                # masked exponentials, NOT a stabilized softmax (:157-166)
                exps = np.exp(embeds @ memo_embeds.T) * cat_same
                d2t = exps / (exps.sum(axis=1, keepdims=True) + 1e-6)
                t2d = exps / (exps.sum(axis=0, keepdims=True) + 1e-6)
                scores = (d2t + t2d) / 2.0
                if c.match_with_cosine:
                    cos = (_l2n(embeds) @ _l2n(memo_embeds).T) * cat_same
                    scores = (scores + cos) / 2.0
            else:  # cosine
                scores = (_l2n(embeds) @ _l2n(memo_embeds).T) * cat_same
            for i in range(len(bboxes)):
                if bboxes[i, -1] < c.obj_score_thr:
                    continue
                memo_ind = int(np.argmax(scores[i]))
                conf = scores[i, memo_ind]
                diff = abs(bboxes[i, -1] - memo_bboxes[memo_ind, -1])
                if conf > c.match_score_thr and diff < c.obj_score_diff_thr:
                    ids[i] = memo_ids[memo_ind]
                    scores[:i, memo_ind] = 0
                    scores[i + 1:, memo_ind] = 0
                    m = c.momentum_obj_score
                    bboxes[i, -1] = (
                        m * bboxes[i, -1] + (1 - m) * memo_bboxes[memo_ind, -1]
                    )

        # init new tracklets (:116-124)
        new = (ids == -1) & (bboxes[:, -1] > c.init_score_thr)
        num_new = int(new.sum())
        ids[new] = np.arange(self.num_tracklets, self.num_tracklets + num_new)
        self.num_tracklets += num_new
        self._update_memo(ids, bboxes, labels, embeds, frame_id)
        return sel, labels, ids

    def _update_memo(self, ids, bboxes, labels, embeds, frame_id):
        c = self.cfg
        for tid, bbox, label, embed in zip(ids, bboxes, labels, embeds):
            if tid < 0:
                continue
            tid = int(tid)
            if tid in self.tracklets:
                t = self.tracklets[tid]
                t["bboxes"].append(bbox)
                t["labels"].append(label)
                # momentum on the NEW embedding (tao_tracker.py:79-81)
                t["embed"] = (
                    (1 - c.momentum_embed) * t["embed"] + c.momentum_embed * embed
                )
                t["last_frame"] = frame_id
            else:
                self.tracklets[tid] = dict(
                    bboxes=[bbox], labels=[label], embed=embed.copy(),
                    last_frame=frame_id,
                )
        expired = [
            k for k, v in self.tracklets.items()
            if frame_id - v["last_frame"] >= c.memo_frames
        ]
        for k in expired:
            self.tracklets.pop(k)
