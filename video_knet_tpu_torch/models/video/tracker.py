"""QuasiDenseEmbedTracker on the host: online tracklet association in numpy.

Own copy of `video_knet_tpu/models/video/tracker.py`, numpy call for numpy
call, so the ids equal the reference's bit for bit (keep `np.argsort(-scores)`
with its default sort kind: a stable sort can order tied scores otherwise).
Per frame: score sort, IoU duplicate removal, bisoftmax similarity against
the tracklet/backdrop memory, category gating, greedy per-detection argmax
assignment, new-id allocation, EMA memory update and expiry.

It runs on the host between device frame steps (<= 100 things x ~100 memo
entries); the device-side counterpart is `device_tracker.py`.
"""

from __future__ import annotations

import numpy as np

from video_knet_tpu_torch.config import TrackerConfig


def masks_to_boxes(masks: np.ndarray) -> np.ndarray:
    """[N, H, W] binary masks -> [N, 4] xyxy boxes (zeros for empty masks).

    Equivalent of unitrack/utils/mask.py:80 (tensor_mask2box)."""
    n = masks.shape[0]
    boxes = np.zeros((n, 4), np.float32)
    for i in range(n):
        ys, xs = np.nonzero(masks[i])
        if len(ys) == 0:
            continue
        boxes[i] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
    return boxes


def bbox_overlaps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU between [N, 4] and [M, 4] xyxy boxes."""
    if a.shape[0] == 0 or b.shape[0] == 0:
        return np.zeros((a.shape[0], b.shape[0]), np.float32)
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(br - tl, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-6)


class QuasiDenseEmbedTracker:
    def __init__(self, cfg: TrackerConfig):
        self.cfg = cfg
        self.num_tracklets = 0
        self.tracklets: dict[int, dict] = {}
        self.backdrops: list[dict] = []

    @property
    def empty(self) -> bool:
        return not self.tracklets

    def _memo(self):
        embeds, ids, bboxes, labels = [], [], [], []
        for k, v in self.tracklets.items():
            bboxes.append(v["bbox"])
            embeds.append(v["embed"])
            ids.append(k)
            labels.append(v["label"])
        for bd in self.backdrops:
            for i in range(len(bd["embeds"])):
                bboxes.append(bd["bboxes"][i])
                embeds.append(bd["embeds"][i])
                ids.append(-1)
                labels.append(bd["labels"][i])
        return (
            np.asarray(bboxes, np.float32).reshape(-1, 5),
            np.asarray(labels, np.int64),
            np.asarray(embeds, np.float32).reshape(-1, len(embeds[0]) if embeds else 0),
            np.asarray(ids, np.int64),
        )

    def match(
        self,
        bboxes: np.ndarray,  # [N, 5] xyxy + score
        labels: np.ndarray,  # [N]
        embeds: np.ndarray,  # [N, D]
        frame_id: int,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (sel, labels, ids): `sel` indexes the *input* arrays (after
        score sort + IoU dedup) so callers can align masks etc.; id -1 =
        unassigned backdrop, -2 = suppressed low-score duplicate."""
        c = self.cfg
        order = np.argsort(-bboxes[:, -1])
        bboxes, labels, embeds = bboxes[order], labels[order], embeds[order]

        # duplicate removal (quasi_dense_embed_tracker.py:146-156)
        valids = np.ones(len(bboxes), bool)
        ious = bbox_overlaps(bboxes[:, :4], bboxes[:, :4])
        for i in range(1, len(bboxes)):
            thr = c.nms_backdrop_iou_thr if bboxes[i, -1] < c.obj_score_thr else c.nms_class_iou_thr
            if (ious[i, :i] > thr).any():
                valids[i] = False
        sel = order[valids]
        bboxes, labels, embeds = bboxes[valids], labels[valids], embeds[valids]

        ids = np.full(len(bboxes), -1, np.int64)
        if len(bboxes) > 0 and not self.empty:
            memo_bboxes, memo_labels, memo_embeds, memo_ids = self._memo()
            feats = embeds @ memo_embeds.T
            if c.match_metric == "bisoftmax":
                d2t = _softmax(feats, axis=1)
                t2d = _softmax(feats, axis=0)
                scores = (d2t + t2d) / 2.0
            elif c.match_metric == "softmax":
                scores = _softmax(feats, axis=1)
            else:  # cosine
                scores = _l2n(embeds) @ _l2n(memo_embeds).T
            if c.with_cats:
                scores = scores * (labels[:, None] == memo_labels[None, :])
            for i in range(len(bboxes)):
                memo_ind = int(np.argmax(scores[i]))
                conf = scores[i, memo_ind]
                tid = memo_ids[memo_ind]
                if conf > c.match_score_thr:
                    if tid > -1:
                        if bboxes[i, -1] > c.obj_score_thr:
                            ids[i] = tid
                            scores[:i, memo_ind] = 0
                            scores[i + 1 :, memo_ind] = 0
                        elif conf > c.nms_conf_thr:
                            ids[i] = -2
        new = (ids == -1) & (bboxes[:, -1] > c.init_score_thr)
        num_new = int(new.sum())
        ids[new] = np.arange(self.num_tracklets, self.num_tracklets + num_new)
        self.num_tracklets += num_new
        self._update_memo(ids, bboxes, embeds, labels, frame_id)
        return sel, labels, ids

    def _update_memo(self, ids, bboxes, embeds, labels, frame_id):
        c = self.cfg
        for tid, bbox, embed, label in zip(ids, bboxes, embeds, labels):
            if tid <= -1:
                continue
            tid = int(tid)
            if tid in self.tracklets:
                t = self.tracklets[tid]
                t["bbox"] = bbox
                t["embed"] = (1 - c.memo_momentum) * t["embed"] + c.memo_momentum * embed
                t["last_frame"] = frame_id
                t["label"] = label
            else:
                self.tracklets[tid] = dict(
                    bbox=bbox, embed=embed.copy(), label=label, last_frame=frame_id
                )
        # backdrops: unmatched detections not overlapping earlier ones
        bd_inds = [i for i in range(len(ids)) if ids[i] == -1]
        ious = bbox_overlaps(bboxes[bd_inds, :4] if bd_inds else np.zeros((0, 4)), bboxes[:, :4])
        kept = []
        for row, i in enumerate(bd_inds):
            if not (ious[row, :i] > c.nms_backdrop_iou_thr).any():
                kept.append(i)
        self.backdrops.insert(
            0, dict(bboxes=bboxes[kept], embeds=embeds[kept], labels=labels[kept])
        )
        expired = [
            k for k, v in self.tracklets.items()
            if frame_id - v["last_frame"] >= c.memo_tracklet_frames
        ]
        for k in expired:
            self.tracklets.pop(k)
        if len(self.backdrops) > 1:
            self.backdrops.pop()


def _softmax(x: np.ndarray, axis: int) -> np.ndarray:
    m = x.max(axis=axis, keepdims=True)
    e = np.exp(x - m)
    return e / np.maximum(e.sum(axis=axis, keepdims=True), 1e-12)


def _l2n(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
