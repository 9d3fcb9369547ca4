"""Alternative host trackers: box-GIoU and mask-IoU association.

Own copy of `video_knet_tpu/models/video/tracker_variants.py`, numpy call
for numpy call, so the ids equal the reference's bit for bit:
`SimpleMaskTracker` (1 - GIoU of the masks' boxes) and `OverlapTracker`
(1 - mask IoU), the CenterTrack-style matchers the reference ships beside
the quasi-dense tracker. Per frame: score filter, a cost matrix against the
live tracks, a linear assignment (`_lsa`: scipy's `linear_sum_assignment`
when it imports, else the same greedy loop as the reference), new ids for
unmatched detections, stale tracks aged out.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from video_knet_tpu_torch.models.video.tracker import masks_to_boxes


def _lsa(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host linear assignment (scipy if present, greedy fallback)."""
    try:
        from scipy.optimize import linear_sum_assignment

        return linear_sum_assignment(cost)
    except Exception:
        rows, cols = [], []
        c = cost.copy()
        for _ in range(min(c.shape)):
            r, col = np.unravel_index(np.argmin(c), c.shape)
            rows.append(r)
            cols.append(col)
            c[r, :] = np.inf
            c[:, col] = np.inf
        return np.asarray(rows), np.asarray(cols)


def generalized_box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GIoU between [N, 4] and [M, 4] xyxy boxes (knet/video/util.py:40)."""
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(br - tl, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.prod(np.clip(a[:, 2:] - a[:, :2], 0, None), axis=1)
    area_b = np.prod(np.clip(b[:, 2:] - b[:, :2], 0, None), axis=1)
    union = area_a[:, None] + area_b[None] - inter
    iou = inter / np.maximum(union, 1e-7)
    etl = np.minimum(a[:, None, :2], b[None, :, :2])
    ebr = np.maximum(a[:, None, 2:], b[None, :, 2:])
    ewh = np.clip(ebr - etl, 0, None)
    enclose = ewh[..., 0] * ewh[..., 1]
    return iou - (enclose - union) / np.maximum(enclose, 1e-7)


def mask_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU between [N, H, W] and [M, H, W] boolean masks."""
    af = a.reshape(a.shape[0], -1).astype(np.float32)
    bf = b.reshape(b.shape[0], -1).astype(np.float32)
    inter = af @ bf.T
    union = af.sum(1)[:, None] + bf.sum(1)[None] - inter
    return inter / np.maximum(union, 1e-7)


@dataclass
class _Track:
    tid: int
    mask: np.ndarray
    score: float
    age: int = 1


@dataclass
class SimpleMaskTracker:
    """Greedy GIoU-of-mask-boxes matcher (knet/video/tracker.py:14)."""

    score_thresh: float = 0.3
    max_age: int = 32
    cost_limit: float = 1.2  # matches with cost above this are rejected
    use_mask_iou: bool = False  # True -> OverlapTracker behavior

    id_count: int = 0
    tracks: list = field(default_factory=list)

    def reset(self):
        self.id_count = 0
        self.tracks = []

    def step(self, masks: np.ndarray, scores: np.ndarray) -> np.ndarray:
        """masks: [N, H, W] binary; scores: [N]. Returns track id per detection
        (0 = filtered out)."""
        ids = np.zeros(len(scores), np.int64)
        keep = np.nonzero(scores >= self.score_thresh)[0]
        dets = [(i, masks[i], float(scores[i])) for i in keep]

        matched_det: dict[int, _Track] = {}
        if dets and self.tracks:
            if self.use_mask_iou:
                cost = 1.0 - mask_iou_matrix(
                    np.stack([d[1] for d in dets]),
                    np.stack([t.mask for t in self.tracks]),
                )
            else:
                det_boxes = masks_to_boxes(np.stack([d[1] for d in dets]))
                trk_boxes = masks_to_boxes(np.stack([t.mask for t in self.tracks]))
                cost = 1.0 - generalized_box_iou(det_boxes, trk_boxes)
            rows, cols = _lsa(cost)
            for r, c in zip(rows, cols):
                if cost[r, c] <= self.cost_limit:
                    matched_det[r] = self.tracks[c]

        new_tracks: list[_Track] = []
        for d, (src, mask, score) in enumerate(dets):
            if d in matched_det:
                t = matched_det[d]
                t.mask, t.score, t.age = mask, score, 1
            else:
                self.id_count += 1
                t = _Track(self.id_count, mask, score)
            ids[src] = t.tid
            new_tracks.append(t)

        # age unmatched tracks; drop stale
        matched_tids = {t.tid for t in new_tracks}
        for t in self.tracks:
            if t.tid not in matched_tids:
                t.age += 1
                if t.age <= self.max_age:
                    new_tracks.append(t)
        self.tracks = new_tracks
        return ids


def OverlapTracker(score_thresh: float = 0.3, max_age: int = 32) -> SimpleMaskTracker:
    """Mask-IoU variant (reference OverlapTracker)."""
    return SimpleMaskTracker(
        score_thresh=score_thresh, max_age=max_age, use_mask_iou=True, cost_limit=0.9
    )
