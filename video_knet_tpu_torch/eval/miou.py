"""Semantic-segmentation mIoU from an accumulated confusion matrix, and
VSPW's video consistency.

Counterpart of `video_knet_tpu/eval/miou.py` (the reference's
`external/dataset/mIoU.py`): per-class IoU from one global confusion matrix
with an ignore label; mVC_k, the share of pixels whose class stays correct
across a k-frame window among those whose GT class stays the same.
"""

from __future__ import annotations

import numpy as np


class ConfusionMeter:
    def __init__(self, num_classes: int, ignore_label: int = 255):
        self.num_classes = num_classes
        self.ignore_label = ignore_label
        self.cm = np.zeros((num_classes, num_classes), np.int64)

    def update(self, pred: np.ndarray, gt: np.ndarray):
        pred, gt = np.asarray(pred), np.asarray(gt)
        valid = gt != self.ignore_label
        keys = gt[valid].astype(np.int64) * self.num_classes + pred[valid].astype(np.int64)
        self.cm += np.bincount(keys, minlength=self.num_classes**2).reshape(
            self.num_classes, self.num_classes)

    def result(self) -> dict:
        tp = self.cm.diagonal().astype(np.float64)
        union = self.cm.sum(0) + self.cm.sum(1) - tp
        present = union > 0
        iou = np.where(present, tp / np.maximum(union, 1e-15), np.nan)
        acc_per_class = tp / np.maximum(self.cm.sum(1), 1e-15)
        return {
            "mIoU": float(np.nanmean(iou)),
            "IoU_per_class": iou,
            "aAcc": float(tp.sum() / max(self.cm.sum(), 1)),
            "mAcc": float(np.nanmean(np.where(present, acc_per_class, np.nan))),
        }


def video_consistency(pred_frames: list[np.ndarray], gt_frames: list[np.ndarray],
                      window: int, ignore_label: int = 255) -> float:
    """VSPW mVC_k: the mean over windows of |pixels correct in every frame
    of the window| / |pixels whose GT class is the same, not ignored, in
    every frame|; NaN when no window has such pixels."""
    scores = []
    for i in range(len(pred_frames) - window + 1):
        gts = np.stack(gt_frames[i:i + window])
        preds = np.stack(pred_frames[i:i + window])
        gt_same = np.all(gts == gts[0], axis=0) & (gts[0] != ignore_label)
        denom = gt_same.sum()
        if denom:
            scores.append(np.all((preds == gts)[:, gt_same], axis=0).sum() / denom)
    return float(np.mean(scores)) if scores else float("nan")
