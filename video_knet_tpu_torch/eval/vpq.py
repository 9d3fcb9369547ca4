"""Video Panoptic Quality (VPQ) over k-frame windows, numpy.

Counterpart of `video_knet_tpu/eval/vpq.py` (the reference's
`tools/eval_dvpq_step.py` vpq_eval and its window loop): the frames of a
window are concatenated along x into one label map; panoptic ids are
`category * MAX_INS + instance`; a (GT, prediction) pair of one category
matches at IoU > 0.5, the prediction's overlap with the void id taken out
of the union; an unmatched prediction that lies more than half inside
ignored GT (category `IGNORE_CAT`) is not a false positive.

Pair statistics come from `np.unique` over one 64-bit key a pixel
(`gt * OFFSET + pred`), in the order JAX's copy walks them, so the sums
are the same floats.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

MAX_INS = 2**16
IGNORE_CAT = 255
OFFSET = 2**30


@dataclass
class VPQStats:
    """Accumulated per-category statistics (index = category id)."""

    num_cat: int = 20
    iou: np.ndarray = field(default=None)  # type: ignore[assignment]
    tp: np.ndarray = field(default=None)  # type: ignore[assignment]
    fn: np.ndarray = field(default=None)  # type: ignore[assignment]
    fp: np.ndarray = field(default=None)  # type: ignore[assignment]

    def __post_init__(self):
        for name in ("iou", "tp", "fn", "fp"):
            if getattr(self, name) is None:
                setattr(self, name, np.zeros(self.num_cat, np.float64))

    def __iadd__(self, other: "VPQStats") -> "VPQStats":
        self.iou += other.iou
        self.tp += other.tp
        self.fn += other.fn
        self.fp += other.fp
        return self


def vpq_stats(pred_ids: np.ndarray, gt_ids: np.ndarray, num_cat: int = 20) -> VPQStats:
    """Match statistics of one (windowed) pair of panoptic id maps
    (category * MAX_INS + instance); GT category IGNORE_CAT is void."""
    pred_ids = np.asarray(pred_ids).astype(np.int64).ravel()
    gt_ids = np.asarray(gt_ids).astype(np.int64).ravel()

    pred_u, pred_areas = np.unique(pred_ids, return_counts=True)
    gt_u, gt_areas = np.unique(gt_ids, return_counts=True)
    pred_area_of = dict(zip(pred_u.tolist(), pred_areas.tolist()))
    gt_area_of = dict(zip(gt_u.tolist(), gt_areas.tolist()))

    keys, inter = np.unique(gt_ids * OFFSET + pred_ids, return_counts=True)
    pair_gt, pair_pred = keys // OFFSET, keys % OFFSET
    pair_gt_cat, pair_pred_cat = pair_gt // MAX_INS, pair_pred // MAX_INS

    # each prediction's overlap with the void id, and with any ignored GT id
    void_rows = pair_gt == IGNORE_CAT * MAX_INS
    void_overlap = dict(zip(pair_pred[void_rows].tolist(), inter[void_rows].tolist()))
    ign_rows = pair_gt_cat == IGNORE_CAT
    ign_overlap: dict[int, int] = {}
    for p, a in zip(pair_pred[ign_rows].tolist(), inter[ign_rows].tolist()):
        ign_overlap[p] = ign_overlap.get(p, 0) + a

    stats = VPQStats(num_cat=num_cat)
    gt_matched: set[int] = set()
    pred_matched: set[int] = set()
    same = pair_gt_cat == pair_pred_cat
    for g, p, a, cat in zip(pair_gt[same].tolist(), pair_pred[same].tolist(),
                            inter[same].tolist(), pair_gt_cat[same].tolist()):
        iou = a / (gt_area_of[g] + pred_area_of[p] - a - void_overlap.get(p, 0))
        if iou > 0.5:
            stats.tp[cat] += 1
            stats.iou[cat] += iou
            gt_matched.add(g)
            pred_matched.add(p)

    for g, cat in zip(gt_u.tolist(), (gt_u // MAX_INS).tolist()):
        if g not in gt_matched and cat != IGNORE_CAT:
            stats.fn[cat] += 1
    for p, area, cat in zip(pred_u.tolist(), pred_areas.tolist(),
                            (pred_u // MAX_INS).tolist()):
        if p not in pred_matched and not ign_overlap.get(p, 0) / area > 0.5:
            stats.fp[cat] += 1
    return stats


def vpq_from_stats(stats: VPQStats, *, num_classes: int = 19,
                   things_index: np.ndarray | None = None) -> dict[str, float | np.ndarray]:
    """PQ / SQ / RQ in percent, over all classes and per class, and PQ over
    things and stuff when `things_index` (a bool mask) is given."""
    eps = 1e-10
    iou, tp = stats.iou[:num_classes], stats.tp[:num_classes]
    fn, fp = stats.fn[:num_classes], stats.fp[:num_classes]
    sq = iou / (tp + eps)
    rq = tp / (tp + 0.5 * fn + 0.5 * fp + eps)
    pq = sq * rq
    out: dict[str, float | np.ndarray] = {
        "PQ": float(pq.mean() * 100),
        "SQ": float(sq.mean() * 100),
        "RQ": float(rq.mean() * 100),
        "PQ_per_class": pq * 100,
        "SQ_per_class": sq * 100,
        "RQ_per_class": rq * 100,
    }
    if things_index is not None:
        out["PQ_th"] = float(pq[things_index].mean() * 100)
        out["PQ_st"] = float(pq[~things_index].mean() * 100)
    return out


def window_vpq(pred_cats: list[np.ndarray], pred_inss: list[np.ndarray],
               gt_pans: list[np.ndarray], *, eval_frames: int = 1,
               num_cat: int = 20) -> VPQStats:
    """VPQ statistics of one sequence summed over its windows of
    `eval_frames` frames. pred_cats / pred_inss: per-frame category and
    instance-id maps; gt_pans: per-frame GT panoptic ids."""
    total = VPQStats(num_cat=num_cat)
    for i in range(len(pred_cats) - eval_frames + 1):
        pred = np.concatenate(
            [np.asarray(pred_cats[j]).astype(np.int64) * MAX_INS
             + np.asarray(pred_inss[j]).astype(np.int64) for j in range(i, i + eval_frames)],
            axis=1)
        gt = np.concatenate(gt_pans[i:i + eval_frames], axis=1)
        total += vpq_stats(pred, gt, num_cat=num_cat)
    return total
