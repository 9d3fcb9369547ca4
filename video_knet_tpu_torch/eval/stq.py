"""Segmentation and Tracking Quality (STQ) and its depth-aware form (DSTQ).

Counterpart of `video_knet_tpu/eval/stq.py` (the reference's
`tools/utils/STQ.py` and `DSTQ.py`, deeplab2's metric): STQ =
sqrt(AQ * IoU), AQ a tube-IoU-weighted association score over the thing
tracks, IoU the semantic confusion matrix's mean IoU; DSTQ multiplies in
the depth inlier rates at thresholds (1.25, 1.1), as a geometric mean.

Labels are `(semantic << label_bit_shift) + instance`. GT instance 0 in a
thing class is a crowd: left out of AQ, and predictions there are not
punished. State is kept per `sequence_id`, in first-seen order.
"""

from __future__ import annotations

from collections import Counter, OrderedDict
from typing import Any, Mapping, Sequence

import numpy as np

_EPS = 1e-15


def _accumulate(counter: Counter, values: np.ndarray) -> None:
    u, c = np.unique(values, return_counts=True)
    counter.update(dict(zip(u.tolist(), c.tolist())))


class STQuality:
    def __init__(self, num_classes: int, things_list: Sequence[int], ignore_label: int,
                 label_bit_shift: int, offset: int):
        self._num_classes = num_classes
        self._things_list = list(things_list)
        self._ignore_label = ignore_label
        self._shift = label_bit_shift
        self._bit_mask = (1 << label_bit_shift) - 1
        self._offset = offset
        if offset < (num_classes << label_bit_shift):
            raise ValueError("offset must be >= num_classes << label_bit_shift "
                             f"({num_classes << label_bit_shift})")
        if ignore_label >= num_classes:
            self._cm_size = num_classes + 1
            self._include = np.arange(num_classes)
        else:
            self._cm_size = num_classes
            self._include = np.array([i for i in range(num_classes) if i != ignore_label])
        self.reset_states()

    def reset_states(self):
        self._confusion: "OrderedDict[Any, np.ndarray]" = OrderedDict()
        self._pred_areas: "OrderedDict[Any, Counter]" = OrderedDict()
        self._gt_areas: "OrderedDict[Any, Counter]" = OrderedDict()
        self._intersections: "OrderedDict[Any, Counter]" = OrderedDict()
        self._seq_len: "OrderedDict[Any, int]" = OrderedDict()

    def update_state(self, y_true: np.ndarray, y_pred: np.ndarray, sequence_id=0):
        y_true = np.asarray(y_true).astype(np.int64)
        y_pred = np.asarray(y_pred).astype(np.int64)
        sem_t, sem_p = y_true >> self._shift, y_pred >> self._shift
        if self._ignore_label > self._num_classes:
            sem_t = np.where(sem_t == self._ignore_label, self._num_classes, sem_t)
            sem_p = np.where(sem_p == self._ignore_label, self._num_classes, sem_p)

        if sequence_id not in self._confusion:
            self._confusion[sequence_id] = np.zeros((self._cm_size, self._cm_size), np.int64)
            self._pred_areas[sequence_id] = Counter()
            self._gt_areas[sequence_id] = Counter()
            self._intersections[sequence_id] = Counter()
            self._seq_len[sequence_id] = 0
        self._seq_len[sequence_id] += 1

        cm_keys = sem_t.ravel() * self._cm_size + sem_p.ravel()
        self._confusion[sequence_id] += np.bincount(
            cm_keys, minlength=self._cm_size * self._cm_size
        ).reshape(self._cm_size, self._cm_size)

        things = np.zeros(self._cm_size + 1, bool)
        things[self._things_list] = True
        t_mask = things[np.minimum(sem_t, self._cm_size)]
        p_mask = things[np.minimum(sem_p, self._cm_size)]
        crowd = t_mask & ((y_true & self._bit_mask) == 0)
        t_mask &= ~crowd
        p_mask &= ~crowd
        _accumulate(self._pred_areas[sequence_id], y_pred[p_mask])
        _accumulate(self._gt_areas[sequence_id], y_true[t_mask])
        both = t_mask & p_mask
        _accumulate(self._intersections[sequence_id],
                    y_true[both] * self._offset + y_pred[both])

    def result(self) -> Mapping[str, Any]:
        ids = list(self._gt_areas)
        n_seq = len(ids)
        aq_per_seq, num_tubes, iou_per_seq = np.zeros(n_seq), np.zeros(n_seq), np.zeros(n_seq)
        removal = np.zeros((self._cm_size, self._cm_size), np.int64)
        removal[self._include, :] = 1
        total_cm = np.zeros((self._cm_size, self._cm_size), np.int64)
        for i, sid in enumerate(ids):
            gt_areas, pred_areas = self._gt_areas[sid], self._pred_areas[sid]
            num_tubes[i] = len(gt_areas)
            outer = 0.0
            for key, tpa in self._intersections[sid].items():
                gt_size = gt_areas[key // self._offset]
                union = pred_areas[key % self._offset] + gt_size - tpa
                outer += (tpa * (tpa / union)) / gt_size
            aq_per_seq[i] = outer

            cm = self._confusion[sid] * removal
            total_cm += cm
            tp = cm.diagonal()
            unions = cm.sum(0) + cm.sum(1) - tp
            iou_per_seq[i] = np.sum(tp / np.maximum(unions, _EPS)) / np.count_nonzero(unions)

        aq_mean = aq_per_seq.sum() / np.maximum(num_tubes.sum(), _EPS)
        aq_per_seq = aq_per_seq / np.maximum(num_tubes, _EPS)
        tp = total_cm.diagonal()
        unions = total_cm.sum(0) + total_cm.sum(1) - tp
        iou_mean = np.sum(tp / np.maximum(unions, _EPS)) / np.count_nonzero(unions)
        return {
            "STQ": float(np.sqrt(aq_mean * iou_mean)),
            "AQ": float(aq_mean),
            "IoU": float(iou_mean),
            "STQ_per_seq": np.sqrt(aq_per_seq * iou_per_seq),
            "AQ_per_seq": aq_per_seq,
            "IoU_per_seq": iou_per_seq,
            "ID_per_seq": ids,
            "Length_per_seq": list(self._seq_len.values()),
        }


class DSTQuality(STQuality):
    """Depth-aware STQ: DSTQ = (STQ^2 * prod(inlier rates))^(1 / (2 + T))."""

    def __init__(self, num_classes: int, things_list: Sequence[int], ignore_label: int,
                 label_bit_shift: int, offset: int,
                 depth_threshold: tuple[float, ...] = (1.25, 1.1)):
        super().__init__(num_classes, things_list, ignore_label, label_bit_shift, offset)
        if not depth_threshold:
            raise ValueError("depth_threshold must be non-empty")
        self._depth_threshold = tuple(depth_threshold)
        self._depth_total: "OrderedDict[Any, int]" = OrderedDict()
        self._depth_inliers: list[OrderedDict] = [OrderedDict() for _ in self._depth_threshold]

    def update_state(self, y_true: np.ndarray, y_pred: np.ndarray,
                     d_true: np.ndarray | None = None, d_pred: np.ndarray | None = None,
                     sequence_id=0):
        super().update_state(y_true, y_pred, sequence_id)
        if d_true is None or d_pred is None:
            return
        d_true, d_pred = np.asarray(d_true), np.asarray(d_pred)
        valid = d_true > 0
        total = int(valid.sum())
        valid &= d_pred > 0
        dt, dp = d_true[valid].astype(np.float64), d_pred[valid].astype(np.float64)
        err = np.maximum(dp / dt, dt / dp)
        for inl, thr in zip(self._depth_inliers, self._depth_threshold):
            inl[sequence_id] = inl.get(sequence_id, 0) + int((err <= thr).sum())
        self._depth_total[sequence_id] = self._depth_total.get(sequence_id, 0) + total

    def result(self) -> Mapping[str, Any]:
        base = dict(super().result())
        totals = np.array(list(self._depth_total.values()), np.float64)
        rates = [np.array([inl.get(s, 0) for s in self._depth_total], np.float64).sum()
                 / np.maximum(totals.sum(), _EPS) for inl in self._depth_inliers]
        base["DSTQ"] = float((base["STQ"] ** 2 * np.prod(rates))
                             ** (1.0 / (2 + len(self._depth_threshold))))
        for thr, r in zip(self._depth_threshold, rates):
            base[f"DQ@{thr}"] = float(r)
        return base
