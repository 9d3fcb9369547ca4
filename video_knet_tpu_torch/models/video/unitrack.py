"""UniTrack-style baseline tracker: Kalman motion + appearance association.

Own copy of `video_knet_tpu/models/video/unitrack.py`, numpy call for numpy
call, so the ids equal the reference's bit for bit: the tracker of the
"K-Net + UniTrack" comparison row. `MaskAssociationTracker` gates an
appearance cost (1 - cosine of mask-pooled embeddings) with a
constant-velocity Kalman filter over [cx, cy, aspect, h], runs a first
linear assignment on it, a second on mask IoU for the tracked-state
remainder, and manages the track lifecycle (new, lost, removed after
`max_time_lost` frames). `mask_pool_embeddings` pools a frozen appearance
encoder's features (`appearance.py`) under each detection's mask.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from video_knet_tpu_torch.models.video.tracker import masks_to_boxes
from video_knet_tpu_torch.models.video.tracker_variants import _lsa, mask_iou_matrix


class KalmanFilter:
    """Constant-velocity Kalman filter over [cx, cy, aspect, h]."""

    def __init__(self):
        ndim, dt = 4, 1.0
        self.F = np.eye(2 * ndim)
        for i in range(ndim):
            self.F[i, ndim + i] = dt
        self.H = np.eye(ndim, 2 * ndim)
        self.std_weight_pos = 1.0 / 20
        self.std_weight_vel = 1.0 / 160

    def initiate(self, meas: np.ndarray):
        mean = np.zeros(8)
        mean[:4] = meas
        h = meas[3]
        std = np.array(
            [2 * self.std_weight_pos * h] * 2 + [1e-2, 2 * self.std_weight_pos * h]
            + [10 * self.std_weight_vel * h] * 2
            + [1e-5, 10 * self.std_weight_vel * h]
        )
        return mean, np.diag(std**2)

    def predict(self, mean, cov):
        h = mean[3]
        q = np.array(
            [self.std_weight_pos * h] * 2 + [1e-2, self.std_weight_pos * h]
            + [self.std_weight_vel * h] * 2 + [1e-5, self.std_weight_vel * h]
        )
        mean = self.F @ mean
        cov = self.F @ cov @ self.F.T + np.diag(q**2)
        return mean, cov

    def update(self, mean, cov, meas: np.ndarray):
        h = mean[3]
        r = np.array([self.std_weight_pos * h] * 2 + [1e-1, self.std_weight_pos * h])
        S = self.H @ cov @ self.H.T + np.diag(r**2)
        K = cov @ self.H.T @ np.linalg.inv(S)
        innov = meas - self.H @ mean
        mean = mean + K @ innov
        cov = cov - K @ S @ K.T
        return mean, cov

    def gating_distance(self, mean, cov, measurements: np.ndarray) -> np.ndarray:
        """Squared Mahalanobis distance of [M, 4] measurements."""
        h = mean[3]
        r = np.array([self.std_weight_pos * h] * 2 + [1e-1, self.std_weight_pos * h])
        S = self.H @ cov @ self.H.T + np.diag(r**2)
        d = measurements - (self.H @ mean)[None]
        Sinv = np.linalg.inv(S)
        return np.einsum("md,de,me->m", d, Sinv, d)


CHI2_95_4DOF = 9.4877  # gating threshold at 95% for 4 dofs


def _xyxy_to_cyah(box: np.ndarray) -> np.ndarray:
    w = box[2] - box[0]
    h = box[3] - box[1]
    return np.array([box[0] + w / 2, box[1] + h / 2, w / max(h, 1e-6), h])


@dataclass
class _UTrack:
    tid: int
    mean: np.ndarray
    cov: np.ndarray
    embed: np.ndarray
    mask: np.ndarray
    score: float
    state: str = "tracked"  # tracked | lost
    frames_lost: int = 0


@dataclass
class MaskAssociationTracker:
    """Two-round association: appearance (Kalman-gated) then mask IoU."""

    appearance_thresh: float = 0.6  # cost above this rejects an appearance match
    iou_thresh: float = 0.5
    score_thresh: float = 0.3
    max_time_lost: int = 30
    momentum: float = 0.9

    kf: KalmanFilter = field(default_factory=KalmanFilter)
    tracks: list = field(default_factory=list)
    next_id: int = 1

    def reset(self):
        self.tracks = []
        self.next_id = 1

    def _new_track(self, mask, embed, score) -> _UTrack:
        box = masks_to_boxes(mask[None])[0]
        mean, cov = self.kf.initiate(_xyxy_to_cyah(box))
        t = _UTrack(self.next_id, mean, cov, embed.copy(), mask, score)
        self.next_id += 1
        return t

    def step(
        self, masks: np.ndarray, embeds: np.ndarray, scores: np.ndarray
    ) -> np.ndarray:
        """masks: [N, H, W] binary; embeds: [N, D]; scores: [N].
        Returns a track id per detection (0 = below score threshold)."""
        ids = np.zeros(len(scores), np.int64)
        keep = np.nonzero(scores >= self.score_thresh)[0]
        if len(self.tracks):
            for t in self.tracks:
                t.mean, t.cov = self.kf.predict(t.mean, t.cov)

        det_masks = masks[keep]
        det_embeds = embeds[keep]
        det_boxes = masks_to_boxes(det_masks) if len(keep) else np.zeros((0, 4))
        det_meas = np.stack([_xyxy_to_cyah(b) for b in det_boxes]) if len(keep) else (
            np.zeros((0, 4))
        )

        unmatched_d = list(range(len(keep)))
        unmatched_t = list(range(len(self.tracks)))
        matches: list[tuple[int, int]] = []

        # round 1: appearance cost with Kalman gating
        if unmatched_d and unmatched_t:
            emb_t = np.stack([self.tracks[i].embed for i in unmatched_t])
            cost = 1.0 - _cosine(det_embeds, emb_t)
            for col, ti in enumerate(unmatched_t):
                gate = self.kf.gating_distance(
                    self.tracks[ti].mean, self.tracks[ti].cov, det_meas
                )
                cost[gate > CHI2_95_4DOF, col] = 1e5
            rows, cols = _lsa(cost)
            for r, c in zip(rows, cols):
                if cost[r, c] <= self.appearance_thresh:
                    matches.append((r, unmatched_t[c]))
            md = {r for r, _ in matches}
            mt = {t for _, t in matches}
            unmatched_d = [d for d in unmatched_d if d not in md]
            unmatched_t = [t for t in unmatched_t if t not in mt]

        # round 2: mask IoU on the remainder (tracked-state tracks only)
        r2_t = [t for t in unmatched_t if self.tracks[t].state == "tracked"]
        if unmatched_d and r2_t:
            cost = 1.0 - mask_iou_matrix(
                det_masks[unmatched_d],
                np.stack([self.tracks[t].mask for t in r2_t]),
            )
            rows, cols = _lsa(cost)
            add = []
            for r, c in zip(rows, cols):
                if cost[r, c] <= 1.0 - self.iou_thresh:
                    add.append((unmatched_d[r], r2_t[c]))
            matches.extend(add)
            md = {r for r, _ in add}
            mt = {t for _, t in add}
            unmatched_d = [d for d in unmatched_d if d not in md]
            unmatched_t = [t for t in unmatched_t if t not in mt]

        for d, ti in matches:
            t = self.tracks[ti]
            t.mean, t.cov = self.kf.update(t.mean, t.cov, det_meas[d])
            t.embed = self.momentum * t.embed + (1 - self.momentum) * det_embeds[d]
            t.mask = det_masks[d]
            t.score = float(scores[keep[d]])
            t.state = "tracked"
            t.frames_lost = 0
            ids[keep[d]] = t.tid

        for d in unmatched_d:
            t = self._new_track(det_masks[d], det_embeds[d], float(scores[keep[d]]))
            self.tracks.append(t)
            ids[keep[d]] = t.tid

        survivors = []
        matched_t = {ti for _, ti in matches}
        for i, t in enumerate(self.tracks):
            if i in matched_t or t.tid in ids:
                survivors.append(t)
                continue
            t.state = "lost"
            t.frames_lost += 1
            if t.frames_lost <= self.max_time_lost:
                survivors.append(t)
        self.tracks = survivors
        return ids


def _cosine(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    an = a / np.maximum(np.linalg.norm(a, axis=1, keepdims=True), 1e-9)
    bn = b / np.maximum(np.linalg.norm(b, axis=1, keepdims=True), 1e-9)
    return an @ bn.T


def mask_pool_embeddings(feats: np.ndarray, masks: np.ndarray) -> np.ndarray:
    """Mask-averaged appearance embeddings (unitrack/mask.py:22-46).

    feats: [H, W, C] appearance features; masks: [N, h, w] binary (any scale —
    nearest-resized to the feature grid). Returns [N, C] L2-normalized."""
    fh, fw, c = feats.shape
    n = masks.shape[0]
    out = np.zeros((n, c), np.float32)
    ys = np.clip(((np.arange(fh) + 0.5) * masks.shape[1] / fh).astype(int), 0,
                 masks.shape[1] - 1)
    xs = np.clip(((np.arange(fw) + 0.5) * masks.shape[2] / fw).astype(int), 0,
                 masks.shape[2] - 1)
    for i in range(n):
        m = masks[i][ys][:, xs] > 0
        if m.any():
            out[i] = feats[m].mean(0)
    norm = np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-9)
    return out / norm
