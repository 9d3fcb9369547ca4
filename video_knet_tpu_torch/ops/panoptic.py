"""Joint-argmax panoptic merge and its host-side formatting.

Counterpart of `video_knet_tpu/ops/panoptic.py` (`merge_joint`,
`segments_to_host`): every pixel goes to the highest score*prob candidate,
and a candidate is kept if it retains >= overlap_thr of its prob>=0.5 area.
Static shapes: per-candidate arrays plus a keep mask.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class PanopticResult(NamedTuple):
    panoptic_seg: torch.Tensor  # [H, W] int32 segment ids (0 = void)
    keep: torch.Tensor  # [K] bool
    seg_ids: torch.Tensor  # [K] int32 segment id per candidate (0 if dropped)
    labels: torch.Tensor  # [K] int32 class labels (thing: [0, T); stuff: [T, C))
    scores: torch.Tensor  # [K] float
    isthing: torch.Tensor  # [K] bool
    areas: torch.Tensor  # [K] int32 (merged area)
    instance_idx: torch.Tensor  # [K] int32 original candidate index


def merge_joint(masks: torch.Tensor, scores: torch.Tensor, labels: torch.Tensor, *,
                num_thing_classes: int, instance_score_thr: float = 0.25,
                overlap_thr: float = 0.6) -> PanopticResult:
    """masks [K, H, W] sigmoid probabilities; scores [K]; labels [K].

    Segment ids are 1-based in descending score order over kept candidates
    (a stable sort, as `jnp.argsort`)."""
    k = masks.shape[0]
    dev = masks.device
    isthing = labels < num_thing_classes
    winner = torch.argmax(scores[:, None, None] * masks, dim=0)  # [H, W], first max

    idx = torch.arange(k, dtype=torch.int32, device=dev)
    claimed = winner[None] == idx[:, None, None]
    mask_area = claimed.sum(dim=(1, 2)).float()
    orig_area = (masks >= 0.5).sum(dim=(1, 2)).float()

    keep = (mask_area > 0) & (orig_area > 0) & (
        mask_area / torch.clamp(orig_area, min=1.0) >= overlap_thr)
    keep = keep & torch.where(isthing, scores >= instance_score_thr, True)

    order = torch.argsort(-scores, stable=True)
    kept_in_order = keep[order]
    rank_in_order = torch.cumsum(kept_in_order.int(), dim=0).int()
    ids_for_ordered = torch.where(kept_in_order, rank_in_order, 0)
    seg_ids = torch.zeros(k, dtype=torch.int32, device=dev)
    seg_ids[order] = ids_for_ordered

    vals = torch.where(keep, seg_ids, 0)
    pan = vals[winner].int()
    return PanopticResult(
        panoptic_seg=pan,
        keep=keep,
        seg_ids=seg_ids,
        labels=labels.int(),
        scores=scores,
        isthing=isthing,
        areas=mask_area.int(),
        instance_idx=idx,
    )


def segments_to_host(res: PanopticResult, num_thing_classes: int) -> tuple[np.ndarray, list[dict]]:
    """(panoptic_seg numpy, segments_info list) from a result of numpy arrays.

    Stuff category_id is reported as (label - num_thing + 1)."""
    keep = np.asarray(res.keep)
    seg_ids = np.asarray(res.seg_ids)
    labels = np.asarray(res.labels)
    scores = np.asarray(res.scores)
    isthing = np.asarray(res.isthing)
    areas = np.asarray(res.areas)
    inst = np.asarray(res.instance_idx)
    infos = []
    for k in np.argsort(-scores):
        if not keep[k]:
            continue
        if isthing[k]:
            infos.append({
                "id": int(seg_ids[k]),
                "isthing": True,
                "score": float(scores[k]),
                "category_id": int(labels[k]),
                "instance_id": int(inst[k]),
            })
        else:
            infos.append({
                "id": int(seg_ids[k]),
                "isthing": False,
                "category_id": int(labels[k]) - num_thing_classes + 1,
                "area": int(areas[k]),
            })
    return np.asarray(res.panoptic_seg), infos
