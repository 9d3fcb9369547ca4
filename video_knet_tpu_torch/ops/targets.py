"""Fixed-slot ground truth and the training-target builders.

Counterpart of `video_knet_tpu/ops/targets.py`. Ground truth lives in
fixed slots with validity masks, and every target is a batched tensor op
(no data-dependent shapes, so no host syncs).

Conventions: G thing-instance slots, S stuff classes, N proposals,
N_tot = N + S rows; labels [0, num_thing) are things, [num_thing,
num_classes) stuff, num_classes the background.

The target builders are per pixel, so under the band split of the mesh's
`model` axis they run on the GT's band (`gt_band`) as on the whole map.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from video_knet_tpu_torch.parallel.model_axis import band_slice


class PanopticGT(NamedTuple):
    """Per-batch padded ground truth at mask-assign-stride resolution."""

    masks: torch.Tensor  # [B, G, H, W] float thing instance masks
    labels: torch.Tensor  # [B, G] int32 thing class labels
    valid: torch.Tensor  # [B, G] bool
    instance_ids: torch.Tensor  # [B, G] int32 (-1 where invalid)
    sem_masks: torch.Tensor  # [B, S, H, W] float stuff class masks
    sem_valid: torch.Tensor  # [B, S] bool (stuff class present)


def gt_band(gt: PanopticGT) -> PanopticGT:
    """The GT's masks cut to this rank's band of the rows under the band
    split of the mesh's `model` axis (where JAX's sharded step constrains
    them); `gt` itself otherwise."""
    return gt._replace(masks=band_slice(gt.masks, -2), sem_masks=band_slice(gt.sem_masks, -2))


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, G, ...], idx [B, R] -> x[b, idx[b, r], ...] as [B, R, ...]."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx.long()]


def _first_argmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """`jnp.argmax`: the first index of the maximum (booleans as 0/1)."""
    return torch.argmax(x.to(torch.int32) if x.dtype == torch.bool else x, dim=dim)


def pred_of_gt_from(gt_of_pred: torch.Tensor, num_gt: int) -> torch.Tensor:
    """Invert a [B, N] gt-of-pred assignment to [B, G] pred-of-gt (-1 unmatched)."""
    eq = gt_of_pred[:, :, None] == torch.arange(num_gt, device=gt_of_pred.device)
    idx = _first_argmax(eq, 1).to(torch.int32)
    return torch.where(eq.any(1), idx, torch.full_like(idx, -1))


def _thing_labels(gt_of_pred: torch.Tensor, gt: PanopticGT, background: int) -> torch.Tensor:
    matched = gt_of_pred >= 0
    labels = gather_rows(gt.labels, torch.clamp(gt_of_pred, min=0)).to(torch.int32)
    return torch.where(matched, labels, torch.full_like(labels, background))


def build_stage_label_targets(gt_of_pred: torch.Tensor, gt: PanopticGT, *,
                              num_thing_classes: int, num_stuff_classes: int):
    """(labels [B, N_tot], label_weights [B, N_tot, C], num_pos) of one stage:
    thing rows weigh the thing columns, each stuff row only its own class
    column. The mask losses gather the matched rows instead of dense
    [B, N_tot, H, W] targets."""
    b, n = gt_of_pred.shape
    s = num_stuff_classes
    c = num_thing_classes + s
    dev = gt_of_pred.device
    thing_labels = _thing_labels(gt_of_pred, gt, c)
    thing_lw = torch.cat([torch.ones((b, n, num_thing_classes), device=dev),
                          torch.zeros((b, n, s), device=dev)], dim=-1)
    stuff_cls = num_thing_classes + torch.arange(s, dtype=torch.int32, device=dev)
    stuff_labels = torch.where(gt.sem_valid, stuff_cls[None],
                               torch.full_like(stuff_cls[None], c))
    stuff_lw = torch.cat([torch.zeros((s, num_thing_classes), device=dev),
                          torch.eye(s, device=dev)], dim=-1)[None].expand(b, s, c)
    labels = torch.cat([thing_labels, stuff_labels], dim=1)
    label_weights = torch.cat([thing_lw, stuff_lw], dim=1)
    num_pos = (labels < c).float().sum()
    return labels, label_weights, num_pos


def _owner_map(occupied: torch.Tensor, prio: torch.Tensor, value: torch.Tensor,
               empty: int) -> torch.Tensor:
    """Per pixel, value[b, r] of the occupied row r with the highest prio."""
    sel = _first_argmax(occupied.to(prio.dtype) * prio[..., None, None], 1)  # [B, H, W]
    b = sel.shape[0]
    at = torch.gather(value, 1, sel.reshape(b, -1)).reshape(sel.shape)
    return torch.where(occupied.any(1), at, torch.full_like(at, empty)).to(torch.int32)


def build_rank_target_gathered(rows_t: torch.Tensor, rows_w: torch.Tensor,
                               orig_idx: torch.Tensor, *, ignore_label: int = 255) -> torch.Tensor:
    """Per pixel, the ORIGINAL row index of the highest-original-index
    positive row covering it (later rows overwrite); rows_t [B, R, H, W]
    gathered targets, rows_w [B, R], orig_idx [B, R]."""
    occupied = (rows_t > 0) & (rows_w[..., None, None] > 0)
    prio = torch.where(rows_w > 0, orig_idx.long() + 1, torch.zeros_like(orig_idx.long()))
    return _owner_map(occupied, prio, orig_idx.long(), ignore_label)


def build_semantic_map(gt: PanopticGT, *, num_thing_classes: int, num_classes: int) -> torch.Tensor:
    """Per-pixel class map: stuff slots first, then thing slots, later fills
    overwrite earlier ones; void = num_classes."""
    s = gt.sem_masks.shape[1]
    dev = gt.masks.device
    stuff_cls = num_thing_classes + torch.arange(s, dtype=torch.int32, device=dev)
    all_masks = torch.cat([gt.sem_masks * gt.sem_valid[..., None, None],
                           gt.masks * gt.valid[..., None, None]], dim=1)
    all_labels = torch.cat([stuff_cls[None].expand(gt.sem_valid.shape),
                            gt.labels.to(torch.int32)], dim=1).long()
    m = all_masks.shape[1]
    prio = torch.arange(1, m + 1, device=dev).expand(all_masks.shape[0], m)
    return _owner_map(all_masks > 0, prio, all_labels, num_classes)
