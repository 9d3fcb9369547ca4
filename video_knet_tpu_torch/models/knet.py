"""Panoptic decode of the K-Net outputs (inference).

Counterpart of `video_knet_tpu/models/knet.py:454-540`: top-k thing
(proposal, class) pairs plus one row per stuff class, sigmoid, optional
rescale, joint-argmax merge. `panoptic_decode_batch` decodes each image of
a batch in turn and stacks the results (the reference vmaps the same
function).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from video_knet_tpu_torch.config import KNetConfig
from video_knet_tpu_torch.models.kernel_iter_head import StageOutput
from video_knet_tpu_torch.models.layers import resize_mask_bilinear, resize_nearest
from video_knet_tpu_torch.ops.panoptic import PanopticResult, merge_joint
from video_knet_tpu_torch.utils.tree import tree_stack


class PanopticPrediction(NamedTuple):
    result: PanopticResult
    thing_kernels: torch.Tensor  # [max_per_img, K*K, C] kernels of the top-k things
    thing_mask_idx: torch.Tensor  # [max_per_img] source proposal of each top-k thing
    seg_preds: torch.Tensor  # [H, W, C] semantic logits


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`lax.top_k` on a 1-D tensor: ties go to the lower index (a stable
    descending sort; `torch.topk` makes no such promise)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def panoptic_decode(rpn_out, stage_outs: list[StageOutput], cfg: KNetConfig,
                    out_hw: tuple[int, int] | None = None) -> PanopticPrediction:
    """Decode of a batch-of-1 forward."""
    last = stage_outs[-1]
    return panoptic_decode_single(
        last.cls_score[0], last.scaled_mask_preds[0], last.object_feats[0],
        rpn_out.seg_preds[0], cfg, out_hw,
    )


def panoptic_decode_batch(rpn_out, stage_outs: list[StageOutput], cfg: KNetConfig,
                          out_hw: tuple[int, int] | None = None) -> PanopticPrediction:
    """Decode of every image of a batch (multi-stream serving); each field
    gains a leading batch axis."""
    last = stage_outs[-1]
    return tree_stack([
        panoptic_decode_single(last.cls_score[i], last.scaled_mask_preds[i],
                               last.object_feats[i], rpn_out.seg_preds[i], cfg, out_hw)
        for i in range(last.cls_score.shape[0])
    ])


def panoptic_decode_single(cls_score_logits: torch.Tensor, mask_preds: torch.Tensor,
                           object_feats: torch.Tensor, seg_preds: torch.Tensor,
                           cfg: KNetConfig,
                           out_hw: tuple[int, int] | None = None) -> PanopticPrediction:
    """cls_score_logits [N_tot, C]; mask_preds [N_tot, Hs, Ws];
    object_feats [N_tot, K*K, C]; seg_preds [h, w, C]."""
    t = cfg.test
    cls_score = torch.sigmoid(cls_score_logits)
    n_prop = cfg.num_proposals
    nt = cfg.num_thing_classes

    thing_scores_full = cls_score[:n_prop, :nt].reshape(-1)
    k_top = min(t.max_per_img, thing_scores_full.shape[0])
    top_scores, top_idx = top_k(thing_scores_full, k_top)
    mask_idx = torch.div(top_idx, nt, rounding_mode="floor")
    thing_labels = (top_idx % nt).int()
    thing_masks = mask_preds[:n_prop][mask_idx]

    stuff_scores = torch.diagonal(cls_score[n_prop:, nt:])
    stuff_labels = nt + torch.arange(cfg.num_stuff_classes, dtype=torch.int32,
                                     device=cls_score.device)
    masks = torch.cat([thing_masks, mask_preds[n_prop:]], dim=0)
    resize = out_hw is not None and tuple(masks.shape[-2:]) != tuple(out_hw)
    upsample_after = resize and t.fast_decode
    if resize and not upsample_after:
        masks = resize_mask_bilinear(masks, tuple(out_hw))
    probs = torch.sigmoid(masks.float())
    scores = torch.cat([top_scores, stuff_scores]).float()
    labels = torch.cat([thing_labels, stuff_labels])

    res = merge_joint(probs, scores, labels, num_thing_classes=nt,
                      instance_score_thr=t.instance_score_thr, overlap_thr=t.overlap_thr)
    if upsample_after:
        res = res._replace(panoptic_seg=resize_nearest(res.panoptic_seg, tuple(out_hw)))
    thing_kernels = object_feats[:n_prop][mask_idx]
    return PanopticPrediction(res, thing_kernels, mask_idx, seg_preds)
