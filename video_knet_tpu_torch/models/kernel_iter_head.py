"""Per-stage outputs of the iterative head and the mask upscale.

Counterpart of `video_knet_tpu/models/kernel_iter_head.py` (`StageOutput`,
`upscale_masks`); the stage loop itself lives in `models/video/knet_vps.py`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from video_knet_tpu_torch.models.layers import resize_mask_bilinear


class StageOutput(NamedTuple):
    cls_score: torch.Tensor  # [B, N_tot, C]
    mask_preds: torch.Tensor  # [B, N_tot, H, W] (feature stride)
    scaled_mask_preds: torch.Tensor  # [B, N_tot, Hs, Ws] (assign stride)
    object_feats: torch.Tensor  # [B, N_tot, K*K, C]


def upscale_masks(mask_preds: torch.Tensor, stride: int) -> torch.Tensor:
    if stride <= 1:
        return mask_preds
    h, w = mask_preds.shape[-2:]
    return resize_mask_bilinear(mask_preds, (h * stride, w * stride))
