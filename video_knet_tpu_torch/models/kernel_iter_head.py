"""The iterative head's plain stage loop, its per-stage outputs and the mask
upscale.

Counterpart of `video_knet_tpu/models/kernel_iter_head.py` (`StageOutput`,
`upscale_masks`, `KernelIterHead`). `KernelIterHead` is the loop with no
link and no track head (the VIS per-frame K-Net); VPS runs its own loop, with
the link at the last stage, in `models/video/knet_vps.py`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from video_knet_tpu_torch.config import KernelUpdateHeadConfig
from video_knet_tpu_torch.models.kernel_update_head import KernelUpdateHead
from video_knet_tpu_torch.models.layers import resize_mask_bilinear


class StageOutput(NamedTuple):
    cls_score: torch.Tensor  # [B, N_tot, C]
    mask_preds: torch.Tensor  # [B, N_tot, H, W] (feature stride)
    scaled_mask_preds: torch.Tensor  # [B, N_tot, Hs, Ws] (assign stride)
    object_feats: torch.Tensor  # [B, N_tot, K*K, C]


def upscale_masks(mask_preds: torch.Tensor, stride: int) -> torch.Tensor:
    """[..., H, W] -> [..., H * stride, W * stride], bilinear; on a band of
    the image rows with its neighbour rows, as the whole map's
    (`models/layers.py:resize_mask_bilinear`)."""
    if stride <= 1:
        return mask_preds
    h, w = mask_preds.shape[-2:]
    return resize_mask_bilinear(mask_preds, (h * stride, w * stride))


class KernelIterHead(nn.Module):
    """`num_stages` KernelUpdateHeads (`mask_head_{s}`), each fed the
    previous stage's kernels and masks."""

    def __init__(self, head_cfg: KernelUpdateHeadConfig, num_stages: int = 3):
        super().__init__()
        self.head_cfg = head_cfg
        self.num_stages = num_stages
        for s in range(num_stages):
            self.add_module(f"mask_head_{s}", KernelUpdateHead(head_cfg))

    def forward(self, x: torch.Tensor, proposal_feats: torch.Tensor,
                mask_preds: torch.Tensor) -> list[StageOutput]:
        outs = []
        object_feats = proposal_feats
        for s in range(self.num_stages):
            cls_score, mask_preds, object_feats, _ = getattr(self, f"mask_head_{s}")(
                x, object_feats, mask_preds)
            scaled = upscale_masks(mask_preds, self.head_cfg.mask_upsample_stride)
            outs.append(StageOutput(cls_score, mask_preds, scaled, object_feats))
        return outs
