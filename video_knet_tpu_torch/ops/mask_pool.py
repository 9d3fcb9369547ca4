"""Mask-pooled feature gathering (the K-Net "group feature" op).

Counterpart of `video_knet_tpu/ops/mask_pool.py`. The hard-threshold form
runs the CUDA kernel K1 (`ops/kernels/mask_ops.py:fused_mask_pool`) on the
card; the soft * hard form (`binary=False`) stays plain PyTorch.
"""

from __future__ import annotations

import torch

from video_knet_tpu_torch.ops.kernels.mask_ops import fused_mask_pool


def mask_pool(mask_logits: torch.Tensor, feats: torch.Tensor, *, hard_thr: float = 0.5,
              binary: bool = True) -> torch.Tensor:
    """mask_logits [B, N, H, W]; feats [B, H, W, C] (NHWC) -> [B, N, C]."""
    if binary:
        return fused_mask_pool(mask_logits.contiguous(), feats.contiguous(), hard_thr=hard_thr)
    s = torch.sigmoid(mask_logits.float())
    m = (s > hard_thr).to(feats.dtype) * s.to(feats.dtype)
    return torch.einsum("bnhw,bhwc->bnc", m, feats)
