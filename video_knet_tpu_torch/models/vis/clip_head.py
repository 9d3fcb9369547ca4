"""The clip tracker head of VIS: query fusion, then the clip kernel-update
stages.

Counterpart of `video_knet_tpu/models/vis/clip_head.py`
(`ClipKernelUpdateHead`, `ClipKernelHead`):
- the per-frame kernels [B, T, N, C] merge into N clip kernels, by the mean
  over T or by cross-attention from a learned query against all T*N kernels
  (+ LN + FFN + LN); `direct_tracker` seeds them from the raw init kernels
  instead, the volume head hands them over ready;
- stages 0 .. assign_stages-1 update the CLIP kernels: each frame's features
  are mask-pooled, the mean over T feeds the KernelUpdator, then the kernel
  MHA, the FFN, the cls and mask branches; the new masks are every frame's
  dynamic conv of the shared clip kernels;
- the later stages run PER FRAME: the kernels carry T, no cls branch.

Both contractions run the CUDA kernels on the card, with T folded into the
batch: the mask pool is K1 over [B*T, N, H, W] (then the mean over T), the
mask assembly K2 over the kernels expanded to a contiguous [B*T, N, C], so
K2 writes [B, T, N, H, W] directly.

Under the frame split of the mesh's `model` axis (`parallel/model_axis.py`)
the head takes this rank's frames of each clip ([B, T_r, ...]): the merge
gathers every frame's kernels ([B, T, N, C], never the features), the
clip stages' mean over T is this rank's partial sum, summed over the
`model` group, over the clip's length, and everything on the N clip
kernels runs replicated; K1, K2 and the per-frame stages run on this
rank's frames.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
from torch import nn

from video_knet_tpu_torch.config import KernelUpdateHeadConfig
from video_knet_tpu_torch.models.kernel_iter_head import upscale_masks
from video_knet_tpu_torch.models.kernel_update_head import FOCAL_PRIOR_BIAS
from video_knet_tpu_torch.models.kernel_updator import KernelUpdator
from video_knet_tpu_torch.models.layers import (
    FFN,
    MLP,
    Conv2d,
    MultiHeadAttention,
    resize_mask_bilinear,
)
from video_knet_tpu_torch.ops.kernels.mask_ops import fused_assemble
from video_knet_tpu_torch.ops.mask_pool import mask_pool
from video_knet_tpu_torch.parallel.model_axis import frame_mean, gather_frames, held_share

QUERY_MERGES = ("mean", "attention", "attention_pos")


class ClipStageOutput(NamedTuple):
    cls_score: torch.Tensor | None  # [B, N, C] (None for per-frame stages)
    mask_preds: torch.Tensor  # [B, T, N, H, W]
    scaled_mask_preds: torch.Tensor  # [B, T, N, Hs, Ws]
    object_feats: torch.Tensor  # [B, N, C] (clip) or [B, T, N, C] (per-frame)


def clip_assemble(kernels: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Every frame's dynamic conv: kernels [B, N, C] (shared by the clip) or
    [B, T, N, C]; x [B, T, H, W, C] -> [B, T, N, H, W] logits (K2 over B*T)."""
    b, t, h, w, c = x.shape
    n = kernels.shape[-2]
    if kernels.dim() == 3:
        kernels = kernels[:, None].expand(b, t, n, c)
    out = fused_assemble(kernels.reshape(b * t, n, c).contiguous(),
                         x.reshape(b * t, h, w, c).contiguous())
    # in the inputs' dtype, as JAX's einsum gives it (bf16 training)
    return out.reshape(b, t, n, h, w).to(torch.promote_types(kernels.dtype, x.dtype))


def clip_mask_pool(mask_logits: torch.Tensor, x: torch.Tensor, hard_thr: float) -> torch.Tensor:
    """Every frame's hard mask pool: [B, T, N, H, W] logits, [B, T, H, W, C]
    features -> [B, T, N, C] (K1 over B*T)."""
    b, t, n, h, w = mask_logits.shape
    out = mask_pool(mask_logits.reshape(b * t, n, h, w), x.reshape(b * t, h, w, x.shape[-1]),
                    hard_thr=hard_thr)
    return out.reshape(b, t, n, -1)


class ClipKernelUpdateHead(nn.Module):
    """One clip stage; `per_frame=True`: kernels carry a T axis, no cls.
    The reference's clip stage never reads `conv_kernel_size`: its masks
    are always the K=1 contraction, and so are these."""

    def __init__(self, cfg: KernelUpdateHeadConfig, per_frame: bool = False):
        super().__init__()
        self.cfg = cfg
        self.per_frame = per_frame
        c = cfg.in_channels
        if cfg.feat_transform:
            self.feat_transform = Conv2d(c, c, 1)
        u = cfg.updator
        self.kernel_update_conv = KernelUpdator(u.in_channels, u.feat_channels, u.out_channels)
        self.attention = MultiHeadAttention(c, cfg.num_heads)
        self.attention_norm = nn.LayerNorm(c, eps=1e-5)
        if cfg.with_ffn:
            self.ffn = FFN(c, cfg.feedforward_channels, c)
            self.ffn_norm = nn.LayerNorm(c, eps=1e-5)
        if not per_frame:
            self.cls_fcs = MLP(cfg.num_cls_fcs, c, c)
            self.fc_cls = nn.Linear(c, cfg.num_classes)
        self.mask_fcs = MLP(cfg.num_mask_fcs, c, c)
        self.fc_mask = nn.Linear(c, cfg.out_channels)

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        if not self.per_frame:
            self.fc_cls.bias.fill_(FOCAL_PRIOR_BIAS)

    def forward(self, x: torch.Tensor, proposal_feat: torch.Tensor, mask_preds: torch.Tensor):
        """x [B, T, H, W, C]; proposal_feat [B, N, C] (clip) or [B, T, N, C]
        (per-frame); mask_preds [B, T, N, Hm, Wm].

        Returns (cls_score [B, N, num_classes] or None, new masks
        [B, T, N, H, W], object_feats shaped as proposal_feat)."""
        cfg = self.cfg
        n = proposal_feat.shape[-2]
        if cfg.feat_transform:
            x = self.feat_transform(x)
        h, w, c = x.shape[-3:]
        gather_mask = resize_mask_bilinear(mask_preds, (h, w))
        x_feat = clip_mask_pool(gather_mask, x, cfg.hard_mask_thr)  # [B, T, N, C]
        if not self.per_frame:
            x_feat = frame_mean(x_feat, 1)  # frame fusion (the release config's mean)

        obj_feat = self.kernel_update_conv(x_feat, proposal_feat[..., None, :])[..., 0, :]
        # kernel interaction over the N kernels (frames folded into the batch)
        flat = obj_feat.reshape(-1, n, c)
        flat = self.attention_norm(flat + self.attention(flat, flat))
        obj_feat = flat.reshape(obj_feat.shape)
        if cfg.with_ffn:
            obj_feat = self.ffn_norm(self.ffn(obj_feat))

        cls_score = None if self.per_frame else self.fc_cls(self.cls_fcs(obj_feat))
        mask_kernels = self.fc_mask(self.mask_fcs(obj_feat))
        return cls_score, clip_assemble(mask_kernels, x), obj_feat


class ClipKernelHead(nn.Module):
    """The tracker head: the clip kernels, then `num_stages` clip stages
    (`mask_head_{s}`, per-frame from `assign_stages` on).

    `merge_queries=False` when the kernels come from elsewhere (the
    reference's `direct_tracker` mode, or the volume init head): the
    attention merges then make no parameters, as in flax, where they are
    created only when called."""

    def __init__(self, head_cfg: KernelUpdateHeadConfig, num_stages: int = 3,
                 assign_stages: int = 2, num_proposals: int = 100,
                 query_merge_method: str = "mean", with_mask_init: bool = False,
                 merge_queries: bool = True):
        super().__init__()
        if query_merge_method not in QUERY_MERGES:
            raise ValueError(f"query_merge_method={query_merge_method!r}")
        self.head_cfg = head_cfg
        self.num_stages = num_stages
        self.assign_stages = assign_stages
        self.query_merge_method = query_merge_method
        self.with_mask_init = with_mask_init
        c = head_cfg.in_channels
        self.attention_merge = merge_queries and query_merge_method != "mean"
        if self.attention_merge:
            self.init_query = nn.Parameter(torch.empty(num_proposals, c))
            if query_merge_method == "attention_pos":
                self.query_pos = nn.Parameter(torch.empty(num_proposals, c))
            self.query_merge_attn = MultiHeadAttention(c, 8)
            self.query_merge_norm = nn.LayerNorm(c, eps=1e-5)
            self.query_merge_ffn = FFN(c, c * 8, c)
            self.query_merge_ffn_norm = nn.LayerNorm(c, eps=1e-5)
        if with_mask_init:
            self.fc_mask_init = nn.Linear(c, c)
        for s in range(num_stages):
            self.add_module(f"mask_head_{s}",
                            ClipKernelUpdateHead(head_cfg, per_frame=s >= assign_stages))

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        if self.attention_merge:
            self.init_query.normal_(0.0, 1.0, generator=generator)
            if self.query_merge_method == "attention_pos":
                self.query_pos.normal_(0.0, 1.0, generator=generator)

    def _merge(self, per_frame_kernels: torch.Tensor) -> torch.Tensor:
        """[B, T, N, C] per-frame kernels -> [B, N, C] clip kernels (every
        frame's: under the frame split, gathered over the `model` group)."""
        per_frame_kernels = gather_frames(per_frame_kernels)
        if not self.attention_merge:
            return per_frame_kernels.mean(dim=1)
        b, t, n, c = per_frame_kernels.shape
        kv = per_frame_kernels.reshape(b, t * n, c)
        q = self.init_query[None].expand(b, -1, -1)
        if self.query_merge_method == "attention_pos":
            q = q + self.query_pos[None]
            kv = kv + self.query_pos.repeat(t, 1)[None]
        fused = self.query_merge_norm(self.query_merge_attn(q, kv))
        return self.query_merge_ffn_norm(self.query_merge_ffn(fused))

    def forward(self, x: torch.Tensor, per_frame_kernels: torch.Tensor | None,
                mask_preds: torch.Tensor, direct_kernels: torch.Tensor | None = None,
                clip_kernels: torch.Tensor | None = None) -> list[ClipStageOutput]:
        """x [B, T, H, W, C]; per_frame_kernels [B, T, N, C]; mask_preds
        [B, T, N, Hm, Wm], the per-frame final masks; direct_kernels [N, C],
        the raw init kernels (direct_tracker); clip_kernels [B, N, C], ready
        clip kernels (the volume head), which skip the merge. Under the
        frame split T is this rank's frames of each clip, in the outputs
        too."""
        c = self.head_cfg.in_channels
        b, t, n = mask_preds.shape[:3]
        if clip_kernels is not None:
            object_feats = clip_kernels
        elif direct_kernels is not None:
            object_feats = direct_kernels[None].expand(b, n, c)
        else:
            object_feats = self._merge(per_frame_kernels)
        if self.with_mask_init:
            mask_preds = clip_assemble(self.fc_mask_init(object_feats), x)

        outs: list[ClipStageOutput] = []
        for s in range(self.num_stages):
            per_frame = s >= self.assign_stages
            if per_frame and object_feats.dim() == 3:
                object_feats = object_feats[:, None].expand(b, t, n, c)
            # a ReLU decision replayed on this rank's frames is cut to them
            # in a per-frame stage; the clip stages run replicated
            with held_share(frame_axis=1) if per_frame else contextlib.nullcontext():
                cls_score, mask_preds, object_feats = getattr(self, f"mask_head_{s}")(
                    x, object_feats, mask_preds)
            scaled = upscale_masks(mask_preds, self.head_cfg.mask_upsample_stride)
            outs.append(ClipStageOutput(cls_score, mask_preds, scaled, object_feats))
        return outs
