"""KernelUpdateHead: one stage of iterative kernel refinement, inference forward.

Counterpart of `video_knet_tpu/models/kernel_update_head.py`:
 1. mask-pool features with hard-thresholded sigmoid masks (CUDA kernel K1)
 2. KernelUpdator fuses pooled group features into the kernels
 3. multi-head self-attention over the kernel set + LN
 4. FFN + LN
 5. cls branch (MLP -> fc_cls) and mask branch (MLP -> fc_mask)
 6. new masks = dynamic conv of the kernels against the features
    (K=1: the contraction of CUDA kernel K2, no sigmoid; K>1: a grouped
    convolution, `assemble_masks`)

On a band of the image rows (the band split of the mesh's `model` axis)
steps 1 and 6 (K=1) and the 1x1 `feat_transform` run on the band (K1's
partial sums summed over the `model` group, `ops/mask_pool.py`);
everything on the N x C kernels runs replicated.

The video variant (`with_previous`) links the stage to the previous
frame's kernels, two ways:
- `previous_link` rewrites the INPUT proposal kernels before step 2, so it
  changes the stage's masks: 'link_atten' (cross-attn(query=cur, kv=prev) +
  LN + link FFN + LN), 'update_dynamic_cov' (a KernelUpdator seeded with the
  pooled features updates prev first), or None;
- `previous_type` makes the TRACKING kernels from the updated ones:
  'ffn' (the same cross-link against prev), 'update' (prev updated by a
  KernelUpdator seeded with the pooled features first), 'update_obj' (seeded
  with the updated kernels' tap 0).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from video_knet_tpu_torch.config import KernelUpdateHeadConfig
from video_knet_tpu_torch.models.kernel_updator import KernelUpdator
from video_knet_tpu_torch.models.layers import (
    FFN,
    MLP,
    Conv2d,
    MultiHeadAttention,
    resize_mask_bilinear,
    same_padding,
)
from video_knet_tpu_torch.ops.kernels.mask_ops import fused_assemble
from video_knet_tpu_torch.ops.mask_pool import mask_pool

FOCAL_PRIOR_BIAS = -4.59511985013459  # fc_cls bias init: prior 0.01
PREVIOUS_TYPES = ("ffn", "update", "update_obj")
PREVIOUS_LINKS = (None, "link_atten", "update_dynamic_cov")


def check_kernel_taps(kernels: torch.Tensor, kernel_size: int) -> None:
    """Raise unless kernels [B, N, G, C] carry G = K*K taps: the reference
    reshapes them to [B, N, K, K, C] and fails there otherwise (its init
    head always gives one tap, so a whole model at K > 1 fails)."""
    b, n, g, c = kernels.shape
    if g != kernel_size * kernel_size:
        raise ValueError(
            f"cannot reshape kernels of shape {tuple(kernels.shape)} into shape "
            f"{(b, n, kernel_size, kernel_size, c)} (conv_kernel_size={kernel_size})")


def assemble_masks(kernels: torch.Tensor, x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Dynamic conv of per-image kernels against features.

    kernels [B, N, K*K, C]; x [B, H, W, C] -> [B, N, H, W] logits, in the
    inputs' dtype, as JAX's einsum / convolution gives it (bf16 training).
    K = 1 is the contraction of K2. K > 1 is one grouped convolution with
    the batch folded into the groups, as the reference does it: [1, B*C,
    H, W] against [B*N, C, K, K], groups=B, "SAME" at stride 1, output
    channel b*N + n (cuDNN on the card; the reference's is an XLA
    convolution, not a Pallas kernel)."""
    dtype = torch.promote_types(kernels.dtype, x.dtype)
    if kernel_size == 1:
        return fused_assemble(kernels[:, :, 0, :].contiguous(), x.contiguous()).to(dtype)
    check_kernel_taps(kernels, kernel_size)
    b, n, _, c = kernels.shape
    h, w = x.shape[1:3]
    k = kernel_size
    lhs = x.to(dtype).permute(0, 3, 1, 2).reshape(1, b * c, h, w)
    rhs = kernels.to(dtype).reshape(b, n, k, k, c).permute(0, 1, 4, 2, 3).reshape(b * n, c, k, k)
    (t, bo), (l, r) = same_padding(h, k, 1), same_padding(w, k, 1)
    out = F.conv2d(F.pad(lhs, (l, r, t, bo)), rhs, groups=b)  # [1, B*N, H, W]
    return out.reshape(b, n, h, w)


class KernelUpdateHead(nn.Module):
    def __init__(self, cfg: KernelUpdateHeadConfig, with_previous: bool = False,
                 previous_type: str = "ffn", previous_link: str | None = None):
        super().__init__()
        if previous_type not in PREVIOUS_TYPES:
            raise ValueError(f"previous_type={previous_type!r}")
        if previous_link not in PREVIOUS_LINKS:
            raise ValueError(f"previous_link={previous_link!r}")
        self.cfg = cfg
        self.with_previous = with_previous
        self.previous_type = previous_type
        self.previous_link = previous_link if with_previous else None
        c = cfg.in_channels
        # the kernel attention and the cross links run on the K*K taps flattened
        self.flat_width = cfg.conv_kernel_size ** 2 * c
        if cfg.feat_transform:
            self.feat_transform = Conv2d(c, c, 1)
        u = cfg.updator
        self.kernel_update_conv = KernelUpdator(u.in_channels, u.feat_channels, u.out_channels)
        self.attention = MultiHeadAttention(self.flat_width, cfg.num_heads)
        self.attention_norm = nn.LayerNorm(self.flat_width, eps=1e-5)
        if cfg.with_ffn:
            self.ffn = FFN(c, cfg.feedforward_channels, c)
            self.ffn_norm = nn.LayerNorm(c, eps=1e-5)
        if self.previous_link is not None:
            self._add_cross_link("link")
            if previous_link == "update_dynamic_cov":
                self.link_update_conv = KernelUpdator(u.in_channels, u.feat_channels,
                                                      u.out_channels)
        if with_previous:
            if previous_type != "ffn":
                self.track_update_conv = KernelUpdator(u.in_channels, u.feat_channels,
                                                       u.out_channels)
            self._add_cross_link("previous")
        self.cls_fcs = MLP(cfg.num_cls_fcs, c, c)
        self.mask_fcs = MLP(cfg.num_mask_fcs, c, c)
        self.fc_cls = nn.Linear(c, cfg.num_classes)
        self.fc_mask = nn.Linear(c, cfg.out_channels)

    def _add_cross_link(self, name: str) -> None:
        c, flat = self.cfg.in_channels, self.flat_width
        self.add_module(f"attention_{name}", MultiHeadAttention(flat, self.cfg.num_heads))
        self.add_module(f"attention_{name}_norm", nn.LayerNorm(flat, eps=1e-5))
        self.add_module(f"link_ffn_{name}", FFN(c, self.cfg.feedforward_channels, c))
        self.add_module(f"link_ffn_{name}_norm", nn.LayerNorm(c, eps=1e-5))

    def _cross_link(self, cur: torch.Tensor, prev: torch.Tensor, name: str) -> torch.Tensor:
        """cross-attn(query=cur, kv=prev) + LN + link FFN + LN on [B, N, G, C] kernels."""
        b, n, g, c = cur.shape
        cur_f, prev_f = cur.reshape(b, n, g * c), prev.reshape(b, n, g * c)
        att = getattr(self, f"attention_{name}")(cur_f, prev_f)
        y = getattr(self, f"attention_{name}_norm")(cur_f + att).reshape(b, n, g, c)
        return getattr(self, f"link_ffn_{name}_norm")(getattr(self, f"link_ffn_{name}")(y))

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        self.fc_cls.bias.fill_(FOCAL_PRIOR_BIAS)

    def forward(self, x: torch.Tensor, proposal_feat: torch.Tensor, mask_preds: torch.Tensor,
                previous_obj_feats: torch.Tensor | None = None):
        """x [B, H, W, C]; proposal_feat [B, N, K*K, C]; mask_preds [B, N, Hm, Wm].

        Returns (cls_score [B, N, num_classes], new_mask_preds [B, N, H, W],
        obj_feat [B, N, K*K, C], obj_feat_track or None)."""
        cfg = self.cfg
        b, n = proposal_feat.shape[:2]
        # the reference fails at its mask assembly; the port's attention is
        # sized for K*K taps, so it checks before it runs
        check_kernel_taps(proposal_feat, cfg.conv_kernel_size)
        if cfg.feat_transform:
            x = self.feat_transform(x)
        h, w, c = x.shape[1:]
        gather_mask = resize_mask_bilinear(mask_preds, (h, w))
        x_feat = mask_pool(gather_mask, x, hard_thr=cfg.hard_mask_thr, binary=True)
        linked = self.with_previous and previous_obj_feats is not None

        if linked and self.previous_link is not None:
            prev_in = previous_obj_feats
            if self.previous_link == "update_dynamic_cov":
                prev_in = self.link_update_conv(x_feat, prev_in)
            proposal_feat = self._cross_link(proposal_feat, prev_in, "link")

        obj_feat = self.kernel_update_conv(x_feat, proposal_feat)
        g = obj_feat.shape[2]
        flat = obj_feat.reshape(b, n, g * c)
        flat = self.attention_norm(flat + self.attention(flat, flat))
        obj_feat = flat.reshape(b, n, g, c)
        if cfg.with_ffn:
            obj_feat = self.ffn_norm(self.ffn(obj_feat))

        obj_feat_track = None
        if linked:
            prev_track = previous_obj_feats
            if self.previous_type != "ffn":
                seed = x_feat if self.previous_type == "update" else obj_feat[:, :, 0]
                prev_track = self.track_update_conv(seed, previous_obj_feats)
            obj_feat_track = self._cross_link(obj_feat, prev_track, "previous")

        cls_feat = self.cls_fcs(obj_feat.sum(dim=-2))
        mask_feat = self.mask_fcs(obj_feat)
        cls_score = self.fc_cls(cls_feat)
        mask_kernels = self.fc_mask(mask_feat)
        new_mask_preds = assemble_masks(mask_kernels, x, cfg.conv_kernel_size)
        return cls_score, new_mask_preds, obj_feat, obj_feat_track
