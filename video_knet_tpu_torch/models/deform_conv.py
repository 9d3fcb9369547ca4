"""Deformable convolution (DCNv1), NHWC.

Counterpart of `video_knet_tpu/models/deform_conv.py`: a k x k conv whose
taps are displaced by learned per-pixel offsets. The offsets come from a
zero-initialized k x k conv as (dy, dx) pairs, tap t = i * k + j at
(i - (k-1)/2, j - (k-1)/2); each displaced tap is a bilinear gather with
zero padding outside the map (`ops/sampling.py:bilinear_sample_batch`),
and the tap-weighted sum is one contraction against the weight
[k*k, C, F] (flax's layout, kept as is). Plain PyTorch on every device:
the reference computes this with XLA gathers, outside any Pallas kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from video_knet_tpu_torch.models.layers import Conv2d, _lecun_normal_
from video_knet_tpu_torch.ops.sampling import bilinear_sample_batch


def dcn_sample_points(offsets: torch.Tensor, kernel_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Offsets [B, H, W, 2*k*k] ((dy, dx) pairs) -> the taps' sampling
    coordinates (ys, xs), each [B, H, W, k*k], in the reference's order of
    sums: (pixel + tap) + offset."""
    b, h, w, _ = offsets.shape
    k = kernel_size
    off = offsets.reshape(b, h, w, k * k, 2)
    dev = offsets.device
    r = torch.arange(k, dtype=torch.float32, device=dev) - (k - 1) / 2
    tap_y = r[:, None].expand(k, k).reshape(-1)
    tap_x = r[None, :].expand(k, k).reshape(-1)
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :, None]
    return ys + tap_y + off[..., 0], xs + tap_x + off[..., 1]


class DeformConv2d(nn.Module):
    def __init__(self, in_ch: int, features: int, kernel_size: int = 3):
        super().__init__()
        self.kernel_size = kernel_size
        nk = kernel_size * kernel_size
        self.offset_conv = Conv2d(in_ch, 2 * nk, kernel_size)
        self.weight = nn.Parameter(torch.empty(nk, in_ch, features))
        self.bias = nn.Parameter(torch.empty(features))

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        # the offsets start at zero (the DCN convention); the weight is
        # flax's lecun_normal over fan_in = k*k*C
        self.offset_conv.weight.zero_()
        self.offset_conv.bias.zero_()
        _lecun_normal_(self.weight, self.weight.shape[0] * self.weight.shape[1], generator)
        self.bias.zero_()

    def sample(self, x: torch.Tensor) -> torch.Tensor:
        """The displaced taps of x [B, H, W, C] -> [B, H, W, k*k, C]."""
        ys, xs = dcn_sample_points(self.offset_conv(x), self.kernel_size)
        return bilinear_sample_batch(x, ys, xs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gathered = self.sample(x)
        b, h, w = gathered.shape[:3]
        out = gathered.reshape(b, h, w, -1) @ self.weight.reshape(-1, self.weight.shape[-1])
        return out + self.bias
