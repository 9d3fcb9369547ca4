"""KernelUpdator: the adaptive kernel update gate block.

Counterpart of `video_knet_tpu/models/kernel_updator.py`, batched over
[B, N] kernels:
  param_in/out   = dynamic_layer(pooled group feature) split in two
  input_in/out   = input_layer(kernel) split in two (per K*K tap)
  gates          = sigmoid(LN(gate_layer(input_in * param_in)))
  fused          = update_gate * LN(param_out) + input_gate * LN(input_out)
  out            = relu(LN(fc_layer(fused)))
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class KernelUpdator(nn.Module):
    def __init__(self, in_channels: int = 256, feat_channels: int = 256,
                 out_channels: int = 256):
        super().__init__()
        f = feat_channels
        self.feat_channels = f
        self.dynamic_layer = nn.Linear(in_channels, 2 * f)
        self.input_layer = nn.Linear(in_channels, 2 * f)
        self.input_gate = nn.Linear(f, f)
        self.update_gate = nn.Linear(f, f)
        self.input_norm_in = nn.LayerNorm(f, eps=1e-5)
        self.norm_in = nn.LayerNorm(f, eps=1e-5)
        self.norm_out = nn.LayerNorm(f, eps=1e-5)
        self.input_norm_out = nn.LayerNorm(f, eps=1e-5)
        self.fc_layer = nn.Linear(f, out_channels)
        self.fc_norm = nn.LayerNorm(out_channels, eps=1e-5)

    def forward(self, update_feature: torch.Tensor, input_feature: torch.Tensor) -> torch.Tensor:
        """update_feature [..., C_in]; input_feature [..., G, C_in] -> [..., G, C_out]."""
        f = self.feat_channels
        params = self.dynamic_layer(update_feature)
        param_in, param_out = params[..., :f], params[..., f:]
        input_feats = self.input_layer(input_feature)
        input_in, input_out = input_feats[..., :f], input_feats[..., f:]

        gate_feats = input_in * param_in[..., None, :]
        input_gate = torch.sigmoid(self.input_norm_in(self.input_gate(gate_feats)))
        update_gate = torch.sigmoid(self.norm_in(self.update_gate(gate_feats)))
        param_out = self.norm_out(param_out)
        input_out = self.input_norm_out(input_out)

        features = update_gate * param_out[..., None, :] + input_gate * input_out
        return F.relu(self.fc_norm(self.fc_layer(features)))
