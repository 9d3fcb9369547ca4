"""Seeded synthetic state dicts under the reference's (mmdet's) key names.

The released Video K-Net checkpoints are not in the repository, so the
importers (`utils/torch_import.py:import_torch_knet`) are driven with
state dicts of the release shapes and random values: an image K-Net R-50
(`build_reference_sd`: ResNet-50, FPN, the init head with its localization
FPN, 3 kernel-update stages at C=256, 19 classes, 100 proposals) and the
joint-train Video K-Net's extra keys (`add_joint_train_sd`: the link layers
repeated over every stage, as the reference config writes them, the
detector's embed_fcs / fc_embed and the track head's two fcs). The key set
is that of `tests/test_torch_import.py`'s dicts, which the JAX package's
importer tests use; values are drawn from a `torch.Generator`, small
(0.05 std) so that a 3-stage forward stays finite.
"""

from __future__ import annotations

import torch

C = 256
RESNET50_BLOCKS = {1: (3, 64), 2: (4, 128), 3: (6, 256), 4: (3, 512)}


class _Draw:
    def __init__(self, sd: dict, generator: torch.Generator):
        self.sd, self.gen = sd, generator

    def randn(self, *shape) -> torch.Tensor:
        return torch.randn(*shape, generator=self.gen) * 0.05

    def bn(self, pre: str, c: int) -> None:
        self.sd[pre + ".weight"] = self.randn(c)
        self.sd[pre + ".bias"] = self.randn(c)
        self.sd[pre + ".running_mean"] = self.randn(c)
        self.sd[pre + ".running_var"] = torch.rand(c, generator=self.gen) + 0.5

    def lin(self, pre: str, i: int, o: int, bias: bool = True) -> None:
        self.sd[pre + ".weight"] = self.randn(o, i)
        if bias:
            self.sd[pre + ".bias"] = self.randn(o)

    def ln(self, pre: str, c: int) -> None:
        self.sd[pre + ".weight"] = self.randn(c)
        self.sd[pre + ".bias"] = self.randn(c)

    def convmod(self, pre: str, i: int, o: int, k: int = 3) -> None:
        """mmcv ConvModule with GroupNorm, no conv bias."""
        self.sd[pre + ".conv.weight"] = self.randn(o, i, k, k)
        self.ln(pre + ".gn", o)

    def mha(self, pre: str) -> None:
        self.sd[pre + ".in_proj_weight"] = self.randn(3 * C, C)
        self.sd[pre + ".in_proj_bias"] = self.randn(3 * C)
        self.lin(pre + ".out_proj", C, C)


def resnet50_sd(generator: torch.Generator, prefix: str = "backbone.") -> dict:
    """An mmdet / torchvision ResNet-50 state dict."""
    sd: dict = {}
    b = _Draw(sd, generator)
    sd[prefix + "conv1.weight"] = b.randn(64, 3, 7, 7)
    b.bn(prefix + "bn1", 64)
    for s, (n, w) in RESNET50_BLOCKS.items():
        cin = 64 if s == 1 else w * 2
        for blk in range(n):
            pre = f"{prefix}layer{s}.{blk}"
            in_c = cin if blk == 0 else w * 4
            sd[pre + ".conv1.weight"] = b.randn(w, in_c, 1, 1)
            b.bn(pre + ".bn1", w)
            sd[pre + ".conv2.weight"] = b.randn(w, w, 3, 3)
            b.bn(pre + ".bn2", w)
            sd[pre + ".conv3.weight"] = b.randn(w * 4, w, 1, 1)
            b.bn(pre + ".bn3", w * 4)
            if blk == 0:
                sd[pre + ".downsample.0.weight"] = b.randn(w * 4, in_c, 1, 1)
                b.bn(pre + ".downsample.1", w * 4)
    return sd


def fpn_sd(generator: torch.Generator, in_channels=(256, 512, 1024, 2048),
           prefix: str = "neck.") -> dict:
    """An mmdet 4-level FPN state dict."""
    sd: dict = {}
    b = _Draw(sd, generator)
    for i, cin in enumerate(in_channels):
        sd[f"{prefix}lateral_convs.{i}.conv.weight"] = b.randn(C, cin, 1, 1)
        sd[f"{prefix}lateral_convs.{i}.conv.bias"] = b.randn(C)
        sd[f"{prefix}fpn_convs.{i}.conv.weight"] = b.randn(C, C, 3, 3)
        sd[f"{prefix}fpn_convs.{i}.conv.bias"] = b.randn(C)
    return sd


def build_reference_sd(generator: torch.Generator, num_classes: int = 19,
                       num_stages: int = 3, num_proposals: int = 100) -> dict:
    """An mmdet image K-Net R-50 state dict at the release widths."""
    sd = resnet50_sd(generator)
    sd.update(fpn_sd(generator))
    b = _Draw(sd, generator)
    sd["rpn_head.init_kernels.weight"] = b.randn(num_proposals, C, 1, 1)
    sd["rpn_head.conv_seg.weight"] = b.randn(num_classes, C, 1, 1)
    sd["rpn_head.conv_seg.bias"] = b.randn(num_classes)
    b.convmod("rpn_head.loc_convs.0", C, C, k=1)
    b.convmod("rpn_head.seg_convs.0", C, C, k=1)
    loc = "rpn_head.localization_fpn"
    b.convmod(loc + ".convs_all_levels.0.conv0", C, C)
    for i in range(1, 4):
        for j in range(i):
            b.convmod(loc + f".convs_all_levels.{i}.conv{j}", C, C)
    b.convmod(loc + ".conv_pred", C, C, k=1)
    b.convmod(loc + ".aux_convs.0", C, C, k=1)
    for s in range(num_stages):
        pre = f"roi_head.mask_head.{s}"
        sd[pre + ".feat_transform.conv.weight"] = b.randn(C, C, 1, 1)
        sd[pre + ".feat_transform.conv.bias"] = b.randn(C)
        ku = pre + ".kernel_update_conv"
        b.lin(ku + ".dynamic_layer", C, 2 * C)
        b.lin(ku + ".input_layer", C, 2 * C)
        b.lin(ku + ".input_gate", C, C)
        b.lin(ku + ".update_gate", C, C)
        b.lin(ku + ".fc_layer", C, C)
        for ln in ("norm_in", "norm_out", "input_norm_in", "input_norm_out", "fc_norm"):
            b.ln(f"{ku}.{ln}", C)
        b.mha(pre + ".attention.attn")
        b.ln(pre + ".attention_norm", C)
        b.lin(pre + ".ffn.layers.0.0", C, 2048)
        b.lin(pre + ".ffn.layers.1", 2048, C)
        b.ln(pre + ".ffn_norm", C)
        for br in ("cls_fcs", "mask_fcs"):
            b.lin(f"{pre}.{br}.0", C, C, bias=False)
            b.ln(f"{pre}.{br}.1", C)
        b.lin(pre + ".fc_cls", C, num_classes)
        b.lin(pre + ".fc_mask", C, C)
    return sd


def add_joint_train_sd(sd: dict, generator: torch.Generator, num_stages: int = 3) -> dict:
    """Add a joint-train VPS checkpoint's link and track-embedding keys
    (joint_train.py:114-126, track_heads.py:600-642) to `sd`; returns it."""
    b = _Draw(sd, generator)
    for s in range(num_stages):
        pre = f"roi_head.mask_head.{s}"
        b.mha(pre + ".attention_previous.attn")
        b.ln(pre + ".attention_previous_norm", C)
        b.lin(pre + ".link_ffn.layers.0.0", C, 2048)
        b.lin(pre + ".link_ffn.layers.1", 2048, C)
        b.ln(pre + ".link_ffn_norm", C)
    b.lin("embed_fcs.0", C, C, bias=False)
    b.ln("embed_fcs.1", C)
    b.lin("fc_embed", C, C)
    b.lin("track_head.fcs.0", C, C)
    b.lin("track_head.fcs.1", C, C)
    b.lin("track_head.fc_embed", C, C)
    return sd
