"""UniTrack's appearance-model zoo: frozen encoders for mask-pooled
embeddings.

Counterpart of `video_knet_tpu/models/video/appearance.py`. The "K-Net +
UniTrack" baseline associates detections by embeddings pooled from a
separate frozen network over the raw frame, not from the learned track head:

- `AppearanceResNet` 18 / 34 / 50: torchvision's ResNet with UniTrack's
  `modify` (layer3 and layer4 at stride 1, so only layer2 downsamples and
  the map stays at stride 8) and `remove_layers` (layer4 by default);
  BatchNorm on its running statistics. `BasicBlock` pads its 3x3 convs
  explicitly by (1, 1), as torch does; ResNet-50's bottleneck is
  `resnet.py:BottleneckBlock`, whose stride-2 conv pads with XLA's
  asymmetric "SAME" split, as the reference's does.
- `hrnet.HRNetEncoder` w18 / w32.
- `RandomFeatGenerator`: uniform features of shape [N, H/8, W/8, 128],
  drawn from a generator on the input's device that is seeded by a host
  counter, so successive frames differ and every run draws the same ones. Its
  values cannot equal `jax.random.uniform`'s; its shape, range and
  determinism do.

Submodules carry flax's names, so `utils/convert.py` maps the reference's
variables (params and batch_stats) unchanged. `make_appearance_fn` wraps an
encoder as the pipeline's `appearance_fn`: a no-grad forward on the model's
device.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from video_knet_tpu_torch.models.layers import BatchNorm, Conv2d, init_parameters
from video_knet_tpu_torch.models.resnet import BottleneckBlock
from video_knet_tpu_torch.utils.device import resolve_device

# torchvision stage depths
APPEARANCE_STAGE_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3)}
_BASIC_DEPTHS = (18, 34)


class BasicBlock(nn.Module):
    """torchvision's BasicBlock (3x3 + 3x3), NHWC, BatchNorm on running
    statistics; conv1 / bn1 / conv2 / bn2 / downsample_conv / downsample_bn."""

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_ch, features, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv2d(features, features, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(features)
        self.has_downsample = in_ch != features or stride != 1
        if self.has_downsample:
            self.downsample_conv = Conv2d(in_ch, features, 1, stride=stride, bias=False)
            self.downsample_bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = self.downsample_bn(self.downsample_conv(x)) if self.has_downsample else x
        return F.relu(y + residual)


class AppearanceResNet(nn.Module):
    """Frozen ResNet with UniTrack's `modify`; returns the last surviving
    stage's NHWC map."""

    def __init__(self, depth: int = 18, remove_layers: Sequence[str] = ("layer4",)):
        super().__init__()
        blocks = APPEARANCE_STAGE_BLOCKS[depth]
        basic = depth in _BASIC_DEPTHS
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        self.names: list[str] = []
        in_ch = 64
        for s, (w, n_blocks) in enumerate(zip((64, 128, 256, 512), blocks), start=1):
            if f"layer{s}" in remove_layers:
                break
            for b in range(n_blocks):
                # only layer2 downsamples (layer3 / layer4 at stride 1)
                stride = 2 if (b == 0 and s == 2) else 1
                name = f"layer{s}_block{b}"
                block = BasicBlock(in_ch, w, stride) if basic else BottleneckBlock(in_ch, w, stride)
                self.add_module(name, block)
                self.names.append(name)
                in_ch = w if basic else w * 4
        self.out_channels = in_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.max_pool2d(y.permute(0, 3, 1, 2), 3, stride=2, padding=1).permute(0, 2, 3, 1)
        for name in self.names:
            y = getattr(self, name)(y)
        return y


class RandomFeatGenerator(nn.Module):
    """Uniform [0, 1) features [N, round(H / down_factor), round(W /
    down_factor), dim], drawn on the input's device from a generator seeded
    by `counter` (the reference folds it into one fixed key)."""

    def __init__(self, down_factor: int = 8, dim: int = 128):
        super().__init__()
        self.down_factor, self.dim = down_factor, dim
        self.out_channels = dim
        self._gens: dict = {}

    def forward(self, x: torch.Tensor, counter: int = 0) -> torch.Tensor:
        n, h, w = x.shape[:3]
        gen = self._gens.get(x.device)
        if gen is None:
            gen = self._gens[x.device] = torch.Generator(device=x.device)
        gen.manual_seed(int(counter))
        shape = (n, round(h / self.down_factor), round(w / self.down_factor), self.dim)
        return torch.rand(shape, generator=gen, device=x.device, dtype=torch.float32)


def make_appearance_model(model_type: str, *, generator: torch.Generator | None = None,
                          device: str | torch.device | None = None, **kwargs) -> nn.Module:
    """The zoo by name: 'resnet18' / 'resnet34' / 'resnet50', 'hrnet_w18' /
    'hrnet_w32' (any name holding 'hrnet'), 'random'. Weights from
    `generator` (flax's default initializers; seed 0 by default) on `device`
    (CUDA by default), in eval mode."""
    device = resolve_device(device)
    if model_type.startswith("resnet"):
        model = AppearanceResNet(depth=int(model_type[len("resnet"):]), **kwargs)
    elif "hrnet" in model_type:
        from video_knet_tpu_torch.models.video.hrnet import HRNetEncoder

        model = HRNetEncoder(width=int(model_type.rsplit("w", 1)[-1]), **kwargs)
    elif model_type == "random":
        model = RandomFeatGenerator(**kwargs)
    else:
        raise ValueError(f"unknown appearance model_type: {model_type}")
    init_appearance(model, generator)
    return model.eval().to(device)


def init_appearance(model: nn.Module, generator: torch.Generator | None = None) -> nn.Module:
    """Random weights with flax's default initializers (the zoo's
    'random18' / 'random50' rows; the reference's pretrained checkpoints
    are not in the repository)."""
    init_parameters(model, generator if generator is not None
                    else torch.Generator().manual_seed(0))
    return model


def make_appearance_fn(model: nn.Module):
    """fn(img [N, H, W, 3]) -> [N, h, w, C] features: the frozen encoder,
    no-grad, on the model's device (the input is moved there). The random
    generator takes a host counter, so successive frames differ."""
    counter = {"n": 0}
    device = next(iter(model.parameters()), None)
    device = device.device if device is not None else None

    @torch.inference_mode()
    def fn(img) -> torch.Tensor:
        x = torch.as_tensor(img, dtype=torch.float32)
        if device is not None:
            x = x.to(device)
        if isinstance(model, RandomFeatGenerator):
            c = counter["n"]
            counter["n"] += 1
            return model(x, c)
        return model(x)

    return fn
