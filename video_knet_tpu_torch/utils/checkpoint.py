"""The port's own checkpoints, and importers of reference torch checkpoints.

Counterpart of `video_knet_tpu/utils/checkpoint.py`:
- `save_checkpoint` / `restore_checkpoint`: one `torch.save` file holding
  the model's state_dict, the AdamW and LambdaLR state_dicts
  (`train/optim.py:Optimizer`), the step and, where given, a drop-path
  generator's state; restoring into a built `TrainState` gives back the
  parameters, moments, step and learning rates bit for bit, so a resumed run
  continues as an unbroken one. The reference resumes with mmcv's
  `--resume-from`; the JAX package writes orbax directories, which the port
  does not read (`utils/convert.py` takes a flax variables tree instead).
- `import_torch_resnet`, `import_torch_fpn`, `import_torch_hrnet`: mmdet or
  torchvision ResNets (the backbone, and the UniTrack zoo's ResNet-18/34/50),
  mmdet's FPN and UniTrack's HRNet under the port's module names. Each
  returns {port state_dict key: tensor} for `module.load_state_dict`. The
  layouts are the reference's own: conv OIHW, Linear [out, in], BatchNorm
  weight / bias / running_mean / running_var.
- `load_torch_file`, `image_to_video_params`, `merge_params`: read a
  reference file, move an image K-Net's heads to the video model's names,
  overlay one state dict on another with a shape check.
`utils/torch_import.py:import_torch_knet` maps a whole K-Net state dict
with these.
"""

from __future__ import annotations

import os
import re
from collections.abc import Mapping
from typing import Any

import torch

CHECKPOINT_FILE = "checkpoint.pt"


def save_checkpoint(path: str, state, *, step: int | None = None,
                    generator: torch.Generator | None = None) -> str:
    """Write `state` (a `train_state.TrainState`) to <path>[/step_{step}]/
    checkpoint.pt; returns that directory. The file is written beside its
    final name and renamed into place, so an interrupted save leaves the
    previous checkpoint whole."""
    path = os.path.abspath(path)
    if step is not None:
        path = os.path.join(path, f"step_{step}")
    os.makedirs(path, exist_ok=True)
    blob = {"model": state.model.state_dict(),
            "adamw": state.optimizer.adamw.state_dict(),
            "scheduler": state.optimizer.scheduler.state_dict(),
            "step": int(state.step)}
    if generator is not None:
        blob["generator"] = generator.get_state()
    file = os.path.join(path, CHECKPOINT_FILE)
    torch.save(blob, file + ".tmp")
    os.replace(file + ".tmp", file)
    return path


def restore_checkpoint(path: str, target, *, generator: torch.Generator | None = None):
    """Load the checkpoint in directory `path` into `target` (a built
    `TrainState` whose optimizer covers the same parameters) and, if given,
    `generator`; returns `target`. Tensors go to the devices of the
    target's parameters."""
    blob = torch.load(os.path.join(os.path.abspath(path), CHECKPOINT_FILE),
                      map_location="cpu", weights_only=True)
    target.model.load_state_dict(blob["model"], strict=True)
    target.optimizer.adamw.load_state_dict(blob["adamw"])
    target.optimizer.scheduler.load_state_dict(blob["scheduler"])
    target.step = blob["step"]
    if generator is not None:
        if "generator" not in blob:
            raise KeyError(f"{path}: the checkpoint holds no generator state")
        generator.set_state(blob["generator"])
    return target


class TrackedStateDict(dict):
    """A state dict that records the keys read from it, so that an importer
    can check that a reference checkpoint was consumed whole."""

    def __init__(self, data: Mapping[str, Any], used: set | None = None, prefix: str = ""):
        super().__init__(data)
        self.used: set = used if used is not None else set()
        self.prefix = prefix

    def __getitem__(self, k):
        self.used.add(self.prefix + k)
        return super().__getitem__(k)

    def mark(self, k):
        self.used.add(self.prefix + k)


def _tensor(v) -> torch.Tensor:
    """An owned CPU copy of a checkpoint value, dtype kept."""
    return torch.as_tensor(v).detach().cpu().clone()


def _bn(sd, src: str, dst: str, out: dict) -> None:
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        out[f"{dst}.{leaf}"] = _tensor(sd[f"{src}.{leaf}"])


def import_torch_resnet(state_dict: Mapping[str, Any],
                        prefix: str = "backbone.") -> dict[str, torch.Tensor]:
    """An mmdet (`backbone.layer1.0.conv1.weight`) or torchvision
    (`layer1.0.conv1.weight`) ResNet -> keys of the port's `resnet.ResNet`
    or `appearance.AppearanceResNet` (`layer1_block0.conv1.weight`):
    bottleneck and basic blocks alike, `downsample.{0,1}` ->
    `downsample_{conv,bn}`. Keys read are recorded, under their full names,
    in the caller's `TrackedStateDict` if it is one."""
    used = getattr(state_dict, "used", None)
    sd = TrackedStateDict(
        {k[len(prefix):] if k.startswith(prefix) else k: v for k, v in state_dict.items()},
        used=used if used is not None else set(),
        prefix=prefix if any(k.startswith(prefix) for k in state_dict) else "")
    out = {"conv1.weight": _tensor(sd["conv1.weight"])}
    _bn(sd, "bn1", "bn1", out)
    for key in list(sd):
        m = re.match(r"layer(\d)\.(\d+)\.conv(\d)\.weight$", key)
        if m:
            s, b, c = m.groups()
            out[f"layer{s}_block{b}.conv{c}.weight"] = _tensor(sd[key])
            _bn(sd, f"layer{s}.{b}.bn{c}", f"layer{s}_block{b}.bn{c}", out)
        m = re.match(r"layer(\d)\.(\d+)\.downsample\.0\.weight$", key)
        if m:
            s, b = m.groups()
            out[f"layer{s}_block{b}.downsample_conv.weight"] = _tensor(sd[key])
            _bn(sd, f"layer{s}.{b}.downsample.1", f"layer{s}_block{b}.downsample_bn", out)
    return out


def import_torch_fpn(state_dict: Mapping[str, Any],
                     prefix: str = "neck.") -> dict[str, torch.Tensor]:
    """mmdet's 4-level FPN (`neck.{lateral,fpn}_convs.{i}.conv.*`) -> keys
    of the port's `resnet.FPN` (`lateral{i}.*`, `fpn_conv{i}.*`)."""
    used = getattr(state_dict, "used", None)
    sd = TrackedStateDict({k[len(prefix):]: v for k, v in state_dict.items()
                           if k.startswith(prefix)},
                          used=used if used is not None else set(), prefix=prefix)
    out = {}
    for i in range(4):
        for src, dst in (("lateral_convs", "lateral"), ("fpn_convs", "fpn_conv")):
            for leaf in ("weight", "bias"):
                out[f"{dst}{i}.{leaf}"] = _tensor(sd[f"{src}.{i}.conv.{leaf}"])
    return out


def import_torch_hrnet(state_dict: Mapping[str, Any],
                       prefix: str = "") -> dict[str, torch.Tensor]:
    """UniTrack's HRNet (w18 or w32; the reference's module tree,
    `unitrack/model/hrnet.py`) -> keys of the port's `hrnet.HRNetEncoder`.

    The stem's conv1/bn1/conv2/bn2; `layer1.{b}` Bottlenecks;
    `transition{t}.{i}(.0).{0,1}`; `stage{s}.{m}.branches.{b}.{k}` basic
    blocks; `stage{s}.{m}.fuse_layers.{i}.{j}(.{k}).{0,1}`;
    `incre_modules.{i}.0` and `downsamp_modules.{i}.{0,1}` (conv with bias).
    `final_layer.*` and `classifier.*` are dead in the reference's forward
    and skipped; any other key left over (BatchNorm step counters aside)
    raises, so that a renamed module cannot keep its random init."""
    sd = TrackedStateDict({k[len(prefix):] if k.startswith(prefix) else k: v
                           for k, v in state_dict.items()})
    out: dict[str, torch.Tensor] = {}

    def conv_bn(conv_src: str, bn_src: str, dst: str, bias: bool = False) -> None:
        out[f"{dst}_conv.weight"] = _tensor(sd[conv_src])
        if bias:
            out[f"{dst}_conv.bias"] = _tensor(sd[conv_src.rsplit(".", 1)[0] + ".bias"])
        _bn(sd, bn_src, f"{dst}_bn", out)

    def block(src: str, dst: str, convs: int) -> None:
        for c in range(1, convs + 1):
            out[f"{dst}.conv{c}.weight"] = _tensor(sd[f"{src}.conv{c}.weight"])
            _bn(sd, f"{src}.bn{c}", f"{dst}.bn{c}", out)
        if f"{src}.downsample.0.weight" in sd:
            out[f"{dst}.downsample_conv.weight"] = _tensor(sd[f"{src}.downsample.0.weight"])
            _bn(sd, f"{src}.downsample.1", f"{dst}.downsample_bn", out)

    for c in (1, 2):
        out[f"conv{c}.weight"] = _tensor(sd[f"conv{c}.weight"])
        _bn(sd, f"bn{c}", f"bn{c}", out)
    for b in range(4):
        block(f"layer1.{b}", f"layer1_block{b}", 3)
    conv_bn("transition1.0.0.weight", "transition1.0.1", "transition1_0")
    conv_bn("transition1.1.0.0.weight", "transition1.1.0.1", "transition1_1_0")
    for t in (2, 3):
        conv_bn(f"transition{t}.{t}.0.0.weight", f"transition{t}.{t}.0.1",
                f"transition{t}_{t}_0")
    # stages 2..4: (modules, blocks) = (1, 4), (4, 4), (3, 4)
    for s, (num_modules, num_blocks) in zip((2, 3, 4), ((1, 4), (4, 4), (3, 4))):
        for m in range(num_modules):
            base = f"stage{s}.{m}"
            for b in range(s):
                for k in range(num_blocks):
                    block(f"{base}.branches.{b}.{k}", f"stage{s}_m{m}_b{b}_block{k}", 2)
            for i in range(s):
                for j in range(s):
                    fuse = f"{base}.fuse_layers.{i}.{j}"
                    if j > i:
                        conv_bn(f"{fuse}.0.weight", f"{fuse}.1", f"stage{s}_m{m}_fuse{i}_{j}")
                    for k in range(i - j):
                        conv_bn(f"{fuse}.{k}.0.weight", f"{fuse}.{k}.1",
                                f"stage{s}_m{m}_fuse{i}_{j}_{k}")
    for i in range(4):
        block(f"incre_modules.{i}.0", f"incre{i}_block0", 3)
    for i in range(3):
        conv_bn(f"downsamp_modules.{i}.0.weight", f"downsamp_modules.{i}.1", f"downsamp{i}",
                bias=True)

    leftover = [k for k in sd if k not in sd.used and not k.endswith("num_batches_tracked")
                and not k.startswith(("final_layer.", "classifier."))]
    if leftover:
        raise KeyError(f"unconsumed HRNet checkpoint keys: {leftover[:8]}...")
    return out


def load_torch_file(path: str) -> Mapping[str, Any]:
    """A reference checkpoint's state dict (`state_dict` unwrapped), read
    with `weights_only=True`: tensors and plain containers only."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return obj.get("state_dict", obj)


def image_to_video_params(image_sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """An image K-Net's keys -> the video model's: `roi_head.mask_head_{s}.*`
    becomes `mask_head_{s}.*` (VideoKNet holds its stages at the top); the
    rest keeps its name. The video model's link and track layers are not in
    an image checkpoint and keep their init (the reference's two-phase
    workflow: image pretraining, then `--load-from` into the video model)."""
    return {k[len("roi_head."):] if k.startswith("roi_head.") else k: v
            for k, v in image_sd.items()}


def merge_params(target: Mapping[str, torch.Tensor],
                 imported: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """`target` with `imported`'s entries laid over it; a key both hold must
    keep its shape, or this raises ValueError."""
    out = dict(target)
    for k, v in imported.items():
        if k in out and tuple(out[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {k}: {tuple(out[k].shape)} vs "
                             f"{tuple(v.shape)}")
        out[k] = v
    return out
