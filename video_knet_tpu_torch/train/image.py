"""Image K-Net training: batch container, synthetic batches, the loss
function and the single-device train step.

Counterpart of the step in `tools/train_image.py:198-214` (the reference's
image pretraining on Cityscapes-STEP or COCO panoptic): one `KNet` forward,
`knet_loss`, the backward and the AdamW update. Scope: fp32 (`bf16_train`
raises: the reference package's image step has no bf16 path), BatchNorm on
its running statistics (`norm_eval=False` raises), one device (the reference's data-parallel mesh is ROADMAP F7).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from video_knet_tpu_torch.config import KNetConfig
from video_knet_tpu_torch.models.knet import KNet, knet_loss
from video_knet_tpu_torch.ops.targets import PanopticGT
from video_knet_tpu_torch.train.train_state import (
    TrainState,
    check_train_config,
    make_train_step,
)
from video_knet_tpu_torch.train.vps import make_synthetic_gt
from video_knet_tpu_torch.utils.device import resolve_device


class ImageBatch(NamedTuple):
    """img [B, H, W, 3] normalized; gt at mask-assign-stride resolution."""

    img: torch.Tensor
    gt: PanopticGT


def make_synthetic_batch(cfg: KNetConfig, b: int, hw: tuple[int, int], seed: int = 0,
                         device=None) -> ImageBatch:
    """Seeded noise images and `train/vps.py:make_synthetic_gt` at the
    assign stride."""
    device = resolve_device(device)
    h, w = hw
    s = cfg.mask_assign_stride
    rng = np.random.RandomState(seed)
    img = torch.from_numpy(rng.randn(b, h, w, 3).astype(np.float32)).to(device)
    return ImageBatch(img, make_synthetic_gt(cfg, b, (h // s, w // s), seed=seed,
                                             device=device))


def make_image_loss_fn(model: KNet, cfg: KNetConfig):
    """loss_fn(batch, generator=None) -> (total, loss_dict); `generator`
    draws the backbone's stochastic depth. `check_train_config` first (TF32
    off)."""
    check_train_config(cfg)
    if cfg.bf16_train:
        raise NotImplementedError("bf16_train: the image K-Net step trains in fp32 only, as "
                                  "tools/train_image.py of the JAX package does")

    def loss_fn(batch: ImageBatch, generator: torch.Generator | None = None):
        rpn_out, stage_outs = model(batch.img, generator)
        losses = knet_loss(rpn_out, stage_outs, batch.gt, cfg)
        return sum(losses.values()), losses

    return loss_fn


def train_step(state: TrainState, batch: ImageBatch, generator: torch.Generator | None = None):
    """One image train step on the model's device -> (state, loss dict with
    `total_loss`, as device tensors).

    With `backbone_drop_path_rate` > 0 (the Swin presets) the stochastic
    depth draws from `generator`, by default one on the batch's device
    seeded with the step count."""
    cfg = state.model.cfg
    if generator is None and cfg.backbone_drop_path_rate > 0:
        generator = torch.Generator(device=batch.img.device).manual_seed(state.step)
    return make_train_step(make_image_loss_fn(state.model, cfg))(state, batch, generator)
