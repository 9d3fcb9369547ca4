"""Image K-Net training: batch container, synthetic batches, the loss
function and the train step, on one device or data-parallel.

Counterpart of the step in `tools/train_image.py:198-214` (the reference's
image pretraining on Cityscapes-STEP or COCO panoptic): one `KNet` forward,
`knet_loss`, the backward and the AdamW update, over the CLI's data mesh
as the reference's jit over its mesh (`train/train_state.py`). Scope:
fp32 (`bf16_train` raises: the reference package's image step has no bf16
path) and BatchNorm on its running statistics: `norm_eval=False` raises,
because the reference applies the model with `mutable=False`, where flax
cannot write the batch statistics (it raises `ModifyScopeVariableError`).
"""

from __future__ import annotations

import functools
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
    train_forward,
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


def image_train_forward(model: KNet, img: torch.Tensor, generator: torch.Generator | None):
    return model(img, generator)


def make_image_loss_fn(model: KNet, cfg: KNetConfig, apply=None):
    """loss_fn(batch, generator=None) -> (total, loss_dict); `generator`
    draws the backbone's stochastic depth; `apply(img, generator)` runs the
    forward (the model by default). `check_train_config` first (TF32
    off)."""
    check_train_config(cfg)
    if cfg.bf16_train:
        raise NotImplementedError("bf16_train: the image K-Net step trains in fp32 only, as "
                                  "tools/train_image.py of the JAX package does")
    if not cfg.norm_eval:
        raise NotImplementedError(
            "norm_eval=False: the reference's image step applies the model with "
            "mutable=False, so flax cannot update the BatchNorm statistics there (it raises "
            "ModifyScopeVariableError); the image K-Net trains with norm_eval=True")
    apply = apply or functools.partial(image_train_forward, model)

    def loss_fn(batch: ImageBatch, generator: torch.Generator | None = None):
        rpn_out, stage_outs = apply(batch.img, generator)
        losses = knet_loss(rpn_out, stage_outs, batch.gt, cfg)
        return sum(losses.values()), losses

    return loss_fn


def train_step(state: TrainState, batch: ImageBatch, generator: torch.Generator | None = None):
    """One image train step on the model's device -> (state, loss dict with
    `total_loss`, as device tensors). Over a data mesh `batch` is this
    rank's rows and the losses are the global batch's.

    With `backbone_drop_path_rate` > 0 (the Swin presets) the stochastic
    depth draws from `generator`, by default one on the batch's device
    seeded with the step count (over a mesh, the global batch's draws)."""
    cfg = state.model.cfg
    if generator is None and cfg.backbone_drop_path_rate > 0:
        generator = torch.Generator(device=batch.img.device).manual_seed(state.step)
    return make_train_step(lambda st: make_image_loss_fn(
        st.model, cfg, train_forward(st, image_train_forward)))(state, batch, generator)
