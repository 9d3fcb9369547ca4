"""VPS training: batch container, synthetic batches, the loss function and
the train step, on one device or data-parallel.

Counterpart of `video_knet_tpu/train/vps.py` (the reference's
`VideoKNetQuansiEmbedFCJointTrain.forward_train` under its trainer): the
joint key + ref forward, every loss, the backward and the AdamW update;
over a mesh (`TrainState.mesh`) it is `make_sharded_train_step`
(`train/train_state.py`): the batch over `data`, and with ranks on the
mesh's `model` axis the image rows split into bands over them (JAX's
`constrain`; `parallel/model_axis.py`): the backbone (ResNet, Swin or MiT),
the FPN, the heads and the loss block run on each rank's band, and each
rank takes its band of the GT masks. Scope: fp32, or a
bf16 forward with `bf16_train` (fp32 masters, optimizer state, gradients
and loss math); BatchNorm on its running statistics, or live with
`norm_eval=False` (fp32; statistics over the 2B images of [ref; key],
updated once a step).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from video_knet_tpu_torch.config import KNetConfig, VideoKNetConfig
from video_knet_tpu_torch.models.video.knet_vps import VideoKNet, video_knet_loss
from video_knet_tpu_torch.ops.targets import PanopticGT, gt_band
from video_knet_tpu_torch.train.train_state import (
    TrainState,
    check_train_config,
    make_train_step,
    train_forward,
)
from video_knet_tpu_torch.utils.device import resolve_device
from video_knet_tpu_torch.utils.precision import bf16_forward
from video_knet_tpu_torch.utils.profiling import span


class VPSBatch(NamedTuple):
    """One key + ref training pair: img / ref_img [B, H, W, 3] normalized;
    gt / ref_gt at mask-assign-stride resolution."""

    img: torch.Tensor
    ref_img: torch.Tensor
    gt: PanopticGT
    ref_gt: PanopticGT


def make_synthetic_gt(cfg: KNetConfig, b: int, hw: tuple[int, int], seed: int = 0,
                      ids_offset: int = 0, device=None) -> PanopticGT:
    """Deterministic synthetic GT, the same numpy draws as the reference's:
    4 thing rectangles, one stuff class over the rest (none when the config
    has no stuff classes)."""
    device = resolve_device(device)
    h, w = hw
    g, s = cfg.max_insts, cfg.num_stuff_classes
    rng = np.random.RandomState(seed)
    masks = np.zeros((b, g, h, w), np.float32)
    n_real = min(4, g)
    for i in range(n_real):
        y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
        masks[:, i, y0:y0 + h // 3, x0:x0 + w // 3] = 1.0
    labels = rng.randint(0, cfg.num_thing_classes, size=(b, g)).astype(np.int32)
    valid = np.zeros((b, g), bool)
    valid[:, :n_real] = True
    ids = np.where(valid, np.arange(g)[None] + ids_offset, -1).astype(np.int32)
    sem = np.zeros((b, s, h, w), np.float32)
    sem_valid = np.zeros((b, s), bool)
    if s:
        sem[:, 0] = 1.0 - masks.max(axis=1)
        sem_valid[:, 0] = True
    return PanopticGT(*(torch.from_numpy(x).to(device)
                        for x in (masks, labels, valid, ids, sem, sem_valid)))


def make_synthetic_batch(cfg: VideoKNetConfig, b: int, hw: tuple[int, int], seed: int = 0,
                         device=None) -> VPSBatch:
    device = resolve_device(device)
    h, w = hw
    s = cfg.mask_assign_stride
    rng = np.random.RandomState(seed)
    img = torch.from_numpy(rng.randn(b, h, w, 3).astype(np.float32)).to(device)
    ref_img = torch.from_numpy(rng.randn(b, h, w, 3).astype(np.float32)).to(device)
    gt = make_synthetic_gt(cfg, b, (h // s, w // s), seed=seed, device=device)
    ref_gt = make_synthetic_gt(cfg, b, (h // s, w // s), seed=seed + 1, device=device)
    return VPSBatch(img, ref_img, gt, ref_gt)


def vps_train_forward(model: VideoKNet, bf16: bool, img: torch.Tensor, ref_img: torch.Tensor,
                      generator: torch.Generator | None, *gt_masks):
    """The train forward of the step: `forward_train`, or with `bf16` its
    bf16 run on bf16 images (`utils/precision.py:bf16_forward`)."""
    if bf16:
        return bf16_forward(model, "forward_train", img.to(torch.bfloat16),
                            ref_img.to(torch.bfloat16), generator, *gt_masks)
    return model.forward_train(img, ref_img, generator, *gt_masks)


def make_vps_loss_fn(model: VideoKNet, cfg: VideoKNetConfig, apply=None):
    """loss_fn(batch, generator=None) -> (total, loss_dict); `generator`
    draws the backbone's stochastic depth; `apply(bf16, img, ref_img,
    generator, *gt_masks)` runs the forward (`vps_train_forward` on `model`
    by default; the data-parallel step's DDP wrapper). `check_train_config`
    first (TF32 off).

    `cfg.bf16_train`: the forward (and so the backward) runs on bf16 casts
    of the parameters and BatchNorm statistics with bf16 images
    (`utils/precision.py:bf16_forward`); the outputs come back fp32 before
    every loss, cost and assignment, as in `video_knet_tpu/train/vps.py`."""
    check_train_config(cfg)
    apply = apply or functools.partial(vps_train_forward, model)

    def loss_fn(batch: VPSBatch, generator: torch.Generator | None = None):
        # the RoI / GT-box head embeds at the GT masks' boxes
        gt_masks = ((batch.gt.masks, batch.ref_gt.masks)
                    if cfg.track_head_type == "roi_gt_box" else ())
        with span("vk.train.forward"):
            key, ref, key_emb, ref_emb = apply(cfg.bf16_train, batch.img, batch.ref_img,
                                               generator, *gt_masks)
        with span("vk.train.loss"):
            # under the band split the forward ran on a band: the GT's band too
            losses = video_knet_loss((key, ref), (key_emb, ref_emb), gt_band(batch.gt),
                                     gt_band(batch.ref_gt), cfg)
            return sum(losses.values()), losses

    return loss_fn


def train_step(state: TrainState, batch: VPSBatch, generator: torch.Generator | None = None):
    """One VPS train step on the model's device -> (state, loss dict with
    `total_loss`, as device tensors). Over a mesh `batch` is this rank's
    data index's rows of the global batch (`parallel/mesh.py:shard_batch`)
    and the losses are the global batch's; the `model` axis splits the
    model and its losses into bands of the image rows at any height JAX's
    whole step takes (a multiple of 8 rows) with at least one stride-32 row
    a rank: every band but the last ends on a whole stride-32 row, the last
    holds the partial one (`parallel/model_axis.py:band_units`).

    With `backbone_drop_path_rate` > 0 (the Swin configs) the stochastic
    depth draws from `generator`, by default one on the batch's device
    seeded with the step count (the reference folds the step into its
    key); over a mesh every rank draws the global batch's masks and keeps
    its rows."""
    cfg = state.model.cfg
    if generator is None and cfg.backbone_drop_path_rate > 0:
        generator = torch.Generator(device=batch.img.device).manual_seed(state.step)
    return make_train_step(lambda st: make_vps_loss_fn(
        st.model, cfg, train_forward(st, vps_train_forward)), split="rows")(
            state, batch, generator)
