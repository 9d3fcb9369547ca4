"""VIS training: batch container, synthetic clips, the loss function and the
clip train step, on one device or data-parallel.

Counterpart of `video_knet_tpu/train/vis.py`: the KNetVIS clip forward,
`knet_vis_loss`, the backward and the AdamW update; over a mesh it is
`make_sharded_vis_train_step` (`train/train_state.py`): the clips over
`data`, and with ranks on the mesh's `model` axis each clip's frames split
over them (clip parallelism, `parallel/model_axis.py`) for the backbone,
the neck, the per-frame heads and the per-frame losses, with the GT tubes
cut to the rank's frames (`models/vis/knet_vis.py:gt_frames`). Scope: fp32, or a bf16 forward with
`bf16_train` (as `train/vps.py`); BatchNorm on its running statistics, or
live with `norm_eval=False` (fp32; statistics over the B*T frames).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from video_knet_tpu_torch.config_vis import VISConfig
from video_knet_tpu_torch.models.vis.knet_vis import ClipGT, KNetVIS, gt_frames, knet_vis_loss
from video_knet_tpu_torch.parallel.model_axis import frame_counts
from video_knet_tpu_torch.train.train_state import (
    TrainState,
    check_train_config,
    make_train_step,
    train_forward,
)
from video_knet_tpu_torch.utils.device import resolve_device
from video_knet_tpu_torch.utils.precision import bf16_forward


class VISBatch(NamedTuple):
    """clip [B, T, H, W, 3] normalized; gt tubes at mask-assign-stride
    resolution."""

    clip: torch.Tensor
    gt: ClipGT


def make_synthetic_clip_gt(cfg: VISConfig, b: int, t: int, hw: tuple[int, int], seed: int = 0,
                           device=None) -> ClipGT:
    """Deterministic synthetic tubes from numpy draws: up to 4 rectangles of
    a third of the frame, each drifting a few pixels a frame; every second
    one is absent from one random frame (so a slot's per-frame validity
    differs from its tube's); random labels."""
    device = resolve_device(device)
    h, w = hw
    g = cfg.max_insts
    rng = np.random.RandomState(seed)
    masks = np.zeros((b, g, t, h, w), np.float32)
    n_real = min(4, g)
    for i in range(n_real):
        y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
        dy, dx = rng.randint(-2, 3, size=2)
        gone = rng.randint(0, t) if t > 1 and i % 2 else -1
        for f in range(t):
            if f == gone:
                continue
            y, x = np.clip(y0 + dy * f, 0, h - 1), np.clip(x0 + dx * f, 0, w - 1)
            masks[:, i, f, y:y + h // 3, x:x + w // 3] = 1.0
    labels = rng.randint(0, cfg.num_classes, size=(b, g)).astype(np.int32)
    valid = np.zeros((b, g), bool)
    valid[:, :n_real] = True
    return ClipGT(*(torch.from_numpy(x).to(device) for x in (masks, labels, valid)))


def make_synthetic_batch(cfg: VISConfig, b: int, hw: tuple[int, int], t: int | None = None,
                         seed: int = 0, device=None) -> VISBatch:
    """A clip of `t` frames (the config's clip length by default) of seeded
    noise and `make_synthetic_clip_gt` at the assign stride."""
    device = resolve_device(device)
    t = cfg.num_frames if t is None else t
    h, w = hw
    s = cfg.mask_assign_stride
    rng = np.random.RandomState(seed)
    clip = torch.from_numpy(rng.randn(b, t, h, w, 3).astype(np.float32)).to(device)
    return VISBatch(clip, make_synthetic_clip_gt(cfg, b, t, (h // s, w // s), seed=seed,
                                                 device=device))


def vis_train_forward(model: KNetVIS, bf16: bool, clip: torch.Tensor,
                      generator: torch.Generator | None):
    """The clip forward of the step, or with `bf16` its bf16 run on a bf16
    clip."""
    if bf16:
        return bf16_forward(model, "forward", clip.to(torch.bfloat16), generator)
    return model(clip, generator)


def make_vis_loss_fn(model: KNetVIS, cfg: VISConfig, apply=None):
    """loss_fn(batch, generator=None) -> (total, loss_dict); `generator`
    draws the backbone's stochastic depth; `apply(bf16, clip, generator)`
    runs the forward (`vis_train_forward` on `model` by default).
    `check_train_config` first (TF32 off). `cfg.bf16_train`: a bf16 forward
    on a bf16 clip, fp32 loss math (`train/vps.py:make_vps_loss_fn`)."""
    check_train_config(cfg)
    apply = apply or functools.partial(vis_train_forward, model)

    def loss_fn(batch: VISBatch, generator: torch.Generator | None = None):
        outs = apply(cfg.bf16_train, batch.clip, generator)
        losses = knet_vis_loss(outs, gt_frames(batch.gt), cfg)
        return sum(losses.values()), losses

    return loss_fn


def train_step(state: TrainState, batch: VISBatch, generator: torch.Generator | None = None):
    """One VIS train step on the model's device -> (state, loss dict with
    `total_loss`, as device tensors). Over a mesh `batch` is this rank's
    data index's clips of the global batch and the losses are the global
    batch's; as JAX's step reads clip parallelism from its mesh, the
    mesh's `model` axis splits each clip's frames (contiguous, T=5 over 2
    ranks: 3 + 2) for the backbone, the neck, the per-frame heads and the
    losses; the clip kernels' merge gathers every frame's kernels, and
    the work on the N clip kernels runs replicated on each rank.

    With `backbone_drop_path_rate` > 0 (the Swin-B config) the stochastic
    depth draws from `generator`, by default one on the batch's device
    seeded with the step count (over a mesh, the global batch's draws)."""
    cfg = state.model.cfg
    if state.mesh is not None:
        frame_counts(batch.clip.shape[1], state.mesh.n_model)  # raises if the clip is short
    if generator is None and cfg.backbone_drop_path_rate > 0:
        generator = torch.Generator(device=batch.clip.device).manual_seed(state.step)
    return make_train_step(lambda st: make_vis_loss_fn(
        st.model, cfg, train_forward(st, vis_train_forward)), split="frames")(
            state, batch, generator)
