"""Optimizer and LR schedule of the reference training recipe.

Counterpart of `video_knet_tpu/train/optim.py` (configs/det/_base_/schedules/
schedule_1x.py): AdamW lr 1e-4, weight decay 0.05 on every trainable
parameter, backbone lr x 0.25, gradient clipping to global L2 norm 1 within
each of the two groups (optax's `multi_transform` clips each group on its
own), linear warmup over 1000 iterations from 1e-3, step decay x 0.1 at the
given epochs. The model owns freezing: ResNet's `frozen_stages` (1: the
stem and layer1) turns `requires_grad` off, and those parameters stay out of
the optimizer, as `optax.masked` leaves them.

`freeze_detector` is the non-joint two-phase mode of the reference's
VideoKNetQuansiEmbedFC (knet/video/knet_quansi_dense_embed_fc.py:92-139):
the detector is frozen and only the tracking pieces train, the parameters
whose flax names hold one of JAX's `TRACK_KEYS`. The frozen parameters
take no gradient, no update, no weight decay and no moment state, and do
not move. (JAX's `optax.masked` passes a masked leaf's raw gradient through
to `apply_updates`, so its detector moves by +gradient each step; the port
does not copy that.)

optax.adamw's order (adam, + wd * p, * lr) is torch.optim.AdamW's
(p *= 1 - lr * wd, then the adam step) with the same numbers. The schedule
is read at the step count before the update, as optax reads its count: the
first update uses lr(0).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


def make_lr_schedule(base_lr: float, steps_per_epoch: int, *,
                     decay_epochs: Sequence[int] = (9, 11), warmup_iters: int = 1000,
                     warmup_ratio: float = 1e-3, gamma: float = 0.1):
    """step -> learning rate."""
    boundaries = [e * steps_per_epoch for e in decay_epochs]

    def schedule(step: int) -> float:
        warm = (warmup_ratio + (1.0 - warmup_ratio) * step / max(warmup_iters, 1)
                if step < warmup_iters else 1.0)
        return base_lr * warm * gamma ** sum(step >= b for b in boundaries)

    return schedule


TRACK_KEYS = ("track_embed", "attention_previous", "link_ffn", "link_update", "track_update")


def frozen_mask(model: nn.Module, freeze_detector: bool = False) -> dict[str, bool]:
    """{parameter name: trainable}: as the model set `requires_grad`, or with
    `freeze_detector` exactly the parameters whose flax names
    (`utils/convert.py:flax_names`) hold a track key, as JAX's
    `frozen_mask` decides leaf by leaf."""
    if not freeze_detector:
        return {name: p.requires_grad for name, p in model.named_parameters()}
    from video_knet_tpu_torch.utils.convert import flax_names

    names = flax_names(model, [name for name, _ in model.named_parameters()])
    return {name: any(k in flax for k in TRACK_KEYS) for name, flax in names.items()}


def backbone_label(model: nn.Module) -> dict[str, str]:
    return {name: "backbone" if name.startswith("backbone.") else "rest"
            for name, _ in model.named_parameters()}


class Optimizer:
    """AdamW over the trainable parameters in two groups (backbone, rest),
    each clipped to `grad_clip` on its own, with a per-step LR lambda."""

    def __init__(self, groups: dict[str, list[nn.Parameter]], lr_mults: dict[str, float],
                 schedule, *, weight_decay: float, grad_clip: float):
        names = [g for g in ("backbone", "rest") if groups[g]]
        self.adamw = torch.optim.AdamW(
            [dict(params=groups[g], lr=lr_mults[g], name=g) for g in names],
            lr=1.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
        # group lr = schedule(step) * lr mult: LambdaLR scales each group's initial lr
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.adamw, schedule)
        self.grad_clip = grad_clip

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def _clip(self, grads: list[torch.Tensor]) -> None:
        """optax.clip_by_global_norm: unchanged below the limit, else scaled
        to it; on the device, no host sync."""
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                            self.grad_clip / norm)
        torch._foreach_mul_(grads, scale)

    def step(self) -> None:
        """Clip each group, one AdamW update, advance the schedule. A
        trainable parameter the loss did not reach gets a zero gradient, so
        weight decay still applies to it, as in optax."""
        for group in self.adamw.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            self._clip([p.grad for p in group["params"]])
        self.adamw.step()
        self.scheduler.step()


def make_optimizer(model: nn.Module, steps_per_epoch: int, *, base_lr: float = 1e-4,
                   weight_decay: float = 0.05, backbone_lr_mult: float = 0.25,
                   grad_clip: float = 1.0, decay_epochs: Sequence[int] = (9, 11),
                   warmup_iters: int = 1000, freeze_detector: bool = False) -> Optimizer:
    """The optimizer of `model`'s trainable parameters. With
    `freeze_detector`, every other parameter stops taking gradients
    (`requires_grad` off, as the reference freezes it)."""
    sched = make_lr_schedule(base_lr, steps_per_epoch, decay_epochs=decay_epochs,
                             warmup_iters=warmup_iters)
    trainable = frozen_mask(model, freeze_detector)
    if not any(trainable.values()):
        raise ValueError("no trainable parameter (freeze_detector on a model without "
                         "track layers?)")
    for name, p in model.named_parameters():
        if not trainable[name]:
            p.requires_grad_(False)
    label = backbone_label(model)
    groups: dict[str, list[nn.Parameter]] = {"backbone": [], "rest": []}
    for name, p in model.named_parameters():
        if trainable[name]:
            groups[label[name]].append(p)
    return Optimizer(groups, {"backbone": backbone_lr_mult, "rest": 1.0}, sched,
                     weight_decay=weight_decay, grad_clip=grad_clip)
