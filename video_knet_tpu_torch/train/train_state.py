"""Train state and the train step on one device.

Counterpart of `video_knet_tpu/train/train_state.py`: one step holds the
forward, the losses, the backward, the per-group clip and the AdamW update.
Nothing in it waits on the host: the loss dict comes back as device
tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

from video_knet_tpu_torch.train.optim import Optimizer
from video_knet_tpu_torch.utils.device import set_fp32_numerics


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: Optimizer


def create_train_state(model: nn.Module, optimizer: Optimizer) -> TrainState:
    return TrainState(step=0, model=model, optimizer=optimizer)


def check_train_config(cfg) -> None:
    """The training the port runs: fp32, or bf16 with `bf16_train`
    (`utils/precision.py`), with BatchNorm on its running statistics
    (`norm_eval=False` raises). Turns TF32 off for cuBLAS and cuDNN (the
    reference trains in fp32), as serving does."""
    if getattr(cfg, "bf16_train", False) and not cfg.norm_eval:
        raise ValueError(
            "bf16_train requires norm_eval=True (frozen BN stats): live BN "
            "stat updates would be accumulated in bfloat16")
    if not cfg.norm_eval:
        raise NotImplementedError(
            "norm_eval=False (BatchNorm batch statistics) is not ported yet (ROADMAP B5)")
    set_fp32_numerics()


def make_train_step(loss_fn: Callable[..., tuple[torch.Tensor, dict]]):
    """loss_fn(batch, *args) -> (total, loss_dict). Returns
    train_step(state, batch, *args) -> (state, loss_dict with `total_loss`),
    detached."""

    def train_step(state: TrainState, batch, *args):
        state.optimizer.zero_grad()
        total, losses = loss_fn(batch, *args)
        total.backward()
        state.optimizer.step()
        state.step += 1
        out = {k: v.detach() for k, v in losses.items()}
        out["total_loss"] = total.detach()
        return state, out

    return train_step
