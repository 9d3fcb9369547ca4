"""Train state and the train step, on one device or data-parallel.

Counterpart of `video_knet_tpu/train/train_state.py` and of the sharded
steps' common frame (`train/vps.py:make_sharded_train_step` on a `data`
mesh): one step holds the forward, the losses, the backward, the per-group
clip and the AdamW update. Nothing in it waits on the host: the loss dict
comes back as device tensors.

Over a data mesh of several ranks (`parallel/mesh.py`) each rank runs its
rows of the global batch through the model under DistributedDataParallel:
the loss normalizers and BatchNorm's statistics span the global batch
(`mesh.data_parallel`), so each rank's loss is its share of the global
loss, and a comm hook sums the gradients over the ranks (DDP would average
them), so the per-group clip and AdamW see the global gradient on every
rank, as optax does. The loss dict is the global value on every rank.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Callable

import torch
from torch import nn

from video_knet_tpu_torch.parallel.mesh import DataMesh, data_parallel
from video_knet_tpu_torch.train.optim import Optimizer
from video_knet_tpu_torch.utils.device import set_fp32_numerics


@dataclass
class TrainState:
    """`mesh`: the data mesh the steps run over (None: one process)."""

    step: int
    model: nn.Module
    optimizer: Optimizer
    mesh: DataMesh | None = None
    _ddp: dict = field(default_factory=dict, repr=False, compare=False)


def create_train_state(model: nn.Module, optimizer: Optimizer,
                       mesh: DataMesh | None = None) -> TrainState:
    return TrainState(step=0, model=model, optimizer=optimizer, mesh=mesh)


def check_train_config(cfg) -> None:
    """The training the port runs: fp32, or bf16 with `bf16_train`
    (`utils/precision.py`); BatchNorm on its running statistics
    (`norm_eval=True`) or live (`norm_eval=False`, fp32 only: JAX's
    ValueError). Turns TF32 off for cuBLAS and cuDNN (the reference trains
    in fp32), as serving does."""
    if getattr(cfg, "bf16_train", False) and not cfg.norm_eval:
        raise ValueError(
            "bf16_train requires norm_eval=True (frozen BN stats): live BN "
            "stat updates would be accumulated in bfloat16")
    set_fp32_numerics()


class TrainForward(nn.Module):
    """What DistributedDataParallel wraps: its forward is `fn(model,
    *inputs)`, a task's train forward (the models' train entry points are
    not all `forward`)."""

    def __init__(self, model: nn.Module, fn: Callable):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *inputs):
        return self.fn(self.model, *inputs)


def _sum_hook(group, bucket):
    """DDP comm hook: the bucket summed over the ranks (not averaged)."""
    work = torch.distributed.all_reduce(bucket.buffer(), group=group, async_op=True)
    return work.get_future().then(lambda fut: fut.value()[0])


def train_forward(state: TrainState, fn: Callable) -> Callable:
    """`fn(model, *inputs)` as a step runs it: on the model itself, or over
    a mesh of several ranks through one DistributedDataParallel wrapper a
    state and `fn` (built at first use; it starts every rank from rank 0's
    parameters and buffers). BatchNorm statistics are global, so the
    buffers stay equal without DDP's broadcast. DDP walks the autograd
    graph for parameters the loss never reaches only for a model that has
    them (`leaves_parameters_unused`: Swin's cut frozen stages, the
    roi_gt_box link's last stage); for any other, a parameter left unused
    raises at the next step."""
    mesh = state.mesh
    if mesh is None or not mesh.distributed:
        return functools.partial(fn, state.model)
    ddp = state._ddp.get(fn)
    if ddp is None:
        ddp = torch.nn.parallel.DistributedDataParallel(
            TrainForward(state.model, fn), process_group=mesh.group,
            broadcast_buffers=False,
            find_unused_parameters=getattr(state.model, "leaves_parameters_unused", False))
        ddp.register_comm_hook(mesh.group, _sum_hook)
        state._ddp[fn] = ddp
    return ddp


def global_losses(mesh: DataMesh | None, losses: dict) -> dict:
    """Each rank's share of every loss summed over the ranks: the global
    loss dict on every rank (one all-reduce; as is in one process)."""
    if mesh is None or not mesh.distributed:
        return losses
    flat = torch.stack(list(losses.values()))
    torch.distributed.all_reduce(flat, group=mesh.group)
    return dict(zip(losses, flat.unbind()))


def make_train_step(make_loss_fn: Callable[..., Callable]):
    """make_loss_fn(state) -> loss_fn(batch, *args) -> (total, loss_dict).
    Returns train_step(state, batch, *args) -> (state, loss_dict with
    `total_loss`), detached; `batch` is this rank's rows.

    The model runs in training mode for the step (flax's `train=True`:
    live BatchNorm where `norm_eval=False` and `ura_for` allow) and is back
    in eval mode after it, as serving and the eval hook expect."""

    def train_step(state: TrainState, batch, *args):
        model = state.model
        state.optimizer.zero_grad()
        model.train()
        try:
            with data_parallel(state.mesh):
                total, losses = make_loss_fn(state)(batch, *args)
                total.backward()
        finally:
            model.eval()
        state.optimizer.step()
        state.step += 1
        out = {k: v.detach() for k, v in losses.items()}
        out["total_loss"] = total.detach()
        return state, global_losses(state.mesh, out)

    return train_step
