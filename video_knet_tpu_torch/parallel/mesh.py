"""The mesh: this process's place on the `data` and `model` axes, the split
of a global batch, and the reductions that span the mesh.

Counterpart of `video_knet_tpu/parallel/mesh.py`. JAX puts every device of
the host in one `Mesh(devices.reshape(n_data, n_model), ("data",
"model"))`, shards each batch leaf's leading axis over `data` (replicated
over `model`), replicates the train state, and lets XLA insert the
gradient all-reduce. The port runs one process a GPU (`torchrun`): a
`DataMesh` is this process's rank, the world size, the number of ranks on
the `model` axis and the process groups. Rank r sits at (d, m) =
divmod(r, n_model), where JAX's reshape places device r; the `data` group
holds the ranks of one m, the `model` group the ranks of one d.
`shard_batch` takes data index d's contiguous rows of the global batch, as
`device_put` with `P("data")` places them (rows [d*B/D, (d+1)*B/D));
`replicated` gives every rank rank 0's module state.

Inside `data_parallel(mesh)` (the train steps of `train/`), the reductions
that JAX's sharded step computes over the global batch span the mesh:
- `global_sum` / `global_mean`: the loss normalizers (counts of positives,
  weight sums, batch means), summed over the `data` axis before their
  clamps. The `model` ranks of one data index hold the same rows as
  counts of kernels, clips and GT slots, while a count of pixels or of
  frames is first summed over the bands or the frames
  (`parallel/model_axis.py:model_count`, `frame_count`), so a sum over the
  world would count each row `n_model` times;
- `sum_with_grad`: BatchNorm's batch moments (`models/layers.py`), summed
  over every rank (each holds only its band or frames of its rows), whose
  backward sums as well;
- `batch_uniform`: stochastic depth draws for the global batch from the
  step-seeded generator, of which each rank keeps its rows (under the frame
  split, its frames of them).
Each rank's loss is then its share of the global loss, and the gradients
are summed over the ranks (`train/train_state.py`). Outside the context, or
in one process, every helper is the one-process computation.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch


@dataclass(frozen=True)
class DataMesh:
    """rank and world size; `n_model` ranks on the `model` axis; `group`
    the world's process group, `data_group` / `model_group` this rank's
    groups on either axis (None in one process; `model_group` None with
    one rank on the axis)."""

    rank: int = 0
    world: int = 1
    group: Any = None
    n_model: int = 1
    data_group: Any = None
    model_group: Any = None

    def __post_init__(self):
        if self.n_model < 1 or self.world % self.n_model:
            raise ValueError(f"n_model={self.n_model} does not divide the world of "
                             f"{self.world} ranks")

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def n_data(self) -> int:
        return self.world // self.n_model

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model


# the subgroups of the initialized process group, a (world, n_model): every
# rank creates every group, in one order, once
_GROUPS: dict = {}


def _axis_groups(world: int, rank: int, n_model: int) -> tuple[Any, Any]:
    """(this rank's `data` group, its `model` group) over the world's
    ranks, created on first use (`torch.distributed.new_group` is
    collective: every rank creates every group in the same order)."""
    dist = torch.distributed
    if n_model == 1:
        return dist.group.WORLD, None
    key = (world, n_model)
    if key not in _GROUPS:
        n_data = world // n_model
        data = [dist.new_group([d * n_model + m for d in range(n_data)])
                for m in range(n_model)]
        model = [dist.new_group([d * n_model + m for m in range(n_model)])
                 for d in range(n_data)]
        _GROUPS[key] = (data, model)
    data, model = _GROUPS[key]
    return data[rank % n_model], model[rank // n_model]


def forget_groups() -> None:
    """Drop the cached subgroups (the process group is being destroyed)."""
    _GROUPS.clear()


def make_mesh(n_data: int | None = None, n_model: int = 1) -> DataMesh:
    """The `n_data` x `n_model` mesh of the initialized process group
    (`parallel/distributed.py:initialize`), else the one-process mesh.
    `n_data` defaults to the world size over `n_model`; the two must
    multiply to the world size."""
    dist = torch.distributed
    initialized = dist.is_available() and dist.is_initialized()
    rank, world = (dist.get_rank(), dist.get_world_size()) if initialized else (0, 1)
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world or n_data < 1:
        raise ValueError(f"a mesh of n_data={n_data} x n_model={n_model} does not cover the "
                         f"{world} process(es) of the world")
    if not initialized:
        return DataMesh()
    data_group, model_group = _axis_groups(world, rank, n_model)
    return DataMesh(rank, world, dist.group.WORLD, n_model, data_group, model_group)


def batch_sharding(mesh: DataMesh, batch_size: int) -> slice:
    """This rank's rows of a global batch of `batch_size`: the contiguous
    block JAX's `P("data")` gives its data index (the same on every rank of
    the `model` axis). The batch must split evenly, as `device_put`
    requires."""
    if batch_size % mesh.n_data:
        raise ValueError(f"a global batch of {batch_size} does not split over "
                         f"{mesh.n_data} data ranks")
    per = batch_size // mesh.n_data
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def replicated(mesh: DataMesh, module: torch.nn.Module) -> torch.nn.Module:
    """`module` with rank 0's parameters and buffers on every rank (JAX's
    replicated sharding of the train state)."""
    if mesh.distributed:
        with torch.no_grad():
            for t in [*module.parameters(), *module.buffers()]:
                torch.distributed.broadcast(t.data, src=0, group=mesh.group)
    return module


def shard_batch(mesh: DataMesh, batch):
    """This rank's rows of every leaf of a global batch (tensors and numpy
    arrays in NamedTuples, tuples, lists and dicts), split on the leading
    axis over `data`."""
    if isinstance(batch, (torch.Tensor, np.ndarray)):
        return batch[batch_sharding(mesh, batch.shape[0])]
    if isinstance(batch, tuple) and hasattr(batch, "_fields"):
        return type(batch)(*(shard_batch(mesh, x) for x in batch))
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(mesh, x) for x in batch)
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    raise TypeError(f"cannot shard a {type(batch).__name__}")


# ------------------------------------------------ reductions over the mesh

_ACTIVE: contextvars.ContextVar[DataMesh | None] = contextvars.ContextVar(
    "vknet_data_mesh", default=None)
_BLOCKS: contextvars.ContextVar[int] = contextvars.ContextVar("vknet_batch_blocks", default=1)
# under the frame split: (the rows of the data index's backbone batch, the
# indices of this rank's rows among them)
_SHARE_ROWS: contextvars.ContextVar[tuple[int, torch.Tensor] | None] = contextvars.ContextVar(
    "vknet_share_rows", default=None)


@contextlib.contextmanager
def data_parallel(mesh: DataMesh | None):
    """While active, the helpers below reduce over `mesh`'s ranks (a mesh
    without a process group changes nothing)."""
    token = _ACTIVE.set(mesh if mesh is not None and mesh.distributed else None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active_mesh() -> DataMesh | None:
    return _ACTIVE.get()


def global_sum(count: torch.Tensor) -> torch.Tensor:
    """A count (no gradient) summed over the `data` axis: a loss normalizer
    of the global batch. The identity outside `data_parallel`."""
    mesh = _ACTIVE.get()
    if mesh is None:
        return count
    out = count.detach().clone()
    torch.distributed.all_reduce(out, group=mesh.data_group)
    return out


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of `x` over the global batch, as this data index's share:
    its own sum over the global element count (`x.mean()` outside
    `data_parallel`)."""
    mesh = _ACTIVE.get()
    if mesh is None:
        return x.mean()
    return x.sum() / (x.numel() * mesh.n_data)


def sum_with_grad(x: torch.Tensor) -> torch.Tensor:
    """`x` summed over every rank; the backward sums the gradients too
    (BatchNorm's moments: each rank holds its rows, band or frames). The
    identity outside `data_parallel`."""
    mesh = _ACTIVE.get()
    if mesh is None:
        return x
    import torch.distributed.nn.functional as dist_fn

    return dist_fn.all_reduce(x, group=mesh.group)


@contextlib.contextmanager
def batch_blocks(blocks: int):
    """The batch the backbone sees stacks `blocks` slices of the global batch
    (VPS's [ref; key]): local row j*m + q is global row j*D*m + d*m + q for
    data index d of D."""
    token = _BLOCKS.set(blocks)
    try:
        yield
    finally:
        _BLOCKS.reset(token)


@contextlib.contextmanager
def share_rows(n: int, rows: torch.Tensor):
    """The backbone's batch is `rows` (indices) of the data index's batch of
    `n` rows (the frame split, `parallel/model_axis.py`)."""
    token = _SHARE_ROWS.set((n, rows))
    try:
        yield
    finally:
        _SHARE_ROWS.reset(token)


def batch_uniform(n: int, generator: torch.Generator, device) -> torch.Tensor:
    """`n` uniform draws, one for each row of this rank's batch. Under
    `data_parallel` the generator draws one for every row of the global
    batch and this rank keeps its rows (under the frame split, its frames
    of them), so the mesh draws what one process at the global batch
    does."""
    mesh = _ACTIVE.get()
    if mesh is None:
        return torch.rand((n,), generator=generator, device=device)
    share = _SHARE_ROWS.get()
    rows = n if share is None else share[0]
    blocks = _BLOCKS.get()
    draws = torch.rand((rows * mesh.n_data,), generator=generator, device=device)
    mine = draws.reshape(blocks, mesh.n_data, rows // blocks)[:, mesh.data_index].reshape(rows)
    return mine if share is None else mine[share[1].to(mine.device)]
