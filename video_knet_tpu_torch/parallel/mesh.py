"""The data-parallel mesh: this process's place on the `data` axis, the split
of a global batch, and the reductions that span it.

Counterpart of `video_knet_tpu/parallel/mesh.py`. JAX puts every device of
the host in one `Mesh(("data", "model"))`, shards each batch leaf's leading
axis over `data`, replicates the train state, and lets XLA insert the
gradient all-reduce. The port runs one process a GPU (`torchrun`): a
`DataMesh` is this process's rank, the world size and the process group;
`shard_batch` takes this rank's contiguous rows of the global batch, as
`device_put` with `P("data")` places them (rank r holds rows
[r*B/R, (r+1)*B/R)); `replicated` gives every rank rank 0's module state.

Inside `data_parallel(mesh)` (the train steps of `train/`), the reductions
that JAX's sharded step computes over the global batch span every rank:
- `global_sum` / `global_mean`: the loss normalizers (counts of positives,
  weight sums, batch means), summed before their clamps;
- `sum_with_grad`: BatchNorm's batch moments (`models/layers.py`), whose
  backward sums as well;
- `batch_uniform`: stochastic depth draws for the global batch from the
  step-seeded generator, of which each rank keeps its rows.
Each rank's loss is then its share of the global loss, and the gradients
are summed over ranks (`train/train_state.py`). Outside the context, or in
one process, every helper is the one-process computation.

The mesh's `model` axis (VPS spatial sharding of the image height, VIS
clip parallelism over frames) is ROADMAP F7b: `n_model > 1` raises.
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
    """rank and world size on the `data` axis; `group` the process group
    (None in one process)."""

    rank: int = 0
    world: int = 1
    group: Any = None

    @property
    def distributed(self) -> bool:
        return self.group is not None


def _f7b(n_model: int) -> None:
    if n_model != 1:
        raise NotImplementedError(
            f"n_model={n_model}: the mesh's `model` axis (VPS spatial sharding, VIS clip "
            f"parallelism over frames) is not ported yet (ROADMAP F7b)")


def make_mesh(n_data: int | None = None, n_model: int = 1) -> DataMesh:
    """The mesh of the initialized process group (`parallel/distributed.py:
    initialize`), else the one-process mesh. `n_data`, when given, must be
    the world size: every rank is on the data axis."""
    _f7b(n_model)
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        mesh = DataMesh()
    else:
        mesh = DataMesh(dist.get_rank(), dist.get_world_size(), dist.group.WORLD)
    if n_data is not None and n_data != mesh.world:
        raise ValueError(f"n_data={n_data}, but {mesh.world} processes are on the data axis")
    return mesh


def batch_sharding(mesh: DataMesh, batch_size: int) -> slice:
    """This rank's rows of a global batch of `batch_size`: the contiguous
    block JAX's `P("data")` gives it. The batch must split evenly, as
    `device_put` requires."""
    if batch_size % mesh.world:
        raise ValueError(f"a global batch of {batch_size} does not split over "
                         f"{mesh.world} data ranks")
    per = batch_size // mesh.world
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


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
    axis."""
    if isinstance(batch, (torch.Tensor, np.ndarray)):
        return batch[batch_sharding(mesh, batch.shape[0])]
    if isinstance(batch, tuple) and hasattr(batch, "_fields"):
        return type(batch)(*(shard_batch(mesh, x) for x in batch))
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(mesh, x) for x in batch)
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    raise TypeError(f"cannot shard a {type(batch).__name__}")


# ----------------------------------------------- reductions over the data axis

_ACTIVE: contextvars.ContextVar[DataMesh | None] = contextvars.ContextVar(
    "vknet_data_mesh", default=None)
_BLOCKS: contextvars.ContextVar[int] = contextvars.ContextVar("vknet_batch_blocks", default=1)


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
    """A count (no gradient) summed over the data ranks: a loss normalizer
    of the global batch. The identity outside `data_parallel`."""
    mesh = _ACTIVE.get()
    if mesh is None:
        return count
    out = count.detach().clone()
    torch.distributed.all_reduce(out, group=mesh.group)
    return out


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of `x` over the global batch, as this rank's share: its own
    sum over the global element count (`x.mean()` outside `data_parallel`)."""
    mesh = _ACTIVE.get()
    if mesh is None:
        return x.mean()
    return x.sum() / (x.numel() * mesh.world)


def sum_with_grad(x: torch.Tensor) -> torch.Tensor:
    """`x` summed over the data ranks; the backward sums the gradients too
    (BatchNorm's moments). The identity outside `data_parallel`."""
    mesh = _ACTIVE.get()
    if mesh is None:
        return x
    import torch.distributed.nn.functional as dist_fn

    return dist_fn.all_reduce(x, group=mesh.group)


@contextlib.contextmanager
def batch_blocks(blocks: int):
    """The batch the backbone sees stacks `blocks` slices of the global batch
    (VPS's [ref; key]): local row j*m + q is global row j*R*m + r*m + q."""
    token = _BLOCKS.set(blocks)
    try:
        yield
    finally:
        _BLOCKS.reset(token)


def batch_uniform(n: int, generator: torch.Generator, device) -> torch.Tensor:
    """`n` uniform draws, one for each row of this rank's batch. Under
    `data_parallel` the generator draws one for every row of the global
    batch and this rank keeps its rows, so R ranks draw what one process at
    the global batch does."""
    mesh = _ACTIVE.get()
    if mesh is None:
        return torch.rand((n,), generator=generator, device=device)
    blocks = _BLOCKS.get()
    m = n // blocks
    draws = torch.rand((n * mesh.world,), generator=generator, device=device)
    return draws.reshape(blocks, mesh.world, m)[:, mesh.rank].reshape(n)
