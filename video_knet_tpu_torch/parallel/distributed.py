"""Process-group setup for training over every visible GPU, and
cross-process result aggregation.

Counterpart of `video_knet_tpu/parallel/distributed.py`, which joins every
host into one JAX runtime and aggregates eval results through a shared
tmpdir. The port runs one process a GPU: `torchrun --nproc_per_node=N`
starts them and sets RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
MASTER_ADDR and MASTER_PORT; `initialize` joins them into one process group
and returns this rank's device, and `global_mesh` is the `data` x `model`
mesh over all of them (`parallel/mesh.py`).

Backend: NCCL when each rank has a GPU of its own, gloo on the CPU. Ranks
that share a GPU (more local ranks than cards) raise unless the caller
names gloo: NCCL refuses two ranks on one device, and nothing falls back
silently. With NCCL a second, gloo, group carries host-side agreement (the
preemption flag, barriers), so that it never waits on the card; the
mesh's `data` and `model` subgroups take the world's backend.
"""

from __future__ import annotations

import os
import pickle

import torch
import torch.distributed as dist

from video_knet_tpu_torch.parallel.mesh import DataMesh, forget_groups, make_mesh

_HOST_GROUP = None


def initialize(device: str | torch.device | None = "cuda", *, backend: str | None = None,
               init_method: str | None = None) -> torch.device:
    """Join this process to the data-parallel group of torchrun's
    environment (RANK, WORLD_SIZE; `init_method` defaults to `env://`) and
    return its device; without torchrun this does nothing (one process)
    and returns `device`. `device` is the kind the ranks run on ("cuda" or
    "cpu"); on CUDA rank r takes card LOCAL_RANK."""
    global _HOST_GROUP
    device = torch.device(device if device is not None else "cuda")
    if dist.is_available() and dist.is_initialized():
        return _rank_device(device, dist.get_rank(), dist.get_world_size(), backend)[0]
    if not os.environ.get("WORLD_SIZE"):
        return device
    world_size, rank = int(os.environ["WORLD_SIZE"]), int(os.environ.get("RANK", 0))
    device, backend = _rank_device(device, rank, world_size, backend)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    _HOST_GROUP = dist.new_group(backend="gloo") if backend == "nccl" else dist.group.WORLD
    return device


def _rank_device(device: torch.device, rank: int, world_size: int,
                 backend: str | None) -> tuple[torch.device, str]:
    """(this rank's device, the backend) for ranks of `device`'s kind."""
    if device.type != "cuda":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} on the {device.type}: only gloo runs there")
        return device, "gloo"
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("data parallelism on CUDA requested, but no GPU is visible")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if local_world > cards and backend != "gloo":
        raise ValueError(
            f"{local_world} ranks on this host share {cards} GPU(s): NCCL needs a card a "
            f"rank; ask for backend='gloo' by name to share them")
    return torch.device("cuda", local_rank % cards), backend or "nccl"


def host_group():
    """The group for host-side agreement: gloo beside NCCL, else the world."""
    return _HOST_GROUP if _HOST_GROUP is not None else dist.group.WORLD


def global_mesh(n_model: int = 1) -> DataMesh:
    """The mesh over every rank of every host: `n_model` ranks on the
    `model` axis, the rest on `data` (JAX's `global_mesh`)."""
    return make_mesh(n_model=n_model)


def barrier() -> None:
    """Every rank waits here for the others (on the host group)."""
    if dist.is_initialized():
        dist.barrier(group=host_group())


def any_rank(flag: bool) -> bool:
    """True on every rank when `flag` is set on any (the preemption
    request, agreed at a step boundary so that every rank stops at the same
    step)."""
    if not dist.is_initialized():
        return flag
    t = torch.tensor([int(flag)])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=host_group())
    return bool(t.item())


def allgather_results(local: list, tmpdir: str | None = None) -> list | None:
    """Gather per-process result lists through a shared tmpdir (the
    reference's tmpdir + pickle collection): every rank writes
    part_{rank}.pkl, all meet at a barrier, and rank 0 concatenates them in
    rank order. Returns the whole list on rank 0, None elsewhere."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return local
    if tmpdir is None:
        raise ValueError("gathering over several processes needs a shared tmpdir")
    os.makedirs(tmpdir, exist_ok=True)
    rank = dist.get_rank()
    with open(os.path.join(tmpdir, f"part_{rank}.pkl"), "wb") as f:
        pickle.dump(local, f)
    dist.barrier(group=host_group())
    if rank != 0:
        return None
    out = []
    for r in range(dist.get_world_size()):
        with open(os.path.join(tmpdir, f"part_{r}.pkl"), "rb") as f:
            out.extend(pickle.load(f))
    return out


def shutdown() -> None:
    """Leave the process group (the end of a torchrun worker)."""
    global _HOST_GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP = None
    forget_groups()
