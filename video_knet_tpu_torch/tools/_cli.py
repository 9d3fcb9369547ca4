"""What every command-line entry point of the port shares: the device flag,
the seeded model build and the `--checkpoint` load.

The CLIs take the reference package's arguments (`tools/*.py` at the repo
root) plus `--device`. With no `--device` they run on the GPU, and raise on
a machine without one rather than fall back to the CPU.
"""

from __future__ import annotations

import argparse

import torch

INIT_SEED = 0
DEVICE_HELP = ("cuda (the default) or cpu; without a GPU and without --device the "
               "command raises instead of running on the CPU")
CHECKPOINT_HELP = ("a checkpoint written by video_knet_tpu_torch.utils.checkpoint."
                   "save_checkpoint (a train state or a model state; its directory or "
                   "checkpoint.pt), merged over the model's own init")
INIT_NOTE = (f"Without --checkpoint the weights are a seeded random init "
             f"(torch.Generator().manual_seed({INIT_SEED})).")


def parser(description: str | None = None) -> argparse.ArgumentParser:
    """An ArgumentParser whose help states the random init, with `--device`."""
    p = argparse.ArgumentParser(
        description=" ".join(s for s in (description, INIT_NOTE) if s))
    p.add_argument("--device", default=None, help=DEVICE_HELP)
    return p


def setup_device(name: str | None) -> torch.device:
    """`--device` -> a torch.device (CUDA unless named; raises without a GPU);
    on CUDA, full-fp32 matmuls and convolutions (TF32 off), as the reference
    computes."""
    from video_knet_tpu_torch.utils.device import resolve_device, set_fp32_numerics

    device = resolve_device(name)
    if device.type == "cuda":
        set_fp32_numerics()
    return device


def add_dist_args(p: argparse.ArgumentParser) -> None:
    """The process-group flags of the train CLIs, read under torchrun."""
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="under torchrun: the process group's backend (default nccl on GPUs, "
                        "gloo on the CPU; gloo lets ranks share one GPU)")
    p.add_argument("--dist-url", default=None,
                   help="under torchrun: the process group's init method (default env://, "
                        "torchrun's store; e.g. file:///shared/path)")


def setup_ranks(args):
    """`--device`, then, under torchrun, this process's place in the data
    mesh over every rank (`parallel/distributed.py`): (this rank's device,
    the mesh). Without torchrun: (the device, the one-process mesh)."""
    from video_knet_tpu_torch.parallel import distributed

    device = distributed.initialize(setup_device(args.device), backend=args.dist_backend,
                                    init_method=args.dist_url)
    return device, distributed.global_mesh()


def build_model(cls, cfg, device: torch.device, checkpoint: str | None = None):
    """`cls(cfg)` on `device` from the seeded init, with `checkpoint`'s
    model state merged over it (every key it holds must keep its shape, and
    every key must belong to the model)."""
    from video_knet_tpu_torch.utils.checkpoint import load_model_state, merge_params

    model = cls(cfg, generator=torch.Generator().manual_seed(INIT_SEED), device=device)
    if checkpoint:
        merged = merge_params(model.state_dict(), load_model_state(checkpoint))
        model.load_state_dict(merged, strict=True)
    return model.eval()
