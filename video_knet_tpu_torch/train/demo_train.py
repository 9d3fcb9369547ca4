"""Synthetic-data smoke train of the full Video K-Net VPS model:

    python -m video_knet_tpu_torch.train.demo_train [--steps 5] [--hw 128 256]
        [--max-insts 8] [--device cuda]

Runs N train steps on `make_synthetic_batch` batches (seed = step) from
seeded random weights, on CUDA unless `--device` names another, and prints
the loss curve. Counterpart of `video_knet_tpu/train/demo_train.py` on one
device.
"""

from __future__ import annotations

import argparse
import math
import time

import torch


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--hw", type=int, nargs=2, default=[128, 256])
    p.add_argument("--max-insts", type=int, default=8)
    p.add_argument("--seed", type=int, default=0, help="weight seed")
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args()

    from video_knet_tpu_torch.config import VideoKNetConfig
    from video_knet_tpu_torch.models.video.knet_vps import VideoKNet
    from video_knet_tpu_torch.train.optim import make_optimizer
    from video_knet_tpu_torch.train.train_state import create_train_state
    from video_knet_tpu_torch.train.vps import make_synthetic_batch, train_step
    from video_knet_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = VideoKNetConfig(max_insts=args.max_insts)
    model = VideoKNet(cfg, generator=torch.Generator().manual_seed(args.seed), device=device)
    state = create_train_state(model, make_optimizer(model, steps_per_epoch=1000))
    h, w = args.hw
    print(f"device={device} batch={args.batch} hw={h}x{w}")
    for i in range(args.steps):
        batch = make_synthetic_batch(cfg, args.batch, (h, w), seed=i, device=device)
        t0 = time.perf_counter()
        state, losses = train_step(state, batch)
        total = float(losses["total_loss"])
        print(f"step {i}: total_loss={total:.4f}  ({time.perf_counter() - t0:.2f}s)")
        if not math.isfinite(total):
            raise SystemExit(f"non-finite loss at step {i}")
    print("smoke train OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
