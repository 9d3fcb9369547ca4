"""Train Video K-Net VPS (KITTI-STEP / VIP-Seg) on one GPU.

Counterpart of the reference package's `tools/train_vps.py` (the same
arguments, files and printed lines, plus `--device`): config -> dataset ->
threaded loader -> train steps on one device, a checkpoint a epoch in
`work_dir/ckpt/step_{epoch}`, a JSON record every `--log-interval` steps on
stdout and in `work_dir/train_log.jsonl`, and with `--eval-interval` VPQ /
STQ on the val split. SIGTERM or SIGINT finishes the step, writes
`work_dir/ckpt/step_{step}` and returns; `--resume-from` that directory
continues. The losses stay on the device between log steps. The
reference's data-parallel mesh is ROADMAP F7.

Usage:
  python -m video_knet_tpu_torch.tools.train_vps --data-root data/kitti-step \\
      --epochs 12 --batch-size 8 --crop 384 1248 [--dataset vipseg] \\
      [--backbone swin_base] [--load-from ckpt] [--resume-from ckpt] \\
      [--work-dir work_dirs/vps] [--freeze-detector] [--bf16] [--device cpu]
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import torch

from video_knet_tpu_torch.tools import _cli


def parse_args(argv=None):
    p = _cli.parser(__doc__.splitlines()[0])
    p.add_argument("--data-root", required=True)
    p.add_argument("--dataset", default="kitti_step", choices=["kitti_step", "vipseg"])
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--crop", type=int, nargs=2, default=[384, 1248])
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--work-dir", default="work_dirs/vps")
    p.add_argument("--load-from", default=None,
                   help="weights-only checkpoint (" + _cli.CHECKPOINT_HELP + "); an image "
                        "K-Net's roi_head.* keys go to the video model's names")
    p.add_argument("--resume-from", default=None,
                   help="full train-state checkpoint directory (ckpt/step_N)")
    p.add_argument("--log-interval", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-insts", type=int, default=32)
    p.add_argument("--eval-interval", type=int, default=0,
                   help="run val VPQ/STQ every N epochs (0 = off)")
    p.add_argument("--eval-max-frames", type=int, default=None)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 forward/backward compute (fp32 master params)")
    p.add_argument("--freeze-detector", action="store_true",
                   help="non-joint two-phase mode: train only track/link layers")
    return p.parse_args(argv)


def load_weights(model, path: str, video: bool = False) -> None:
    """`--load-from`: `path`'s model state merged over `model`'s (BatchNorm
    statistics included, as the reference's load_checkpoint loads them);
    with `video`, an image K-Net's `roi_head.*` keys are moved first."""
    from video_knet_tpu_torch.utils.checkpoint import (
        image_to_video_params,
        load_model_state,
        merge_params,
    )

    loaded = load_model_state(path)
    if video and any(k.startswith("roi_head.") for k in loaded):
        loaded = image_to_video_params(loaded)
    unknown = sorted(set(loaded) - set(model.state_dict()))
    if unknown:
        raise KeyError(f"{path}: keys the model does not have: {unknown[:8]}")
    model.load_state_dict(merge_params(model.state_dict(), loaded), strict=True)


def host_losses(losses: dict) -> dict:
    """The loss dict as Python floats, read off the device in one copy."""
    vals = torch.stack([v.float() for v in losses.values()]).tolist()
    return dict(zip(losses, vals))


def main(argv=None, stats: list | None = None):
    """`stats`: optional list, appended time.perf_counter() after each step
    (after its log record, if it has one)."""
    args = parse_args(argv)
    from video_knet_tpu_torch.config import kitti_step_video_config, vipseg_video_config
    from video_knet_tpu_torch.data.datasets import KittiStepDVPS, VIPSegDVPS
    from video_knet_tpu_torch.data.loader import VPSTrainLoader
    from video_knet_tpu_torch.models.video.knet_vps import VideoKNet
    from video_knet_tpu_torch.train.optim import make_optimizer
    from video_knet_tpu_torch.train.train_state import create_train_state
    from video_knet_tpu_torch.train.vps import train_step
    from video_knet_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
    from video_knet_tpu_torch.utils.preemption import PreemptionGuard

    device = _cli.setup_device(args.device)
    cfg = (kitti_step_video_config() if args.dataset == "kitti_step"
           else vipseg_video_config())
    cfg = dataclasses.replace(cfg, backbone=args.backbone, max_insts=args.max_insts,
                              bf16_train=args.bf16)

    ds_cls = KittiStepDVPS if args.dataset == "kitti_step" else VIPSegDVPS
    ds = ds_cls(args.data_root, split="train", ref_seq_index=list(cfg.ref_seq_index),
                seed=args.seed)
    loader = VPSTrainLoader(ds, cfg, batch_size=args.batch_size, crop_hw=tuple(args.crop),
                            seed=args.seed, device=device)
    steps_per_epoch = max(1, len(ds) // args.batch_size)

    model = VideoKNet(cfg, generator=torch.Generator().manual_seed(args.seed), device=device)
    if args.load_from:
        load_weights(model, args.load_from, video=True)
    tx = make_optimizer(model, steps_per_epoch, base_lr=args.lr,
                        freeze_detector=args.freeze_detector)
    state = create_train_state(model, tx)
    if args.resume_from:
        state = restore_checkpoint(args.resume_from, state)

    os.makedirs(args.work_dir, exist_ok=True)
    log_path = os.path.join(args.work_dir, "train_log.jsonl")
    ckpt_dir = os.path.join(args.work_dir, "ckpt")
    print(f"devices: 1 | steps/epoch: {steps_per_epoch}")

    guard = PreemptionGuard()
    try:
        start_epoch = state.step // steps_per_epoch
        loader.skip_epochs(start_epoch)  # the data order an unbroken run would see
        for epoch in range(start_epoch, args.epochs):
            t0 = time.time()
            for it, batch in enumerate(loader):
                state, losses = train_step(state, batch)
                if guard.requested:
                    save_checkpoint(ckpt_dir, state, step=state.step)
                    print("preemption checkpoint written; exiting")
                    return
                if (it + 1) % args.log_interval == 0:
                    rate = args.batch_size * (it + 1) / (time.time() - t0)
                    rec = dict(epoch=epoch, iter=it + 1, imgs_per_sec=round(rate, 2),
                               **{k: round(v, 4) for k, v in host_losses(losses).items()})
                    print(json.dumps(rec))
                    with open(log_path, "a") as f:
                        f.write(json.dumps(rec) + "\n")
                if stats is not None:
                    stats.append(time.perf_counter())
            save_checkpoint(ckpt_dir, state, step=epoch + 1)
            print(f"epoch {epoch + 1} done in {time.time() - t0:.1f}s")
            if args.eval_interval and (epoch + 1) % args.eval_interval == 0:
                _eval(args, cfg, ds_cls, model, device, epoch, log_path)
    finally:
        guard.restore()


def _eval(args, cfg, ds_cls, model, device, epoch: int, log_path: str) -> None:
    """VPQ / STQ of the trained weights on the val split at the crop size:
    the `eval:` line and an `{"eval": ...}` record."""
    from video_knet_tpu_torch.models.video.inference import VPSInferencePipeline
    from video_knet_tpu_torch.train.eval_hook import evaluate_vps

    h, w = args.crop
    try:
        val_ds = ds_cls(args.data_root, split="val")
    except FileNotFoundError:
        print("eval skipped: no val split found")
        return
    pipe = VPSInferencePipeline(model, cfg, out_hw=(h, w), device=device)
    metrics = evaluate_vps(pipe, val_ds, size_hw=(h, w), max_frames=args.eval_max_frames,
                           num_classes=cfg.num_classes)
    rec = {"epoch": epoch + 1,
           **{k: round(float(v), 4) for k, v in metrics.items()
              if not hasattr(v, "shape") or v.shape == ()}}
    print("eval:", json.dumps(rec))
    with open(log_path, "a") as f:
        f.write(json.dumps({"eval": rec}) + "\n")


if __name__ == "__main__":
    main()
