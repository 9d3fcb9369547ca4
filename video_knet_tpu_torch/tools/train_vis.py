"""Train Video K-Net VIS on YouTube-VIS on every visible GPU.

Counterpart of the reference package's `tools/train_vis.py` (the same
arguments and printed lines, plus `--device` and the process-group flags):
the YouTube-VIS 2019 config (KNetTrack clip training) over a COCO-VID json
(`youtubevis2coco`), the threaded clip loader, train steps over the data
mesh, a JSON record every `--log-interval` steps and a checkpoint a epoch
in `work_dir/ckpt/step_{epoch}`. Under torchrun `--batch-size` is the
global batch and each rank loads and trains its clips of it, as
`tools/train_vps.py` does; rank 0 alone prints and checkpoints. The
reference's clip parallelism over the mesh's `model` axis is ROADMAP F7b.

Usage:
  python -m video_knet_tpu_torch.tools.train_vis --ann-file train.json \\
      --img-root train/JPEGImages --epochs 12 --batch-size 4 [--crop 360 640] \\
      [--device cpu]
  torchrun --nproc_per_node=8 -m video_knet_tpu_torch.tools.train_vis ... \\
      [--dist-backend gloo] [--dist-url file:///shared/path]
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
    p.add_argument("--ann-file", required=True)
    p.add_argument("--img-root", default=None)
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--crop", type=int, nargs=2, default=[360, 640])
    p.add_argument("--num-frames", type=int, default=5)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--work-dir", default="work_dirs/vis")
    p.add_argument("--load-from", default=None, help=_cli.CHECKPOINT_HELP)
    p.add_argument("--log-interval", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    _cli.add_dist_args(p)
    return p.parse_args(argv)


def main(argv=None, stats: list | None = None):
    """`stats`: optional list, appended time.perf_counter() after each step
    (after its log record, if it has one)."""
    args = parse_args(argv)
    from video_knet_tpu_torch.config_vis import youtube_vis_2019_config
    from video_knet_tpu_torch.data.vis_loader import VISTrainLoader
    from video_knet_tpu_torch.data.ytvis import YouTubeVISDataset
    from video_knet_tpu_torch.models.vis.knet_vis import KNetVIS
    from video_knet_tpu_torch.parallel import distributed
    from video_knet_tpu_torch.tools.train_vps import _quiet, host_losses, load_weights
    from video_knet_tpu_torch.train.optim import make_optimizer
    from video_knet_tpu_torch.train.train_state import create_train_state
    from video_knet_tpu_torch.train.vis import train_step
    from video_knet_tpu_torch.utils.checkpoint import save_checkpoint

    device, mesh = _cli.setup_ranks(args)
    say = print if mesh.rank == 0 else _quiet
    cfg = dataclasses.replace(youtube_vis_2019_config(), backbone=args.backbone,
                              num_frames=args.num_frames)
    ds = YouTubeVISDataset(args.ann_file, img_root=args.img_root)
    loader = VISTrainLoader(ds, cfg, batch_size=args.batch_size, canvas_hw=tuple(args.crop),
                            seed=args.seed, device=device, mesh=mesh)
    steps_per_epoch = max(1, len(ds) // args.batch_size)

    model = KNetVIS(cfg, generator=torch.Generator().manual_seed(args.seed), device=device)
    if args.load_from:
        load_weights(model, args.load_from)
    state = create_train_state(model, make_optimizer(model, steps_per_epoch, base_lr=args.lr),
                               mesh)
    if mesh.rank == 0:
        os.makedirs(args.work_dir, exist_ok=True)
    for epoch in range(args.epochs):
        t0 = time.time()
        for it, batch in enumerate(loader):
            state, losses = train_step(state, batch)
            if (it + 1) % args.log_interval == 0:
                say(json.dumps(dict(epoch=epoch, iter=it + 1, **{
                    k: round(v, 4) for k, v in host_losses(losses).items()})))
            if stats is not None:
                stats.append(time.perf_counter())
        if mesh.rank == 0:
            save_checkpoint(os.path.join(args.work_dir, "ckpt"), state, step=epoch + 1)
        distributed.barrier()
        say(f"epoch {epoch + 1} done in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
