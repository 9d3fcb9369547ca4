"""Video semantic segmentation (VSS) inference + mIoU / mVC evaluation.

Counterpart of the reference package's `tools/test_vss.py` (the same
arguments and printed lines, plus `--device`): the per-frame semantic map is
the class map of the VPS model's joint panoptic decode, scored with
`eval/miou.py:ConfusionMeter` and the mVC_k video-consistency metric.

Usage:
  python -m video_knet_tpu_torch.tools.test_vss --data-root data/kitti-step \\
      --checkpoint ckpt [--split val] [--device cpu]
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from video_knet_tpu_torch.tools import _cli


def parse_args(argv=None):
    p = _cli.parser(__doc__.splitlines()[0])
    p.add_argument("--data-root", required=True)
    p.add_argument("--dataset", default="kitti_step", choices=["kitti_step", "vipseg"])
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--checkpoint", default=None, help=_cli.CHECKPOINT_HELP)
    p.add_argument("--split", default="val")
    p.add_argument("--size", type=int, nargs=2, default=[384, 1248])
    p.add_argument("--vc-windows", type=int, nargs="+", default=[8, 16])
    return p.parse_args(argv)


def main(argv=None, stats: list | None = None):
    """`stats`: optional list, appended time.perf_counter() after each frame."""
    args = parse_args(argv)
    from video_knet_tpu_torch.config import kitti_step_video_config, vipseg_video_config
    from video_knet_tpu_torch.data.datasets import KittiStepDVPS, VIPSegDVPS
    from video_knet_tpu_torch.data.panoptic_png import decode_kitti_panoptic, load_png
    from video_knet_tpu_torch.data.transforms import (
        IMAGENET_MEAN,
        IMAGENET_STD,
        bilinear_resize,
        nearest_resize,
    )
    from video_knet_tpu_torch.eval.miou import ConfusionMeter, video_consistency
    from video_knet_tpu_torch.models.video.inference import VPSInferencePipeline
    from video_knet_tpu_torch.models.video.knet_vps import VideoKNet

    device = _cli.setup_device(args.device)
    cfg = kitti_step_video_config() if args.dataset == "kitti_step" else vipseg_video_config()
    cfg = dataclasses.replace(cfg, backbone=args.backbone)
    ds_cls = KittiStepDVPS if args.dataset == "kitti_step" else VIPSegDVPS
    ds = ds_cls(args.data_root, split=args.split)
    model = _cli.build_model(VideoKNet, cfg, device, args.checkpoint)
    h, w = args.size
    thing_ids = ds.thing_ids_in_seg if args.dataset == "kitti_step" else None
    pipe = VPSInferencePipeline(model, cfg, (h, w), thing_ids_in_orig=thing_ids, device=device)

    meter = ConfusionMeter(cfg.num_classes)
    seq_preds: dict[int, list] = {}
    seq_gts: dict[int, list] = {}
    for sample, is_first in ds.iter_test():
        rgb = load_png(sample.img)
        ori_hw = rgb.shape[:2]
        x = (bilinear_resize(rgb, (h, w)) - IMAGENET_MEAN) / IMAGENET_STD
        res = pipe.run_frame(torch.from_numpy(x)[None], is_first=is_first)
        sem = nearest_resize(res.semantic_map.astype(np.int32), ori_hw)
        seq_preds.setdefault(sample.seq_id, []).append(sem)
        if sample.ann:
            gt_sem, _ = decode_kitti_panoptic(load_png(sample.ann))
            seq_gts.setdefault(sample.seq_id, []).append(gt_sem.astype(np.int32))
            meter.update(sem, gt_sem)
        if stats is not None:
            stats.append(time.perf_counter())

    r = meter.result()
    print(f"mIoU {r['mIoU'] * 100:.1f}  aAcc {r['aAcc'] * 100:.1f}")
    for k in args.vc_windows:
        vcs = [video_consistency(seq_preds[s], seq_gts[s], window=k)
               for s in seq_gts if len(seq_gts[s]) >= k]
        if vcs:
            print(f"mVC{k} {np.nanmean(vcs) * 100:.1f}")


if __name__ == "__main__":
    main()
