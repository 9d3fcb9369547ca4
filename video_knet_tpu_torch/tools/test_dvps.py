"""Depth-aware VPS inference (SemKITTI-DVPS): panoptic + depth dumps for DSTQ.

Counterpart of the reference package's `tools/test_dvps.py` (the same
arguments, files and printed lines, plus `--device`): per frame, run the
online VPS step, dump `{out}/panoptic/{seq}/{frame}_cat.png` + `_ins.png`,
and `{out}/depth/{seq}/{frame}.png` as uint16 metres*256, so that
`eval_dstq` scores DSTQ end to end. The released models predict no depth:
`--depth-source gt` passes the GT depth through (clipped at 80 m).

Usage:
  python -m video_knet_tpu_torch.tools.test_dvps --data-root data/semkitti-dvps \\
      --out out/dvps [--split val] [--depth-source gt] [--device cpu]
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from video_knet_tpu_torch.tools import _cli


def parse_args(argv=None):
    p = _cli.parser(__doc__.splitlines()[0])
    p.add_argument("--data-root", required=True)
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--checkpoint", default=None, help=_cli.CHECKPOINT_HELP)
    p.add_argument("--split", default="val")
    p.add_argument("--out", required=True)
    p.add_argument("--size", type=int, nargs=2, default=[384, 1248])
    p.add_argument("--depth-source", default="gt", choices=["gt", "none"])
    p.add_argument("--max-frames", type=int, default=None)
    return p.parse_args(argv)


def main(argv=None, stats: list | None = None):
    """`stats`: optional list, appended time.perf_counter() as each frame's
    files are written."""
    args = parse_args(argv)
    from video_knet_tpu_torch.config import semkitti_video_config
    from video_knet_tpu_torch.data.datasets import SemKITTIDVPS
    from video_knet_tpu_torch.data.panoptic_png import load_png, save_png
    from video_knet_tpu_torch.data.transforms import keep_ratio_resize_pad, nearest_resize
    from video_knet_tpu_torch.models.video.inference import VPSInferencePipeline
    from video_knet_tpu_torch.models.video.knet_vps import VideoKNet

    device = _cli.setup_device(args.device)
    cfg = dataclasses.replace(semkitti_video_config(), backbone=args.backbone)
    ds = SemKITTIDVPS(args.data_root, split=args.split, with_depth=True)
    model = _cli.build_model(VideoKNet, cfg, device, args.checkpoint)
    h, w = args.size
    pipe = VPSInferencePipeline(model, cfg, (h, w), thing_ids_in_orig=tuple(ds.thing_ids_in_seg),
                                device=device)

    os.makedirs(args.out, exist_ok=True)
    n = 0
    t0 = time.time()
    pairs = list(ds.iter_test())
    if args.max_frames is not None:
        pairs = pairs[: args.max_frames]
    flags = [f for _, f in pairs]
    meta: list = []

    def frames():
        for sample, _ in pairs:
            rgb = load_png(sample.img)
            x, content = keep_ratio_resize_pad(rgb, (h, w))
            meta.append((rgb.shape[:2], content))
            yield torch.from_numpy(x)[None]

    # results come in frame order, so meta[i] is frame i's whatever the
    # pipeline's look-ahead
    for i, res in enumerate(pipe.run_sequence(frames(), flags)):
        sample = pairs[i][0]
        ori_hw, (ch, cw) = meta[i]
        seq_dir = os.path.join(args.out, "panoptic", str(sample.seq_id))
        dep_dir = os.path.join(args.out, "depth", str(sample.seq_id))
        os.makedirs(seq_dir, exist_ok=True)
        os.makedirs(dep_dir, exist_ok=True)
        sem = nearest_resize(res.semantic_map.astype(np.int32)[:ch, :cw], ori_hw)
        trk = nearest_resize(res.track_map.astype(np.int32)[:ch, :cw], ori_hw)
        stem = f"{sample.img_id:06d}"
        save_png(os.path.join(seq_dir, stem + "_cat.png"), sem.astype(np.uint8))
        save_png(os.path.join(seq_dir, stem + "_ins.png"), (trk % 65536).astype(np.uint16))

        depth_pred = None
        if args.depth_source == "gt" and sample.depth and os.path.exists(sample.depth):
            # GT passthrough: uint16 metres*256, clipped at 80 m like the
            # reference loader (dvps_pipelines/loading.py:121-124)
            d = load_png(sample.depth).astype(np.float64) / 256.0
            depth_pred = np.clip(d, 0.0, 80.0)
        if depth_pred is not None:
            save_png(os.path.join(dep_dir, stem + ".png"), (depth_pred * 256.0).astype(np.uint16))
        n += 1
        if stats is not None:
            stats.append(time.perf_counter())
        if n % 50 == 0:
            print(f"{n} frames, {n / (time.time() - t0):.2f} fps")
    print(f"done: {n} frames in {time.time() - t0:.1f}s -> {args.out}")


if __name__ == "__main__":
    main()
