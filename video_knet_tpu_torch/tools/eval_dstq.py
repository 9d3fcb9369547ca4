"""Depth-aware STQ (DSTQ) over dumped predictions vs DVPS GT.

Counterpart of the reference package's `tools/eval_dstq.py` (the same
arguments and printed line; numpy only): STQ statistics plus depth inlier
rates at the thresholds (1.25, 1.1); predicted depth PNGs (16-bit, value /
256 metres) are read from `{result}/depth/{seq}/`, GT depth from the GT dir.

Usage:
  python -m video_knet_tpu_torch.tools.eval_dstq RESULT_DIR \\
      --gt-dir data/semkitti-dvps/video_sequence/val --ann-mode class_instance
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("result_path")
    p.add_argument("--gt-dir", required=True)
    p.add_argument("--num-classes", type=int, default=19)
    p.add_argument("--thing-ids", type=int, nargs="+", default=[11, 13])
    p.add_argument("--ann-mode", default="kitti_rgb",
                   choices=["kitti_rgb", "vipseg", "divisor", "class_instance"])
    p.add_argument("--depth-thresholds", type=float, nargs="+", default=[1.25, 1.1])
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from video_knet_tpu_torch.data.panoptic_png import decode_panoptic_ann, load_png
    from video_knet_tpu_torch.eval.stq import DSTQuality
    from video_knet_tpu_torch.tools.eval_stq import gt_files

    dstq = DSTQuality(num_classes=args.num_classes, things_list=list(args.thing_ids),
                      ignore_label=255, label_bit_shift=16, offset=2**25,
                      depth_threshold=tuple(args.depth_thresholds))
    pred_dir = os.path.join(args.result_path, "panoptic")
    depth_dir = os.path.join(args.result_path, "depth")
    ann_token = "gtFine_class" if args.ann_mode == "class_instance" else "panoptic"
    for seq in sorted(os.listdir(pred_dir), key=lambda s: int(s)):
        d = os.path.join(pred_dir, seq)
        cats = sorted(f for f in os.listdir(d) if f.endswith("_cat.png"))
        inss = sorted(f for f in os.listdir(d) if f.endswith("_ins.png"))
        gts = gt_files(args.gt_dir, seq, ann_token)
        dgts = gt_files(args.gt_dir, seq, "depth")
        seq_depth = os.path.join(depth_dir, seq)
        dpreds = sorted(os.listdir(seq_depth)) if os.path.isdir(seq_depth) else []
        for i, (cf, inf, gf) in enumerate(zip(cats, inss, gts)):
            sem_p = load_png(os.path.join(d, cf)).astype(np.int64)
            ins_p = load_png(os.path.join(d, inf)).astype(np.int64)
            sem_g, ins_g = decode_panoptic_ann(os.path.join(args.gt_dir, gf), args.ann_mode)
            d_true = d_pred = None
            if i < len(dgts) and i < len(dpreds):
                d_true = load_png(os.path.join(args.gt_dir, dgts[i])).astype(np.float64) / 256.0
                d_pred = load_png(os.path.join(seq_depth, dpreds[i])).astype(np.float64) / 256.0
            dstq.update_state((sem_g.astype(np.int64) << 16) + ins_g.astype(np.int64),
                              (sem_p << 16) + ins_p, d_true, d_pred, sequence_id=int(seq))
    r = dstq.result()
    keys = ["STQ", "AQ", "IoU"] + [k for k in r if k.startswith("DQ@")] + ["DSTQ"]
    print("  ".join(f"{k} {r[k]:.4f}" for k in keys if k in r))


if __name__ == "__main__":
    main()
