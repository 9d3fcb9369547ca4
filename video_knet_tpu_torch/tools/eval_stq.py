"""Offline STQ over dumped prediction PNGs vs DVPS GT.

Counterpart of the reference package's `tools/eval_stq.py` (the same
arguments and printed line; numpy only): per sequence, GT and prediction
encoded as (semantic << 16) + instance and accumulated by
`eval/stq.py:STQuality`.

Usage:
  python -m video_knet_tpu_torch.tools.eval_stq RESULT_DIR \\
      --gt-dir data/kitti-step/video_sequence/val
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
    return p.parse_args(argv)


def gt_files(gt_dir: str, seq: str, token: str) -> list[str]:
    """The flat layout's files of sequence `seq` whose names hold `token`."""
    return sorted(f for f in os.listdir(gt_dir) if f.startswith(f"{int(seq):06d}") and token in f)


def main(argv=None):
    args = parse_args(argv)
    from video_knet_tpu_torch.data.panoptic_png import decode_panoptic_ann, load_png
    from video_knet_tpu_torch.eval.stq import STQuality

    stq = STQuality(num_classes=args.num_classes, things_list=list(args.thing_ids),
                    ignore_label=255, label_bit_shift=16, offset=2**25)
    pred_dir = os.path.join(args.result_path, "panoptic")
    ann_token = "gtFine_class" if args.ann_mode == "class_instance" else "panoptic"
    for seq in sorted(os.listdir(pred_dir), key=lambda s: int(s)):
        d = os.path.join(pred_dir, seq)
        cats = sorted(f for f in os.listdir(d) if f.endswith("_cat.png"))
        inss = sorted(f for f in os.listdir(d) if f.endswith("_ins.png"))
        for cf, inf, gf in zip(cats, inss, gt_files(args.gt_dir, seq, ann_token)):
            sem_p = load_png(os.path.join(d, cf)).astype(np.int64)
            ins_p = load_png(os.path.join(d, inf)).astype(np.int64)
            sem_g, ins_g = decode_panoptic_ann(os.path.join(args.gt_dir, gf), args.ann_mode)
            y_pred = (sem_p << 16) + ins_p
            y_true = (sem_g.astype(np.int64) << 16) + ins_g.astype(np.int64)
            stq.update_state(y_true, y_pred, sequence_id=int(seq))
    r = stq.result()
    print(f"STQ {r['STQ']:.4f}  AQ {r['AQ']:.4f}  IoU(SQ) {r['IoU']:.4f}")


if __name__ == "__main__":
    main()
