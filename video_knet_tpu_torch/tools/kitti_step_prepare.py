"""Reorganize raw KITTI-STEP into video_sequence/{train,val}.

Counterpart of the reference package's `scripts/kitti_step_prepare.py` (the
same arguments, split, names and printed lines): copies images and
panoptic GT from `{seq:04d}/{frame:06d}.png` into flat
`{seq:06d}_{frame:06d}_leftImg8bit.png` / `_panoptic.png` names under
video_sequence/<split>, or symlinks them with `--symlink`, using the
standard STEP split (train [0,1,3,4,5,9,11,12,15,17,19,20], val
[2,6,7,8,10,13,14,16,18]). `data/datasets.py:KittiStepDVPS` reads the
result. Host only: no device.

Usage:
  python -m video_knet_tpu_torch.tools.kitti_step_prepare \\
      --raw-images kitti/training/image_02 \\
      --raw-panoptic kitti_step/panoptic_maps/train --out data/kitti-step
"""

from __future__ import annotations

import argparse
import os
import shutil

TRAIN_SEQS = [0, 1, 3, 4, 5, 9, 11, 12, 15, 17, 19, 20]
VAL_SEQS = [2, 6, 7, 8, 10, 13, 14, 16, 18]


def link_or_copy(src: str, dst: str, symlink: bool) -> None:
    if symlink:
        if os.path.lexists(dst):
            os.remove(dst)
        os.symlink(os.path.abspath(src), dst)
    else:
        shutil.copyfile(src, dst)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--raw-images", required=True,
                   help="dir with {seq:04d}/{frame:06d}.png images")
    p.add_argument("--raw-panoptic", required=True,
                   help="dir with {seq:04d}/{frame:06d}.png panoptic maps")
    p.add_argument("--out", required=True)
    p.add_argument("--symlink", action="store_true")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    for split, seqs in (("train", TRAIN_SEQS), ("val", VAL_SEQS)):
        out_dir = os.path.join(args.out, "video_sequence", split)
        os.makedirs(out_dir, exist_ok=True)
        for seq in seqs:
            img_dir = os.path.join(args.raw_images, f"{seq:04d}")
            pan_dir = os.path.join(args.raw_panoptic, f"{seq:04d}")
            if not os.path.isdir(img_dir):
                print(f"skip missing {img_dir}")
                continue
            for name in sorted(os.listdir(img_dir)):
                frame = int(os.path.splitext(name)[0])
                stem = f"{seq:06d}_{frame:06d}"
                link_or_copy(os.path.join(img_dir, name),
                             os.path.join(out_dir, f"{stem}_leftImg8bit.png"), args.symlink)
                pan = os.path.join(pan_dir, name)
                if os.path.exists(pan):
                    link_or_copy(pan, os.path.join(out_dir, f"{stem}_panoptic.png"),
                                 args.symlink)
        print(f"{split}: done -> {out_dir}")


if __name__ == "__main__":
    main()
