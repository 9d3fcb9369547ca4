"""Dataset scanners for the DVPS video-sequence directory layout.

Counterpart of `video_knet_tpu/data/datasets.py` (the reference's dataset
classes, kitti_step_dvps.py:38 and vipseg_dvps.py:322): scan
`video_sequence/{split}` for image/panoptic PNG pairs, index frames by
(seq_id, img_id), and form (key, ref) training pairs by sampling one offset
from `ref_seq_index`; pairs whose ref frame does not exist are dropped (the
reference's kitti_step_dvps.py:92-108). Test mode returns frames in
sequence order with an `is_first` flag per sequence.

The samples hold paths only; decode + transform happen in the loader workers.
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass
from typing import Sequence


@dataclass(frozen=True)
class DVPSSample:
    seq_id: int
    img_id: int
    img: str
    ann: str | None
    depth: str | None = None


class _DVPSScan:
    """Directory scan shared by the STEP-style datasets."""

    img_token = "leftImg8bit"
    ann_token = "panoptic"
    depth_token = "depth"

    # label-space constants (overridden per dataset)
    num_thing_classes = 2
    num_stuff_classes = 17
    thing_ids_in_seg: Sequence[int] = (11, 13)
    no_obj_class = 255

    def __init__(
        self,
        data_root: str,
        split: str = "train",
        ref_seq_index: Sequence[int] | None = None,
        with_depth: bool = False,
        seed: int = 0,
    ):
        self.data_root = os.path.expanduser(data_root)
        seq_dir = os.path.join(self.data_root, "video_sequence", split)
        if not os.path.isdir(seq_dir):
            raise FileNotFoundError(seq_dir)
        self.ref_seq_index = list(ref_seq_index or [])
        self.with_depth = with_depth
        self._rng = random.Random(seed)

        frames: dict[tuple[int, int], DVPSSample] = {}
        for name in sorted(os.listdir(seq_dir)):
            if self.img_token not in name:
                continue
            seq_s, img_s, _ = name.split("_", maxsplit=2)
            full = os.path.join(seq_dir, name)
            ann = full.replace(self.img_token, self.ann_token)
            s = DVPSSample(
                seq_id=int(seq_s),
                img_id=int(img_s),
                img=full,
                ann=ann if os.path.exists(ann) else None,
                depth=full.replace(self.img_token, self.depth_token)
                if with_depth
                else None,
            )
            frames[(s.seq_id, s.img_id)] = s
        self.frames = frames
        self.order = sorted(frames.keys())

        if self.ref_seq_index:
            self.pairs = [
                k
                for k in self.order
                if any((k[0], k[1] + d) in frames for d in self.ref_seq_index)
            ]
        else:
            self.pairs = list(self.order)

    def __len__(self) -> int:
        return len(self.pairs)

    def get_pair(self, idx: int, rng=None) -> tuple[DVPSSample, DVPSSample]:
        """Key frame + one randomly-offset existing reference frame.

        Pass a per-sample numpy RandomState to make the draw independent of
        call order (required for the multi-threaded loader's determinism);
        falls back to the dataset-level RNG."""
        key = self.frames[self.pairs[idx]]
        if not self.ref_seq_index:
            return key, key
        choices = [
            d
            for d in self.ref_seq_index
            if (key.seq_id, key.img_id + d) in self.frames
        ]
        d = int(rng.choice(choices)) if rng is not None else self._rng.choice(choices)
        return key, self.frames[(key.seq_id, key.img_id + d)]

    def iter_test(self):
        """Yield (sample, is_first) in sequence order (online VPS inference)."""
        prev_seq = None
        for k in self.order:
            s = self.frames[k]
            yield s, s.seq_id != prev_seq
            prev_seq = s.seq_id


class KittiStepDVPS(_DVPSScan):
    """KITTI-STEP: 19 cityscapes classes, things = person(11), car(13).

    The reference's kitti_step_dvps.py:38-108. Panoptic GT is RGB-encoded
    (decode_kitti_panoptic). Train seqs [0,1,3,4,5,9,11,12,15,17,19,20], val
    [2,6,7,8,10,13,14,16,18] (the JAX repo's scripts/kitti_step_prepare.py).
    """

    CLASSES = (
        "road", "sidewalk", "building", "wall", "fence", "pole",
        "traffic light", "traffic sign", "vegetation", "terrain", "sky",
        "person", "rider", "car", "truck", "bus", "train", "motorcycle",
        "bicycle",
    )
    num_thing_classes = 2
    num_stuff_classes = 17
    thing_ids_in_seg = (11, 13)
    ann_mode = "kitti_rgb"


class VIPSegDVPS(_DVPSScan):
    """VIP-Seg: 124 classes (58 thing / 66 stuff).

    The reference's vipseg_dvps.py:322 (ref_seq_index [-2,-1,1,2], short-side-720
    resize). Supports the official layout ({root}/images/{video}/*.jpg +
    {root}/panomasks/{video}/*.png, scanned in sorted video order like
    vipseg_dvps.py:356-386) and falls back to the flat video_sequence layout.
    Raw panomasks decode through the vip2hb-equivalent remap into our
    things-first space (panoptic_png.decode_vipseg_panoptic).
    """

    num_thing_classes = 58
    num_stuff_classes = 66
    thing_ids_in_seg = tuple(range(58))  # things-first label space
    ann_mode = "vipseg"
    img_token = "img"
    ann_token = "panoptic"

    def __init__(self, data_root: str, split: str = "train",
                 ref_seq_index: Sequence[int] | None = None,
                 with_depth: bool = False, seed: int = 0):
        root = os.path.expanduser(data_root)
        img_root = os.path.join(root, "images")
        ann_root = os.path.join(root, "panomasks")
        if not os.path.isdir(img_root):
            super().__init__(data_root, split, ref_seq_index, with_depth, seed)
            return
        self.data_root = root
        self.ref_seq_index = list(ref_seq_index or [])
        self.with_depth = with_depth
        self._rng = random.Random(seed)
        split_file = os.path.join(root, f"{split}.txt")
        if os.path.exists(split_file):
            with open(split_file) as f:
                videos = [l.strip() for l in f if l.strip()]
        else:
            videos = sorted(os.listdir(img_root))
        frames: dict[tuple[int, int], DVPSSample] = {}
        for seq_id, vid in enumerate(videos):
            vdir = os.path.join(img_root, vid)
            adir = os.path.join(ann_root, vid)
            imgs = sorted(f for f in os.listdir(vdir) if f.endswith(".jpg"))
            for img_id, fn in enumerate(imgs):
                ann = os.path.join(adir, fn.replace(".jpg", ".png"))
                frames[(seq_id, img_id)] = DVPSSample(
                    seq_id=seq_id, img_id=img_id,
                    img=os.path.join(vdir, fn),
                    ann=ann if os.path.exists(ann) else None,
                )
        self.frames = frames
        self.order = sorted(frames.keys())
        if self.ref_seq_index:
            self.pairs = [
                k for k in self.order
                if any((k[0], k[1] + d) in frames for d in self.ref_seq_index)
            ]
        else:
            self.pairs = list(self.order)


class SemKITTIDVPS(_DVPSScan):
    """SemKITTI-DVPS: depth-aware panoptic sequences with class/instance GT in
    SEPARATE single-channel PNGs (`*_gtFine_class.png` / `*_gtFine_instance.png`,
    the reference's "divisor = 0" mode, semkitti_dvps.py:76-85,227).
    19 cityscapes-style classes with 8 thing classes (11..18)."""

    num_thing_classes = 8
    num_stuff_classes = 11
    thing_ids_in_seg = tuple(range(11, 19))
    ann_mode = "class_instance"
    ann_token = "gtFine_class"

    def __init__(self, data_root: str, split: str = "train",
                 ref_seq_index=None, with_depth: bool = True, seed: int = 0):
        super().__init__(data_root, split, ref_seq_index, with_depth, seed)

    @staticmethod
    def ann_paths(img_path: str) -> tuple[str, str]:
        return (
            img_path.replace("leftImg8bit", "gtFine_class"),
            img_path.replace("leftImg8bit", "gtFine_instance"),
        )


class VSPWDataset:
    """VSPW video semantic segmentation (poster Table 4's VSS benchmark).

    Layout: {root}/data/{video}/origin/*.jpg + {root}/data/{video}/mask/*.png,
    with split lists {root}/{train,val,test}.txt. 124 classes, labels 1-based in
    the PNGs (0 = void); returned semantic maps are 0-based with 255 = void.
    """

    num_classes = 124
    ignore_label = 255

    def __init__(self, data_root: str, split: str = "val"):
        self.data_root = os.path.expanduser(data_root)
        list_file = os.path.join(self.data_root, f"{split}.txt")
        if os.path.exists(list_file):
            with open(list_file) as f:
                videos = [l.strip() for l in f if l.strip()]
        else:
            videos = sorted(os.listdir(os.path.join(self.data_root, "data")))
        self.videos: list[tuple[str, list[tuple[str, str | None]]]] = []
        for v in videos:
            vdir = os.path.join(self.data_root, "data", v)
            odir = os.path.join(vdir, "origin")
            mdir = os.path.join(vdir, "mask")
            if not os.path.isdir(odir):
                continue
            frames = []
            for name in sorted(os.listdir(odir)):
                stem = os.path.splitext(name)[0]
                mask = os.path.join(mdir, stem + ".png")
                frames.append(
                    (os.path.join(odir, name), mask if os.path.exists(mask) else None)
                )
            self.videos.append((v, frames))

    def __len__(self):
        return len(self.videos)

    @staticmethod
    def decode_mask(arr):
        import numpy as np

        sem = arr.astype(np.int32) - 1  # 1-based -> 0-based
        sem[arr == 0] = 255
        return sem


class CityscapesSTEPImages:
    """Cityscapes-STEP single-frame panoptic (image K-Net pretraining surface).

    Mirrors the reference's cityscapes_step.py:12: standard cityscapes leftImg8bit tree +
    STEP panoptic GT; exposes the same 19-class / 2-thing label space as KITTI-STEP.
    """

    CLASSES = KittiStepDVPS.CLASSES
    num_thing_classes = 2
    num_stuff_classes = 17
    thing_ids_in_seg = (11, 13)

    def __init__(self, data_root: str, split: str = "train"):
        self.data_root = os.path.expanduser(data_root)
        img_dir = os.path.join(self.data_root, "leftImg8bit", split)
        ann_dir = os.path.join(self.data_root, "panoptic", split)
        if not os.path.isdir(img_dir):
            raise FileNotFoundError(img_dir)
        self.samples: list[DVPSSample] = []
        for city in sorted(os.listdir(img_dir)):
            for name in sorted(os.listdir(os.path.join(img_dir, city))):
                img = os.path.join(img_dir, city, name)
                ann = os.path.join(
                    ann_dir, city, name.replace("leftImg8bit", "panoptic")
                )
                self.samples.append(
                    DVPSSample(
                        seq_id=0,
                        img_id=len(self.samples),
                        img=img,
                        ann=ann if os.path.exists(ann) else None,
                    )
                )

    def __len__(self):
        return len(self.samples)
