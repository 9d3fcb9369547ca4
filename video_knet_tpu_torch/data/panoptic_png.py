"""Panoptic PNG encodings of the STEP / DVPS dataset family, and the port's
image reader and writer.

Counterpart of `video_knet_tpu/data/panoptic_png.py` (the reference's
`dvps_pipelines/loading.py:117-153`):
  - KITTI-STEP stores panoptic GT as RGB PNG: R = semantic class,
    G * 256 + B = instance id ("divisor = -1" mode).
  - VIP-Seg / Cityscapes-DVPS store a single-channel id map with
    panoptic_id = semantic * divisor + instance (divisor = 1000); raw ids
    < 1000 are pure-semantic pixels and are multiplied up.
  - "divisor = 0" mode stores class and instance in two separate PNGs.
Everything decodes to (semantic[int32], instance[int32]) pairs, the same
arrays as JAX's. `load_png` reads PNGs with the port's own codec
(`native/png_codec.py`), which needs no PIL; other files (VIP-Seg's and
VSPW's JPEG frames) go through a lazy PIL import, which raises naming the
file where PIL is missing.
"""

from __future__ import annotations

import numpy as np

from video_knet_tpu_torch.native import png_codec

PAN_DIVISOR = 10000  # canonical: pan_id = semantic * PAN_DIVISOR + instance


def decode_kitti_panoptic(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """RGB panoptic PNG -> (semantic, instance). rgb: [H, W, 3] uint8."""
    semantic = rgb[..., 0].astype(np.int32)
    instance = rgb[..., 1].astype(np.int32) * 256 + rgb[..., 2].astype(np.int32)
    return semantic, instance


def decode_divisor_panoptic(
    ids: np.ndarray, divisor: int = 1000, promote_bare_semantic: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """Single-channel id map -> (semantic, instance).

    promote_bare_semantic: VIPSeg/VIPER convention — raw values below the divisor
    are bare semantic labels and become (label, 0).
    """
    ids = ids.astype(np.int64)
    if promote_bare_semantic:
        ids = np.where(ids < divisor, ids * divisor, ids)
    return (ids // divisor).astype(np.int32), (ids % divisor).astype(np.int32)


# Raw VIPSeg category ids (0-based) by isthing flag, in dataset order
# (the reference's vipseg_dvps.py CLASSES table; 58 thing / 66 stuff).
VIPSEG_THING_IDS = (
    2, 4, 8, 10, 41, 43, 44, 46, 47, 48, 49, 50, 51, 52, 54, 55, 56, 60, 61,
    62, 63, 64, 65, 72, 74, 76, 77, 78, 79, 82, 83, 84, 85, 86, 87, 88, 89,
    90, 91, 92, 95, 96, 97, 99, 100, 101, 102, 106, 107, 108, 109, 114, 115,
    116, 117, 118, 122, 123,
)
VIPSEG_STUFF_IDS = (
    0, 1, 3, 5, 6, 7, 9, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23,
    24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 42,
    45, 53, 57, 58, 59, 66, 67, 68, 69, 70, 71, 73, 75, 80, 81, 93, 94, 98,
    103, 104, 105, 110, 111, 112, 113, 119, 120, 121,
)


def decode_vipseg_panoptic(raw: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Raw VIPSeg panomask -> (semantic, instance) in the things-first space.

    Raw encoding (the reference's vip2hb): 0 and 200 are void; values <= 128
    are bare semantic ids+1 (stuff); values > 128 encode a thing segment as
    (raw_cls_id+1)*100 + instance. Things map to 0..57 in VIPSEG_THING_IDS
    order, stuff to 58..123, void to 255.
    """
    raw = np.asarray(raw).astype(np.int64)
    lut_sem = np.full(256, 255, np.int32)  # idx = raw_id + 1
    for new, rid in enumerate(VIPSEG_THING_IDS):
        lut_sem[rid + 1] = new
    for new, rid in enumerate(VIPSEG_STUFF_IDS):
        lut_sem[rid + 1] = 58 + new
    sem = np.full(raw.shape, 255, np.int32)
    inst = np.zeros(raw.shape, np.int32)
    void = (raw == 0) | (raw == 200)
    thing = (raw > 128) & ~void
    bare = ~thing & ~void
    sem[thing] = lut_sem[np.clip(raw[thing] // 100, 0, 255)]
    inst[thing] = (raw[thing] % 100).astype(np.int32)
    sem[bare] = lut_sem[np.clip(raw[bare], 0, 255)]
    return sem, inst


def encode_two_channel_vps(semantic: np.ndarray, track: np.ndarray) -> np.ndarray:
    """(semantic, track-id) -> 3-channel uint8 image in the reference's dump
    format (ch0 = semantic, ch1 = track % 256, ch2 = track // 256)."""
    out = np.zeros((*semantic.shape, 3), np.uint8)
    out[..., 0] = semantic.astype(np.uint8)
    out[..., 1] = (track % 256).astype(np.uint8)
    out[..., 2] = (track // 256).astype(np.uint8)
    return out


def decode_panoptic_ann(path: str, mode: str) -> tuple[np.ndarray, np.ndarray]:
    """Decode a panoptic GT file by dataset mode -> (semantic, instance).

    Modes:
      kitti_rgb      — RGB PNG, R=class, G*256+B=instance (divisor=-1)
      class_instance — class and instance in separate PNGs (divisor=0);
                       `path` is the class map, instance map sits next to it
      vipseg         — raw VIP-Seg panomask with the vip2hb remap
      divisor        — single-channel semantic*1000+instance id map
    """
    arr = load_png(path)
    if mode == "kitti_rgb":
        return decode_kitti_panoptic(arr)
    if mode == "class_instance":
        inst_path = path.replace("gtFine_class", "gtFine_instance")
        return arr.astype(np.int32), load_png(inst_path).astype(np.int32)
    if mode == "vipseg":
        return decode_vipseg_panoptic(arr)
    return decode_divisor_panoptic(arr, promote_bare_semantic=True)


def load_png(path: str) -> np.ndarray:
    """Read an image file: a PNG through the port's codec (no PIL), any other
    file (a JPEG frame) through PIL, imported here."""
    with open(path, "rb") as f:
        is_png = f.read(8) == png_codec.MAGIC
    if is_png:
        return png_codec.read_png(path)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: not a PNG, and reading it needs PIL, which is not "
                          "installed") from e
    with Image.open(path) as im:
        return np.asarray(im)


def save_png(path: str, arr: np.ndarray) -> None:
    """Write uint8 gray or RGB, or uint16 gray, as a PNG (no PIL)."""
    png_codec.write_png(path, arr)
