"""The port's VPS data path against the JAX package's, on the CPU.

`video_knet_tpu_torch/data` (panoptic decoders, `load_png` / `save_png` on
the port's own PNG codec, the Seq transforms, `pack_panoptic_gt`, the
dataset scans and the threaded `VPSTrainLoader`) on the same inputs as
`video_knet_tpu/data`: seeded label maps, PNGs written by PIL in every mode
the datasets ship, fake dataset trees on `tmp_path` in every layout.

Every comparison here is exact: arrays equal bit for bit with the same
dtype, scans and draws equal as Python values.
"""

import os
import struct
import threading
import time
import zlib
from unittest import mock

import numpy as np
import pytest
import torch
import torch_port_common  # noqa: F401  (one torch thread)
from PIL import Image

from video_knet_tpu.config import VideoKNetConfig as JConfig
from video_knet_tpu.data import datasets as jds
from video_knet_tpu.data import panoptic_png as jpng
from video_knet_tpu.data import transforms as jtf
from video_knet_tpu.data.loader import VPSTrainLoader as JLoader
from video_knet_tpu_torch.config import VideoKNetConfig as TConfig
from video_knet_tpu_torch.data import datasets as tds
from video_knet_tpu_torch.data import panoptic_png as tpng
from video_knet_tpu_torch.data import transforms as ttf
from video_knet_tpu_torch.data.loader import VPSTrainLoader as TLoader
from video_knet_tpu_torch.native import png_codec
from video_knet_tpu_torch.tools.data_check import write_kitti_step_tree


def same(got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype,
                                                                 got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def same_gt(got, want) -> None:
    assert type(got).__name__ == type(want).__name__ == "PanopticGT"
    for field, g, w in zip(want._fields, got, want):
        same(g, w)


# ------------------------------------------------------------------ decoders

def test_decoders_match_jax():
    rng = np.random.RandomState(0)
    rgb = rng.randint(0, 256, (17, 23, 3)).astype(np.uint8)
    for got, want in zip(tpng.decode_kitti_panoptic(rgb), jpng.decode_kitti_panoptic(rgb)):
        same(got, want)
    ids = np.concatenate([rng.randint(0, 1000, (9, 23)),
                          rng.randint(0, 124, (8, 23)) * 1000 + rng.randint(0, 1000, (8, 23))])
    for promote in (False, True):
        for div in (1000, 256):
            for got, want in zip(tpng.decode_divisor_panoptic(ids, div, promote),
                                 jpng.decode_divisor_panoptic(ids, div, promote)):
                same(got, want)
    things = np.array(tpng.VIPSEG_THING_IDS)
    raw = np.stack([rng.randint(0, 130, (17, 23)),  # bare stuff ids + void 0
                    (things[rng.randint(0, len(things), (17, 23))] + 1) * 100
                    + rng.randint(0, 100, (17, 23))])
    raw[0, 0, :3] = 200
    raw = raw.astype(np.uint16)
    for got, want in zip(tpng.decode_vipseg_panoptic(raw), jpng.decode_vipseg_panoptic(raw)):
        same(got, want)
    assert tpng.VIPSEG_THING_IDS == jpng.VIPSEG_THING_IDS
    assert tpng.VIPSEG_STUFF_IDS == jpng.VIPSEG_STUFF_IDS
    assert tpng.PAN_DIVISOR == jpng.PAN_DIVISOR
    sem, trk = rng.randint(0, 19, (17, 23)), rng.randint(0, 70000, (17, 23))
    same(tpng.encode_two_channel_vps(sem, trk), jpng.encode_two_channel_vps(sem, trk))


@pytest.mark.parametrize("mode", ["kitti_rgb", "class_instance", "vipseg", "divisor"])
def test_decode_panoptic_ann_matches_jax(tmp_path, mode):
    rng = np.random.RandomState(1)
    path = str(tmp_path / "x_gtFine_class.png")
    if mode == "kitti_rgb":
        Image.fromarray(rng.randint(0, 256, (15, 21, 3)).astype(np.uint8)).save(path)
    elif mode == "class_instance":
        Image.fromarray(rng.randint(0, 19, (15, 21)).astype(np.uint8)).save(path)
        Image.fromarray(rng.randint(0, 9, (15, 21)).astype(np.uint16)).save(
            path.replace("gtFine_class", "gtFine_instance"))
    elif mode == "vipseg":
        raw = (np.array(tpng.VIPSEG_THING_IDS)[rng.randint(0, 58, (15, 21))] + 1) * 100 + 3
        raw[:5] = rng.randint(0, 129, (5, 21))
        Image.fromarray(raw.astype(np.uint16)).save(path)
    else:
        ids = rng.randint(0, 19, (15, 21)) * 1000 + rng.randint(0, 5, (15, 21))
        ids[:4] = rng.randint(0, 19, (4, 21))
        Image.fromarray(ids.astype(np.uint16)).save(path)
    for got, want in zip(tpng.decode_panoptic_ann(path, mode),
                         jpng.decode_panoptic_ann(path, mode)):
        same(got, want)


# ---------------------------------------------------------- load_png / save_png

def _pil_image(kind: str, rng) -> Image.Image:
    hw = (13, 19)
    if kind == "L":
        return Image.fromarray(rng.randint(0, 256, hw).astype(np.uint8))
    if kind == "LA":
        return Image.fromarray(rng.randint(0, 256, (*hw, 2)).astype(np.uint8), "LA")
    if kind in ("RGB", "JPEG"):
        return Image.fromarray(rng.randint(0, 256, (*hw, 3)).astype(np.uint8))
    if kind == "RGBA":
        return Image.fromarray(rng.randint(0, 256, (*hw, 4)).astype(np.uint8))
    if kind == "P":
        rgb = Image.fromarray(rng.randint(0, 256, (*hw, 3)).astype(np.uint8))
        return rgb.convert("P", palette=Image.ADAPTIVE, colors=40)
    return Image.fromarray(rng.randint(0, 65536, hw).astype(np.uint16))  # I;16


@pytest.mark.parametrize("kind", ["L", "LA", "RGB", "RGBA", "P", "I16", "JPEG"])
def test_load_png_matches_jax(tmp_path, kind):
    """PIL-written files in every mode the datasets ship; a PNG is read by the
    port's codec (no PIL), a JPEG through PIL as JAX reads it."""
    im = _pil_image(kind, np.random.RandomState(len(kind)))
    path = str(tmp_path / ("f.jpg" if kind == "JPEG" else "f.png"))
    im.save(path)
    want = jpng.load_png(path)
    same(tpng.load_png(path), want)
    if kind != "JPEG":  # a PNG never touches PIL
        with mock.patch.dict("sys.modules", {"PIL": None, "PIL.Image": None}):
            same(tpng.load_png(path), want)


def _interlaced(data: bytes) -> bytes:
    """`data` with the IHDR's interlace flag set, CRC redone."""
    body = data[16:28] + b"\x01"
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + body) & 0xFFFFFFFF)
    return data[:16] + body + crc + data[33:]


@pytest.mark.parametrize("case", ["interlaced", "4-bit palette", "1-bit gray"])
def test_load_png_raises_on_unsupported(tmp_path, case):
    path = str(tmp_path / "u.png")
    if case == "interlaced":
        data = png_codec.encode_png(np.zeros((4, 6), np.uint8))
        with open(path, "wb") as f:
            f.write(_interlaced(data))
    elif case == "4-bit palette":
        _pil_image("P", np.random.RandomState(0)).save(path, bits=4)
    else:
        Image.fromarray(np.random.RandomState(0).rand(7, 9) > 0.5).save(path)
    with pytest.raises(ValueError, match="u.png"):
        tpng.load_png(path)


def test_load_png_of_a_jpeg_without_pil_names_the_file(tmp_path):
    path = str(tmp_path / "frame.jpg")
    _pil_image("JPEG", np.random.RandomState(0)).save(path)
    with mock.patch.dict("sys.modules", {"PIL": None, "PIL.Image": None}):
        with pytest.raises(ImportError, match="frame.jpg"):
            tpng.load_png(path)


@pytest.mark.parametrize("kind", ["gray", "rgb", "uint16"])
def test_save_png_reads_back_through_pil_and_jax(tmp_path, kind):
    rng = np.random.RandomState(3)
    arr = {"gray": lambda: rng.randint(0, 256, (11, 29)).astype(np.uint8),
           "rgb": lambda: rng.randint(0, 256, (11, 29, 3)).astype(np.uint8),
           "uint16": lambda: rng.randint(0, 65536, (11, 29)).astype(np.uint16)}[kind]()
    path = str(tmp_path / "s.png")
    tpng.save_png(path, arr)
    same(np.asarray(Image.open(path)), arr)
    same(jpng.load_png(path), arr)
    same(png_codec.read_png(path), arr)


def test_save_png_rejects_other_dtypes(tmp_path):
    for arr in (np.zeros((3, 4), np.int32), np.zeros((3, 4, 3), np.uint16),
                np.zeros((3, 4, 4), np.uint8), np.zeros((3, 4, 2), np.uint8), np.zeros(5, np.uint8)):
        with pytest.raises(ValueError):
            tpng.save_png(str(tmp_path / "r.png"), arr)


def test_codec_unfilters_every_filter_type():
    """PIL picks one filter a row; force each of the five through a hand-made
    stream (every row's filter from the seed) against a numpy reference."""
    rng = np.random.RandomState(5)
    h, w, bpp = 25, 7, 3
    stride = w * bpp
    # few distinct values: Paeth's ties (pa == pb, pb == pc) occur often
    rows = rng.randint(0, 4, (h, stride)).astype(np.int64)
    filters = np.arange(h) % 5
    raw = bytearray()
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        cur, f = rows[y], filters[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        pred = [np.zeros(stride, np.int64), left, prev, (left + prev) // 2,
                np.array([_paeth(a, b, c) for a, b, c in zip(left, prev, ul)])][f]
        raw += bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    data = (png_codec.MAGIC + png_codec._chunk(b"IHDR", header)
            + png_codec._chunk(b"IDAT", zlib.compress(bytes(raw))) + png_codec._chunk(b"IEND", b""))
    same(png_codec.decode_png(data), rows.reshape(h, w, 3).astype(np.uint8))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


# ---------------------------------------------------------------- transforms

@pytest.mark.parametrize("shape,out_hw", [((60, 90, 3), (31, 47)), ((37, 53), (80, 101)),
                                          ((21, 33, 3), (21, 33)), ((8, 12), (3, 5))])
def test_resizes_match_jax(shape, out_hw):
    rng = np.random.RandomState(sum(shape))
    x = rng.randint(0, 256, shape).astype(np.uint8)
    same(ttf.bilinear_resize(x, out_hw), jtf.bilinear_resize(x, out_hw))
    same(ttf.nearest_resize(x, out_hw), jtf.nearest_resize(x, out_hw))
    for mean in (ttf.IMAGENET_MEAN, None):
        if len(shape) == 3:
            got = ttf.keep_ratio_resize_pad(x, out_hw, mean=mean, std=ttf.IMAGENET_STD)
            want = jtf.keep_ratio_resize_pad(x, out_hw, mean=mean, std=jtf.IMAGENET_STD)
            same(got[0], want[0])
            assert got[1] == want[1]
    same(ttf.IMAGENET_MEAN, jtf.IMAGENET_MEAN)
    same(ttf.IMAGENET_STD, jtf.IMAGENET_STD)


PARAMS = [dict(scale=1.3, flip=True, crop_y=0.5, crop_x=0.25),  # flip, crop
          dict(scale=0.5, flip=False, crop_y=0.0, crop_x=0.9),  # downscale, pad
          dict(scale=1.7, flip=True, crop_y=0.99, crop_x=0.01, img_scale=(64, 96)),
          dict(scale=0.6, flip=True, crop_y=0.3, crop_x=0.7, img_scale=(96, 64))]


@pytest.mark.parametrize("p", PARAMS)
@pytest.mark.parametrize("in_hw,crop_hw", [((60, 90), (64, 96)), ((45, 77), (33, 51))])
def test_seq_transforms_match_jax(p, in_hw, crop_hw):
    rng = np.random.RandomState(in_hw[0])
    img = rng.randint(0, 256, (*in_hw, 3)).astype(np.uint8)
    lab = rng.randint(0, 19, in_hw).astype(np.int32)
    tp, jp = ttf.SeqTransformParams(**p), jtf.SeqTransformParams(**p)
    assert ttf._resolve_geometry(in_hw, crop_hw, tp) == jtf._resolve_geometry(in_hw, crop_hw, jp)
    same(ttf.apply_image_transform(img, tp, crop_hw), jtf.apply_image_transform(img, jp, crop_hw))
    for pad in (255, 0):
        same(ttf.apply_mask_transform(lab, tp, crop_hw, pad_value=pad),
             jtf.apply_mask_transform(lab, jp, crop_hw, pad_value=pad))


def test_sample_transform_params_matches_jax():
    for img_scale in (None, (384, 1248)):
        a, b = np.random.RandomState(11), np.random.RandomState(11)
        for _ in range(5):
            got = ttf.sample_transform_params(a, img_scale=img_scale)
            want = jtf.sample_transform_params(b, img_scale=img_scale)
            assert (got.scale, got.flip, got.crop_y, got.crop_x, got.img_scale) == \
                (want.scale, want.flip, want.crop_y, want.crop_x, want.img_scale)
        got = ttf.sample_transform_params(a, ratio_range=(0.8, 1.2), flip_prob=0.0)
        want = jtf.sample_transform_params(b, ratio_range=(0.8, 1.2), flip_prob=0.0)
        assert got.scale == want.scale and got.flip == want.flip is False


@pytest.mark.parametrize("max_insts,stride", [(4, 2), (16, 4)])
def test_pack_panoptic_gt_matches_jax(max_insts, stride):
    """More thing instances (9) than 4 slots, void, two thing classes, stuff
    classes present and absent, an odd map size."""
    rng = np.random.RandomState(max_insts)
    h, w = 37, 58
    sem = rng.choice([0, 2, 8, 10], size=(h, w)).astype(np.int32)
    inst = np.zeros((h, w), np.int32)
    for k in range(9):
        y, x = rng.randint(0, h - 8), rng.randint(0, w - 8)
        sem[y:y + 8, x:x + 10] = (11, 13)[k % 2]
        inst[y:y + 8, x:x + 10] = k + 1
    sem[:3, :5] = 255
    kw = dict(thing_ids_in_seg=(11, 13), num_stuff_classes=17, max_insts=max_insts,
              assign_stride=stride)
    got, want = ttf.pack_panoptic_gt(sem, inst, **kw), jtf.pack_panoptic_gt(sem, inst, **kw)
    same_gt(got, want)
    assert int(got.valid.sum()) == min(max_insts, 9)


# ------------------------------------------------------------- dataset scans

def _write_kitti(root, n_seqs=2, n_frames=4, hw=(48, 80), split="train", no_ann=()):
    """KITTI-STEP flat layout (`tools/data_check.py`): RGB frames, `kitti_rgb`
    panoptic PNGs with stuff bands and 6 overlapping moving person / car
    boxes; frames in `no_ann` ((seq, frame) pairs) have no panoptic file."""
    write_kitti_step_tree(str(root), n_seqs=n_seqs, n_frames=n_frames, hw=hw, n_things=6,
                          split=split, no_ann=tuple(no_ann))
    return str(root)


def _write_vipseg_official(root, n_videos=2, n_frames=3, hw=(32, 48), split_file=None,
                           drop_last_mask=True):
    rng = np.random.RandomState(1)
    for v in range(n_videos):
        vdir = os.path.join(str(root), "images", f"vid{v:03d}")
        adir = os.path.join(str(root), "panomasks", f"vid{v:03d}")
        os.makedirs(vdir)
        os.makedirs(adir)
        for f in range(n_frames):
            Image.fromarray(rng.randint(0, 256, (*hw, 3)).astype(np.uint8)).save(
                os.path.join(vdir, f"{f:08d}.jpg"))
            raw = np.full(hw, tpng.VIPSEG_STUFF_IDS[v] + 1, np.int32)
            raw[: hw[0] // 2, : hw[1] // 2] = (tpng.VIPSEG_THING_IDS[f] + 1) * 100 + 1
            raw[-2:, -2:] = 0
            if not (drop_last_mask and (v, f) == (n_videos - 1, n_frames - 1)):
                tpng.save_png(os.path.join(adir, f"{f:08d}.png"), raw.astype(np.uint16))
    if split_file is not None:
        with open(os.path.join(str(root), "val.txt"), "w") as fh:
            fh.write("\n".join(split_file) + "\n")
    return str(root)


def _write_flat(root, img_token, ann_token, n_seqs=2, n_frames=3):
    d = os.path.join(str(root), "video_sequence", "train")
    os.makedirs(d, exist_ok=True)
    for s in range(n_seqs):
        for f in range(n_frames):
            for tok in (img_token, ann_token):
                if tok == ann_token and f == 1:
                    continue
                tpng.save_png(os.path.join(d, f"{s:06d}_{f:06d}_{tok}.png"),
                              np.full((8, 8), f, np.uint8))
    return str(root)


def _same_scan(got, want, draws: int = 12) -> None:
    assert [vars(s) for s in got.frames.values()] == [vars(s) for s in want.frames.values()]
    assert got.order == want.order and got.pairs == want.pairs and len(got) == len(want)
    assert [(vars(s), f) for s, f in got.iter_test()] == \
        [(vars(s), f) for s, f in want.iter_test()]
    for i in range(draws):
        a, b = np.random.RandomState(i), np.random.RandomState(i)
        idx = i % len(want)
        assert [vars(s) for s in got.get_pair(idx, a)] == [vars(s) for s in want.get_pair(idx, b)]
        assert a.randint(1 << 30) == b.randint(1 << 30)  # the same draws consumed
    for i in range(draws):  # the dataset-level RNG
        assert [vars(s) for s in got.get_pair(i % len(want))] == \
            [vars(s) for s in want.get_pair(i % len(want))]
    for attr in ("thing_ids_in_seg", "num_thing_classes", "num_stuff_classes", "ann_mode"):
        assert getattr(got, attr, None) == getattr(want, attr, None)


@pytest.mark.parametrize("ref", [None, [-2, -1, 1, 2], [3]])
def test_kitti_step_scan_matches_jax(tmp_path, ref):
    root = _write_kitti(tmp_path, n_seqs=3, n_frames=5, hw=(8, 12), no_ann={(1, 0)})
    _same_scan(tds.KittiStepDVPS(root, ref_seq_index=ref, seed=3),
               jds.KittiStepDVPS(root, ref_seq_index=ref, seed=3))
    assert tds.KittiStepDVPS.CLASSES == jds.KittiStepDVPS.CLASSES


@pytest.mark.parametrize("layout", ["official", "official_split", "flat"])
def test_vipseg_scan_matches_jax(tmp_path, layout):
    if layout == "flat":
        root = _write_flat(tmp_path, "img", "panoptic")
    else:
        split = ["vid001", "vid000"] if layout == "official_split" else None
        root = _write_vipseg_official(tmp_path, split_file=split)
    _same_scan(tds.VIPSegDVPS(root, split="val" if layout != "flat" else "train",
                              ref_seq_index=[-1, 1], seed=1),
               jds.VIPSegDVPS(root, split="val" if layout != "flat" else "train",
                              ref_seq_index=[-1, 1], seed=1))


def test_semkitti_scan_matches_jax(tmp_path):
    root = _write_flat(tmp_path, "leftImg8bit", "gtFine_class")
    got, want = tds.SemKITTIDVPS(root, ref_seq_index=[-1, 1]), jds.SemKITTIDVPS(
        root, ref_seq_index=[-1, 1])
    _same_scan(got, want)
    p = next(iter(want.frames.values())).img
    assert tds.SemKITTIDVPS.ann_paths(p) == jds.SemKITTIDVPS.ann_paths(p)


def test_vspw_scan_matches_jax(tmp_path):
    rng = np.random.RandomState(2)
    for v in ("v1", "v0", "v2"):
        for sub in ("origin", "mask"):
            os.makedirs(tmp_path / "data" / v / sub)
        for f in range(3):
            Image.fromarray(rng.randint(0, 256, (6, 8, 3)).astype(np.uint8)).save(
                tmp_path / "data" / v / "origin" / f"{f:05d}.jpg")
            if f != 1:
                tpng.save_png(str(tmp_path / "data" / v / "mask" / f"{f:05d}.png"),
                              rng.randint(0, 125, (6, 8)).astype(np.uint8))
    os.makedirs(tmp_path / "data" / "no_origin")
    for split_file in (False, True):
        if split_file:
            (tmp_path / "val.txt").write_text("v2\nno_origin\nv0\n")
        got, want = tds.VSPWDataset(str(tmp_path)), jds.VSPWDataset(str(tmp_path))
        assert got.videos == want.videos and len(got) == len(want)
    mask = tpng.load_png(want.videos[0][1][0][1])
    same(tds.VSPWDataset.decode_mask(mask), jds.VSPWDataset.decode_mask(mask))


def test_cityscapes_step_scan_matches_jax(tmp_path):
    for city in ("zurich", "aachen"):
        os.makedirs(tmp_path / "leftImg8bit" / "val" / city)
        os.makedirs(tmp_path / "panoptic" / "val" / city)
        for i in range(2):
            name = f"{city}_{i:06d}_000019_leftImg8bit.png"
            tpng.save_png(str(tmp_path / "leftImg8bit" / "val" / city / name),
                          np.zeros((4, 4, 3), np.uint8))
            if i == 0:
                tpng.save_png(str(tmp_path / "panoptic" / "val" / city /
                                  name.replace("leftImg8bit", "panoptic")),
                              np.zeros((4, 4, 3), np.uint8))
    got = tds.CityscapesSTEPImages(str(tmp_path), split="val")
    want = jds.CityscapesSTEPImages(str(tmp_path), split="val")
    assert [vars(s) for s in got.samples] == [vars(s) for s in want.samples]
    assert got.CLASSES == want.CLASSES and len(got) == len(want) == 4
    with pytest.raises(FileNotFoundError):
        tds.CityscapesSTEPImages(str(tmp_path), split="train")


# -------------------------------------------------------------------- loader

def _loader_pair(ds_t, ds_j, cfg_kw, **kw):
    return (TLoader(ds_t, TConfig(**cfg_kw), device="cpu", **kw),
            JLoader(ds_j, JConfig(**cfg_kw), **kw))


def _same_batches(got, want) -> int:
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.img.device.type == "cpu"
        same(g.img, w.img)
        same(g.ref_img, w.ref_img)
        same_gt(g.gt, w.gt)
        same_gt(g.ref_gt, w.ref_gt)
    assert any(bool(g.gt.valid.any()) and bool(g.gt.sem_valid.any()) for g in got)
    return len(got)


@pytest.mark.parametrize("threads", [1, 4])
def test_loader_matches_jax(tmp_path, threads):
    """Every field of every batch, at 1 and 4 threads; 6 instances a frame
    in 4 slots, random flips, crops and pads (seeded)."""
    root = _write_kitti(tmp_path, n_seqs=2, n_frames=5)
    ref = [-2, -1, 1, 2]
    lt, lj = _loader_pair(tds.KittiStepDVPS(root, ref_seq_index=ref),
                          jds.KittiStepDVPS(root, ref_seq_index=ref),
                          dict(max_insts=4), batch_size=2, crop_hw=(40, 72), seed=7,
                          num_threads=threads, process_index=0, process_count=1, prefetch=1)
    assert _same_batches(lt, lj) == 5
    # a second epoch draws a new permutation, as JAX's does
    _same_batches(lt, lj)


def test_loader_matches_jax_on_vipseg_jpeg_frames(tmp_path):
    root = _write_vipseg_official(tmp_path, drop_last_mask=False)
    cfg = dict(max_insts=4, num_thing_classes=58, num_stuff_classes=66)
    lt, lj = _loader_pair(tds.VIPSegDVPS(root, split="val", ref_seq_index=[-1, 1]),
                          jds.VIPSegDVPS(root, split="val", ref_seq_index=[-1, 1]),
                          cfg, batch_size=1, crop_hw=(32, 48), img_scale=(40, 60), seed=2,
                          num_threads=2, process_index=0, process_count=1)
    assert _same_batches(lt, lj) == 6


def test_loader_rank_sharding(tmp_path):
    """Two ranks take the strided halves of the one-process batch stream."""
    root = _write_kitti(tmp_path, n_seqs=2, n_frames=4, hw=(16, 24))
    ds = tds.KittiStepDVPS(root, ref_seq_index=[-1, 1])
    mk = lambda r, w: TLoader(ds, TConfig(max_insts=4), batch_size=2, crop_hw=(16, 24), seed=7,
                              process_index=r, process_count=w, device="cpu")
    full = [b.img for b in mk(0, 1)]
    r0, r1 = [b.img for b in mk(0, 2)], [b.img for b in mk(1, 2)]
    assert len(r0) + len(r1) == len(full) == 4
    for k, x in enumerate(r0):
        same(x, full[2 * k])
    for k, x in enumerate(r1):
        same(x, full[2 * k + 1])


def test_loader_takes_its_rank_from_torch_distributed(tmp_path):
    root = _write_kitti(tmp_path, n_seqs=1, n_frames=2, hw=(8, 12))
    ds = tds.KittiStepDVPS(root)
    loader = TLoader(ds, TConfig(max_insts=4), batch_size=1, device="cpu")
    assert (loader.process_index, loader.process_count) == (0, 1)
    assert (loader.mesh.rank, loader.mesh.world) == (0, 1)
    dist = torch.distributed
    with mock.patch.object(dist, "is_initialized", return_value=True), \
            mock.patch.object(dist, "get_rank", return_value=3), \
            mock.patch.object(dist, "get_world_size", return_value=4):
        # under a process group a rank loads its rows of every global batch
        loader = TLoader(ds, TConfig(max_insts=4), batch_size=4, device="cpu")
        assert (loader.mesh.rank, loader.mesh.world) == (3, 4)
        assert (loader.process_index, loader.process_count) == (0, 1)
        loader = TLoader(ds, TConfig(max_insts=4), batch_size=1, device="cpu",
                         process_index=1, process_count=2)
        assert (loader.process_index, loader.process_count) == (1, 2) and loader.mesh is None


def test_loader_without_a_device_needs_a_gpu(tmp_path):
    root = _write_kitti(tmp_path, n_seqs=1, n_frames=2, hw=(8, 12))
    ds = tds.KittiStepDVPS(root)
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="CUDA"):
            TLoader(ds, TConfig(max_insts=4), batch_size=1)
        with pytest.raises(RuntimeError, match="CUDA"):
            TLoader(ds, TConfig(max_insts=4), batch_size=1, device="cuda")


def test_loader_abandoned_iteration_stops_producer(tmp_path):
    """Breaking out of a loader loop shuts the producer thread down."""
    root = _write_kitti(tmp_path, n_seqs=2, n_frames=6, hw=(16, 24))
    ds = tds.KittiStepDVPS(root)
    loader = TLoader(ds, TConfig(max_insts=4), batch_size=1, crop_hw=(16, 24), seed=0,
                     num_threads=2, process_index=0, process_count=1, prefetch=1,
                     device="cpu")

    def alive():
        return [t for t in threading.enumerate() if t.name.startswith("vps-loader-producer")]

    for _ in range(3):
        for _batch in loader:
            break  # abandon mid-epoch (plenty of batches left)
    deadline = time.time() + 15
    while alive() and time.time() < deadline:
        time.sleep(0.1)
    assert not alive(), f"leaked producer threads: {alive()}"


def test_loader_surfaces_worker_errors(tmp_path):
    root = _write_kitti(tmp_path, n_seqs=1, n_frames=3, hw=(8, 12), no_ann={(0, 1)})
    loader = TLoader(tds.KittiStepDVPS(root), TConfig(max_insts=4), batch_size=1,
                     crop_hw=(8, 12), process_index=0, process_count=1, device="cpu")
    with pytest.raises(TypeError):  # decode_panoptic_ann(None, ...) in a worker
        list(loader)
