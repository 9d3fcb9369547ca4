"""The port's COCO-panoptic, Cityscapes-VPS and forecasting data and its
`youtubevis2coco` against the JAX package's, on the CPU.

`video_knet_tpu_torch/data/{coco_panoptic,forecasting}.py` and
`tools/youtubevis2coco.py` on the same inputs as their JAX counterparts:
seeded COCO panoptic and Cityscapes-VPS trees
(`tools/data_check.py:write_coco_panoptic_tree`,
`write_cityscapes_vps_tree`: things, stuff, a crowd segment, an unknown
category, void), seeded Cityscapes-style instance maps, and a seeded raw
YouTube-VIS json. Every comparison is exact.
"""

import contextlib
import importlib.util
import io
import json
import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch_port_common  # noqa: F401  (one torch thread)

from video_knet_tpu.data import coco_panoptic as jcp
from video_knet_tpu.data import forecasting as jfc
from video_knet_tpu_torch.data import coco_panoptic as tcp
from video_knet_tpu_torch.data import forecasting as tfc
from video_knet_tpu_torch.tools import youtubevis2coco as tconv
from video_knet_tpu_torch.tools.data_check import (
    write_cityscapes_vps_tree,
    write_coco_panoptic_tree,
    write_ytvis_tree,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def same(got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype,
                                                                 got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def test_rgb2id_and_id2rgb_match_jax():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 2**24, (9, 11)).astype(np.int64)
    ids[0, :3] = (0, 255, 70000)
    same(tcp.id2rgb(ids), jcp.id2rgb(ids))
    rgb = rng.randint(0, 256, (9, 11, 3)).astype(np.uint8)
    same(tcp.rgb2id(rgb), jcp.rgb2id(rgb))
    same(tcp.rgb2id(tcp.id2rgb(ids)), ids)


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco_pan"))
    paths = write_coco_panoptic_tree(root, n_images=3, hw=(48, 64), seed=4)
    return paths, tcp.CocoPanopticDataset(*paths), jcp.CocoPanopticDataset(*paths)


def test_coco_panoptic_reader_matches_jax(coco):
    _, t, j = coco
    for attr in ("thing_cat_ids", "stuff_cat_ids", "cat_to_label", "num_thing_classes",
                 "num_stuff_classes", "thing_ids_in_seg"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert [vars(s) for s in t.samples] == [vars(s) for s in j.samples]
    assert len(t) == len(j) == 3


@pytest.mark.parametrize("idx", range(3))
def test_load_sem_inst_matches_jax(coco, idx):
    """Things numbered in segments_info order, stuff and crowd with no
    instance id, an unknown category and the unlabelled corner void."""
    _, t, j = coco
    got, want = t.load_sem_inst(idx), j.load_sem_inst(idx)
    for g, w in zip(got, want):
        same(g, w)
    sem, inst = got
    infos = t.samples[idx].segments_info
    assert any(s["iscrowd"] for s in infos) and any(s["category_id"] == 250 for s in infos)
    assert sem[0, 0] == 255 and inst[0, 0] == 0
    assert inst.max() > 1 and (sem < t.num_thing_classes).any() and (
        (sem >= t.num_thing_classes) & (sem < 255)).any()


@pytest.fixture(scope="module")
def cityscapes(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cityscapes_vps"))
    return write_cityscapes_vps_tree(root, n_clips=3, n_frames=3, hw=(32, 64), seed=5)


@pytest.mark.parametrize("seed", range(3))
def test_cityscapes_vps_pairs_match_jax(cityscapes, seed):
    """The clip keys, then `get_pair` over every key twice from
    `random.Random(seed)`, with a one-sided and a wide `ref_range`."""
    for ref_range in ((-1, 1), (-2, -1, 1, 2), (1,)):
        t = tcp.CityscapesVPSDataset(*cityscapes, ref_range=ref_range, seed=seed)
        j = jcp.CityscapesVPSDataset(*cityscapes, ref_range=ref_range, seed=seed)
        assert (t.keys, t.by_clip) == (j.keys, j.by_clip)
        assert t.num_thing_classes == 8 and t.num_stuff_classes == 11
        pairs = [t.get_pair(k) for k in list(range(len(t.keys))) * 2]
        assert pairs == [j.get_pair(k) for k in list(range(len(j.keys))) * 2]
        for key, ref in pairs:
            assert os.path.basename(t.samples[key].img)[:4] == os.path.basename(
                t.samples[ref].img)[:4]
    same(t.load_sem_inst(4)[0], j.load_sem_inst(4)[0])


# ------------------------------------------------------------------ forecasting


def _instance_map(seed: int, hw=(24, 40), things=True) -> np.ndarray:
    """A Cityscapes-style instance map: stuff trainIds below 11, things
    as class * 1000 + instance (class 11-18)."""
    rng = np.random.RandomState(seed)
    m = rng.randint(0, 11, hw).astype(np.int32)
    if things:
        for k in range(6):
            y, x = rng.randint(0, hw[0] - 5), rng.randint(0, hw[1] - 7)
            m[y:y + rng.randint(1, 6), x:x + rng.randint(1, 8)] = rng.randint(11, 19) * 1000 + k
    return m


@pytest.mark.parametrize("seed", range(3))
def test_load_instance_annotations_matches_jax(seed):
    m = _instance_map(seed)
    sem = np.random.RandomState(seed).randint(0, 19, m.shape).astype(np.uint8)
    for kw in (dict(), dict(with_inst=True), dict(with_mask=False, with_inst=True),
               dict(semantic_seg=sem)):
        got, want = tfc.load_instance_annotations(m, **kw), jfc.load_instance_annotations(m, **kw)
        assert sorted(got) == sorted(want), kw
        for k in want:
            same(got[k], want[k])
    assert tfc.load_instance_annotations(_instance_map(seed, things=False)) is None
    assert jfc.load_instance_annotations(_instance_map(seed, things=False)) is None


def test_bitmasks_to_boxes_matches_jax():
    rng = np.random.RandomState(1)
    masks = (rng.rand(5, 9, 13) > 0.9).astype(np.int64)
    masks[2] = 0  # empty: zeros
    same(tfc.bitmasks_to_boxes(masks), jfc.bitmasks_to_boxes(masks))


@pytest.mark.parametrize("mode", [dict(size_divisor=8), dict(size=(30, 50)),
                                  dict(pad_to_square=True),
                                  dict(size_divisor=4, pad_val={"img": 7, "masks": 2, "seg": 9})])
def test_pad_to_matches_jax(mode):
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (21, 43, 3)).astype(np.uint8)
    masks = (rng.rand(3, 21, 43) > 0.5).astype(np.uint8)
    seg = rng.randint(0, 19, (21, 43)).astype(np.uint8)
    for m in (masks, masks[:0]):
        got = tfc.pad_to(img, masks=m, seg=seg, **mode)
        want = jfc.pad_to(img, masks=m, seg=seg, **mode)
        assert sorted(got) == sorted(want)
        for k in want:
            if isinstance(want[k], np.ndarray):
                same(got[k], want[k])
            else:
                assert got[k] == want[k], k
    for bad in (dict(), dict(size=(4, 4), size_divisor=4),
                dict(pad_to_square=True, size_divisor=4)):
        with pytest.raises(ValueError):
            tfc.pad_to(img, **bad)
        with pytest.raises(ValueError):
            jfc.pad_to(img, **bad)


def test_normalize_multiple_and_adapter_match_jax():
    rng = np.random.RandomState(3)
    imgs = [rng.randint(0, 256, (6, 9, 3)).astype(np.uint8) for _ in range(3)]
    mean, std = (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)
    for to_rgb in (True, False):
        for g, w in zip(tfc.normalize_multiple(imgs, mean, std, to_rgb),
                        jfc.normalize_multiple(imgs, mean, std, to_rgb)):
            same(g, w)
    labels = rng.randint(11, 19, 7)
    same(tfc.knet_ins_adapter(labels), jfc.knet_ins_adapter(labels))
    same(tfc.knet_ins_adapter(labels, stuff_nums=8), jfc.knet_ins_adapter(labels, stuff_nums=8))


# ------------------------------------------------------------------ youtubevis2coco


def _jax_youtubevis2coco():
    """A fresh instance of the root `tools/youtubevis2coco.py`."""
    spec = importlib.util.spec_from_file_location(
        "jax_cli_youtubevis2coco", os.path.join(ROOT, "tools", "youtubevis2coco.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_youtubevis2coco_matches_jax(tmp_path):
    """`convert` of a seeded raw tree (absent frames skipped, every
    segmentation form kept as it is) and `main`'s JSON and printed line."""
    raw, _ = write_ytvis_tree(str(tmp_path), n_videos=3, n_frames=5, hw=(24, 32), seed=6)
    jconv = _jax_youtubevis2coco()
    with open(raw) as f:
        src = json.load(f)
    got = tconv.convert(src)
    assert got == jconv.convert(src)
    n_none = sum(s is None for a in src["annotations"] for s in a["segmentations"])
    assert len(got["annotations"]) == sum(len(a["segmentations"]) for a in src["annotations"]) \
        - n_none and n_none > 0
    outs = {}
    for pkg in ("port", "jax"):
        dst = str(tmp_path / f"{pkg}.json")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            if pkg == "port":
                tconv.main([raw, dst])
            else:  # the JAX CLI parses sys.argv
                with mock.patch.object(sys, "argv", ["youtubevis2coco.py", raw, dst]):
                    jconv.main()
        text = out.getvalue()
        with open(dst) as f:
            outs[pkg] = (json.load(f), text.replace(dst, "<dst>"))
    assert outs["port"] == outs["jax"]
    assert outs["port"][1] == (f"wrote <dst>: 15 images, {len(got['annotations'])} "
                               "annotations, 3 videos\n")
