"""The port's YouTube-VIS data path against the JAX package's, on the CPU.

`video_knet_tpu_torch/data/{polygon,ytvis,vis_loader}.py` on the same
inputs as `video_knet_tpu/data`: the polygon cases of `tests/test_polygon.py`
and seeded random polygons up to 720x1280, a seeded raw YouTube-VIS tree
(`tools/data_check.py:write_ytvis_tree`, converted by the port's
`youtubevis2coco`) with RLE, polygon and absent instances, the clip
sampler's boundary, short and single-frame cases, the submission writer,
and the threaded clip loader at several thread counts and ranks.

Every comparison is exact: arrays equal bit for bit with the same dtype,
draws and JSON entries equal as Python values.
"""

import json
import os
import zipfile
from unittest import mock

import numpy as np
import pytest
import torch
import torch_port_common  # noqa: F401  (one torch thread)
from PIL import Image

from video_knet_tpu.config_vis import VISConfig as JVISConfig
from video_knet_tpu.data import polygon as jpoly
from video_knet_tpu.data import vis_loader as jvl
from video_knet_tpu.data import ytvis as jyt
from video_knet_tpu_torch.config_vis import VISConfig as TVISConfig
from video_knet_tpu_torch.data import polygon as tpoly
from video_knet_tpu_torch.data import vis_loader as tvl
from video_knet_tpu_torch.data import ytvis as tyt
from video_knet_tpu_torch.tools.data_check import write_ytvis_cocovid, write_ytvis_tree
from video_knet_tpu_torch.tools.youtubevis2coco import convert


def same(got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype,
                                                                 got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ polygons

# every polygon of tests/test_polygon.py: (parts, h, w)
POLYGON_CASES = [
    ([[0, 0, 2, 0, 2, 2, 0, 2]], 4, 4),
    ([[3, 2, 11, 2, 11, 9, 3, 9]], 16, 16),
    ([[0, 0, 10, 0, 0, 10]], 12, 12),
    ([[0, 0, 3, 0, 3, 3, 0, 3]], 10, 10),
    ([[5, 5, 9, 5, 9, 9, 5, 9]], 10, 10),
    ([[0, 0, 3, 0, 3, 3, 0, 3], [5, 5, 9, 5, 9, 9, 5, 9]], 10, 10),
    ([[1, 1, 2, 2]], 8, 8),  # degenerate: skipped
    ([], 8, 8),
    ([[2.0, 2.0, 14.0, 2.0, 2.0, 12.0]], 16, 20),
]


def _oracle_cases() -> list:
    """The random polygons of `test_matches_pycocotools_oracle` (seed 0,
    37x53): 20 single-part, then 5 three-part objects."""
    rng = np.random.RandomState(0)
    h, w = 37, 53
    cases = []
    for _ in range(20):
        n = int(rng.randint(3, 9))
        cases.append(([(rng.rand(2 * n) * np.array([w, h] * n)).tolist()], h, w))
    for _ in range(5):
        cases.append(([(rng.rand(8) * np.array([w, h] * 4)).tolist() for _ in range(3)], h, w))
    return cases


def _random_objects(seed: int, count: int = 12) -> list:
    """Seeded multi-part objects on frames up to 720x1280: parts of 1-11
    vertices (some degenerate), vertices off the frame, on half and tenth
    pixels (where the 5x scale and C's rounding meet .5), edges in every
    direction."""
    rng = np.random.RandomState(seed)
    cases = []
    for _ in range(count):
        h, w = int(rng.randint(8, 721)), int(rng.randint(8, 1281))
        parts = []
        for _ in range(rng.randint(1, 4)):
            n = int(rng.randint(1, 12))
            xy = np.stack([rng.uniform(-0.1 * w, 1.1 * w, n), rng.uniform(-0.1 * h, 1.1 * h, n)],
                          1).ravel()
            grid = rng.randint(0, 3)
            if grid:  # halves or tenths of a pixel
                xy = np.round(xy * (2, 10)[grid - 1]) / (2, 10)[grid - 1]
            parts.append(xy.tolist())
        cases.append((parts, h, w))
    return cases


CASES = POLYGON_CASES + _oracle_cases()


@pytest.mark.parametrize("case", range(len(CASES)))
def test_polygon_cases_match_jax(case):
    parts, h, w = CASES[case]
    same(tpoly.polygons_to_mask(parts, h, w), jpoly.polygons_to_mask(parts, h, w))


@pytest.mark.parametrize("seed", range(5))
def test_random_polygons_match_jax(seed):
    """60 objects in all; the counts of each part, then the OR-merged mask."""
    filled = 0
    for parts, h, w in _random_objects(seed):
        for p in parts:
            if len(p) >= 6:
                same(tpoly._poly_to_counts(np.asarray(p), h, w),
                     jpoly._poly_to_counts(np.asarray(p), h, w))
        got = tpoly.polygons_to_mask(parts, h, w)
        same(got, jpoly.polygons_to_mask(parts, h, w))
        filled += int(got.any())
    assert filled >= 6


# ------------------------------------------------------------------ the tree


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A raw YT-VIS tree of 5 videos x 7 frames of 40x64 (up to 4 instances
    a video: raw-count RLEs, string RLEs, polygons; absent frames), converted
    to COCO-VID by the port's `youtubevis2coco`, read by both readers."""
    root = str(tmp_path_factory.mktemp("ytvis"))
    ann, img_root = write_ytvis_cocovid(root, n_videos=5, n_frames=7, hw=(40, 64), max_insts=4,
                                        seed=1)
    with open(ann) as f:
        coco = json.load(f)
    return dict(ann=ann, img_root=img_root, coco=coco,
                port=tyt.YouTubeVISDataset(ann, img_root=img_root),
                jax=jyt.YouTubeVISDataset(ann, img_root=img_root))


def test_tree_holds_every_annotation_form(tree):
    segs = [a["segmentation"] for a in tree["coco"]["annotations"]]
    kinds = {"polygon" if isinstance(s, list) else type(s["counts"]).__name__ for s in segs}
    assert kinds == {"polygon", "list", "str"}
    n_frames = len(tree["coco"]["images"])
    per_video = [sum(1 for a in tree["coco"]["annotations"] if a["video_id"] == v["id"])
                 for v in tree["coco"]["videos"]]
    # some instance is absent from some frame
    with open(os.path.join(os.path.dirname(tree["img_root"]), "ann.json")) as f:
        raw = json.load(f)
    assert any(s is None for a in raw["annotations"] for s in a["segmentations"])
    assert n_frames == 35 and all(n > 0 for n in per_video)


def test_reader_matches_jax(tree):
    t, j = tree["port"], tree["jax"]
    assert (t.categories, t.cat_ids, len(t)) == (j.categories, j.cat_ids, len(j))
    for a, b in zip(t.videos, j.videos):
        assert (a.video_id, a.frames, a.anns_by_frame) == (b.video_id, b.frames, b.anns_by_frame)
        assert [t.frame_path(im) for im in a.frames] == [
            os.path.join(j.img_root, im["file_name"]) for im in b.frames]


def _mini(tmp_path, n_frames: int):
    """One video of `n_frames` frames and no annotations, read by both
    packages (`tests/test_coco_vis_data.py:_mini_vis_ds`)."""
    data = {"categories": [{"id": 1, "name": "a"}], "videos": [{"id": 1}], "annotations": [],
            "images": [{"id": 100 + i, "video_id": 1, "frame_id": i, "height": 8, "width": 8,
                        "file_name": f"f{i}.png"} for i in range(n_frames)]}
    p = tmp_path / f"mini{n_frames}.json"
    p.write_text(json.dumps(data))
    return tyt.YouTubeVISDataset(str(p)), jyt.YouTubeVISDataset(str(p))


@pytest.mark.parametrize("method", ["uniform", "bilateral_uniform"])
@pytest.mark.parametrize("frame_range", [(-2, 2), (-3, 1)])
def test_sample_clip_matches_jax(tree, tmp_path, method, frame_range):
    """The tree's videos and one-video sets of 10, 3 and 1 frames, 40 seeds
    each: equal indices, and the generators left in the same state."""
    sets = [(tree["port"], tree["jax"])] + [_mini(tmp_path, n) for n in (10, 3, 1)]
    for t, j in sets:
        for v in range(len(t)):
            for seed in range(40):
                rt, rj = np.random.RandomState(seed), np.random.RandomState(seed)
                kw = dict(num_frames=5, frame_range=frame_range, method=method)
                assert t.sample_clip(v, rt, **kw) == j.sample_clip(v, rj, **kw)
                assert rt.randint(0, 2**31) == rj.randint(0, 2**31)


def test_sample_clip_boundary_and_single_frame_match_jax(tmp_path):
    """The key forced to frame 0 (the left side empty: the refs refilled
    from the right and padded from the nearest frames), and a single-frame
    video, whose key repeats."""
    class FixedRng(np.random.RandomState):
        def randint(self, lo, hi=None, **kw):
            return 0

    t, j = _mini(tmp_path, 10)
    for seed in range(20):
        kw = dict(num_frames=5, frame_range=(-2, 2), method="bilateral_uniform")
        got = t.sample_clip(0, FixedRng(seed), **kw)
        assert got == j.sample_clip(0, FixedRng(seed), **kw)
        assert got[0] == 0 and 0 not in got[1:]
    t1, j1 = _mini(tmp_path, 1)
    got = t1.sample_clip(0, np.random.RandomState(0), num_frames=5)
    assert got == j1.sample_clip(0, np.random.RandomState(0), num_frames=5) == [0] * 5


@pytest.mark.parametrize("max_insts", [2, 6])
def test_clip_gt_arrays_match_jax(tree, max_insts):
    """Every video's sampled clips: RLE and polygon masks, absent frames,
    and (at 2 slots) more instances than slots; also at an explicit hw."""
    t, j = tree["port"], tree["jax"]
    dropped = 0
    for v in range(len(t)):
        for seed in range(3):
            idxs = t.sample_clip(v, np.random.RandomState(seed), num_frames=4)
            for hw in (None, (32, 48)):
                got = t.clip_gt_arrays(v, idxs, max_insts=max_insts, hw=hw)
                want = j.clip_gt_arrays(v, idxs, max_insts=max_insts, hw=hw)
                for g, w in zip(got, want):
                    same(g, w)
        n = len({a["instance_id"] for fa in t.videos[v].anns_by_frame for a in fa})
        dropped += max(0, n - max_insts)
    if max_insts == 2:
        assert dropped > 0


# ------------------------------------------------------------------ results


def _decode(rng, t=4, k=5, hw=(12, 18)):
    logits = (rng.randn(t, k, *hw) * 3).astype(np.float32)
    logits[:, 1] = -5.0  # one tube empty in every frame
    logits[2, 2] = -5.0  # one tube empty in one frame
    return logits, rng.randint(0, 40, k).astype(np.int32), rng.rand(k).astype(np.float32)


@pytest.mark.parametrize("form", ["logits", "probs"])
def test_tracks_and_results_match_jax(tmp_path, form):
    """`tracks_from_prediction` on logits (threshold 0) and on probabilities
    (0.5), with a score gate, then `format_vis_results` with hand-made
    vote and frame-score tracks beside them: entry for entry equal, and
    the zip's member equals results.json."""
    rng = np.random.RandomState(3)
    cat_ids = list(range(1, 41))
    videos = []
    for vid in (7, 9):
        masks, labels, scores = _decode(rng)
        if form == "probs":
            masks = 1 / (1 + np.exp(-masks))
        got = tyt.tracks_from_prediction(vid, masks, labels, scores, cat_ids, score_thr=0.2)
        assert got == jyt.tracks_from_prediction(vid, masks, labels, scores, cat_ids,
                                                 score_thr=0.2)
        videos.append(got)
    assert any(s is None for tr in videos[0] for s in tr["segmentations"])
    extra = {"video_id": 11, "category_votes": {3: 0.5, 8: 0.75, 2: 0.1},
             "frame_scores": {0: 0.25, 1: 0.5}, "segmentations": [None, None]}
    videos.append([extra])
    paths = {pkg: mod.format_vis_results(videos, str(tmp_path / pkg))
             for pkg, mod in (("port", tyt), ("jax", jyt))}
    results = {}
    for pkg, path in paths.items():
        with open(path) as f:
            results[pkg] = json.load(f)
        with zipfile.ZipFile(os.path.join(os.path.dirname(path), "submission_file.zip")) as z:
            assert z.namelist() == ["results.json"]
            assert json.loads(z.read("results.json")) == results[pkg]
    assert results["port"] == results["jax"]
    assert results["port"][-1] == {"video_id": 11, "category_id": 8, "score": 0.375,
                                   "segmentations": [None, None]}
    tyt.format_vis_results(videos, str(tmp_path / "nozip"), make_zip=False)
    assert os.listdir(tmp_path / "nozip") == ["results.json"]


# ------------------------------------------------------------------ loader


def _loader_pair(tree, **kw):
    cfg = dict(num_frames=3, max_insts=3, mask_assign_stride=4)
    common = dict(batch_size=2, canvas_hw=(32, 48), short_sides=(24, 40), seed=5, prefetch=1)
    common.update(kw)
    return (tvl.VISTrainLoader(tree["port"], TVISConfig(**cfg), device="cpu", **common),
            jvl.VISTrainLoader(tree["jax"], JVISConfig(**cfg), **common))


def _same_batches(got, want) -> list:
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, (clip, gt) in zip(got, want):
        assert type(g).__name__ == "VISBatch" and g.clip.device.type == "cpu"
        same(g.clip, clip)
        for field in ("masks", "labels", "valid"):
            same(getattr(g.gt, field), getattr(gt, field))
    assert any(float(g.gt.masks.sum()) > 0 for g in got)
    return got


@pytest.mark.parametrize("threads", [1, 3])
def test_vis_loader_matches_jax(tree, threads):
    """Every field of every batch at 1 and 3 threads: clip-shared short
    sides of 24 and 40 on a 32x48 canvas (40 overflows it: the crop path),
    flips, 3 tube slots; a second epoch draws a new permutation, as JAX's."""
    lt, lj = _loader_pair(tree, num_threads=threads, process_index=0, process_count=1)
    assert len(_same_batches(lt, lj)) == 2
    _same_batches(lt, lj)


def test_vis_loader_ranks_match_jax(tree):
    """Ranks 0 and 1 of 2 (batch size 1): each equal to JAX's rank, and the
    two the strided halves of the one-rank stream."""
    full = _same_batches(*_loader_pair(tree, batch_size=1, process_index=0, process_count=1))
    ranks = [_same_batches(*_loader_pair(tree, batch_size=1, num_threads=2, process_index=r,
                                         process_count=2)) for r in (0, 1)]
    assert [len(r) for r in ranks] == [3, 2]
    for r, batches in enumerate(ranks):
        for k, b in enumerate(batches):
            same(b.clip, full[2 * k + r].clip)


def test_vis_loader_on_jpeg_frames_matches_jax(tmp_path):
    """YT-VIS frames are JPEGs: both loaders read them through PIL."""
    root = str(tmp_path)
    raw, img_root = write_ytvis_tree(root, n_videos=2, n_frames=4, hw=(24, 40), seed=2)
    with open(raw) as f:
        coco = convert(json.load(f))
    for im in coco["images"]:
        png = os.path.join(img_root, im["file_name"])
        im["file_name"] = im["file_name"][:-4] + ".jpg"
        Image.open(png).convert("RGB").save(os.path.join(img_root, im["file_name"]), quality=90)
    ann = str(tmp_path / "jpeg.json")
    with open(ann, "w") as f:
        json.dump(coco, f)
    tree = {"port": tyt.YouTubeVISDataset(ann, img_root), "jax": jyt.YouTubeVISDataset(ann,
                                                                                   img_root)}
    assert len(_same_batches(*_loader_pair(tree, batch_size=1, canvas_hw=(24, 40)))) == 2


def test_vis_loader_rank_and_device(tree):
    """The rank of an initialized torch.distributed group (the VPS loader's
    `_process_rank`); CUDA by default, raising without a GPU."""
    cfg = TVISConfig(num_frames=3, max_insts=3)
    loader = tvl.VISTrainLoader(tree["port"], cfg, device="cpu")
    assert (loader.process_index, loader.process_count) == (0, 1)
    dist = torch.distributed
    with mock.patch.object(dist, "is_initialized", return_value=True), \
            mock.patch.object(dist, "get_rank", return_value=1), \
            mock.patch.object(dist, "get_world_size", return_value=2):
        loader = tvl.VISTrainLoader(tree["port"], cfg, device="cpu")
        assert (loader.process_index, loader.process_count) == (1, 2)
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="CUDA"):
            tvl.VISTrainLoader(tree["port"], cfg)


def test_vis_transform_draw_matches_jax():
    for seed in range(50):
        rt, rj = np.random.RandomState(seed), np.random.RandomState(seed)
        got = tvl.sample_vis_transform_params(rt)
        want = jvl.sample_vis_transform_params(rj)
        assert (got.scale, got.flip, got.crop_y, got.crop_x, got.img_scale) == (
            want.scale, want.flip, want.crop_y, want.crop_x, want.img_scale)
    assert tvl.YTVIS_SHORT_SIDES == jvl.YTVIS_SHORT_SIDES


def test_vis_near_ties_bounds_the_difference_and_names_the_flips(tree):
    """`train_check.vis_near_ties` raises where two models' mask logits
    differ by more than `VIS_MASK_TOL` of their scale (here: two weight
    seeds), naming per clip the hard decisions (`vis_flips`) taken
    otherwise; `vis_flips` of a forward against itself is empty."""
    from video_knet_tpu_torch.models.vis.knet_vis import KNetVIS
    from video_knet_tpu_torch.tools import train_check

    cfg = train_check.vis_check_cfg(TVISConfig())
    a, b = (KNetVIS(cfg, generator=torch.Generator().manual_seed(s), device="cpu")
            for s in (0, 1))
    ds = tyt.YouTubeVISDataset(tree["ann"], tree["img_root"])
    ds.videos = ds.videos[:1]
    with pytest.raises(AssertionError, match=r"video 1: .* \(limit 0\.0001\); .*'init': \d+"):
        train_check.vis_near_ties(a, b, cfg, ds, (40, 64), 3)
    clip = torch.from_numpy(np.random.RandomState(0).randn(1, 3, 40, 64, 3).astype(np.float32))
    with torch.no_grad():
        outs = [m(clip) for m in (a, a, b)]
    assert train_check.vis_flips(outs[0], outs[1], cfg) == {}
    flips = train_check.vis_flips(outs[0], outs[2], cfg)
    names = list(train_check.vis_decisions(outs[0], cfg)) + ["top_k"]
    assert flips and list(flips) == [n for n in names if n in flips]
    assert names[:2] == ["init", "frame0"] and names[-2:] == ["clip2", "top_k"]


def test_vis_results_agree_excuses_only_near_ties(tree, tmp_path):
    """The card-vs-CPU rule of `test_whole_video`'s results (`train_check.
    vis_near_ties`, `vis_results_agree`) on the CPU against itself: no
    difference, no near-tie but exact zeros; a flipped pixel is excused
    only within twice the difference of the threshold; a score off by more
    than 1e-5 or a wrong category fails."""
    from video_knet_tpu_torch.data.tta import near_threshold
    from video_knet_tpu_torch.models.vis.knet_vis import KNetVIS
    from video_knet_tpu_torch.tools import train_check

    cfg = train_check.vis_check_cfg(TVISConfig())
    model = KNetVIS(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    ds = tyt.YouTubeVISDataset(tree["ann"], tree["img_root"])
    ds.videos = ds.videos[:2]
    near, worst, clips = train_check.vis_near_ties(model, model, cfg, ds, (40, 64), 3)
    assert worst == 0.0 and sorted(near) == [1, 2] and near[1].shape[0] == 7
    assert clips == {1: [{"err": 0.0}] * 3, 2: [{"err": 0.0}] * 3}

    rng = np.random.RandomState(4)
    masks = (rng.randn(3, 2, 8, 10) * 2).astype(np.float32)
    tracks = tyt.tracks_from_prediction(1, masks, np.array([0, 3]), np.array([0.5, 0.25]),
                                        list(range(1, 41)))
    with open(tyt.format_vis_results([tracks], str(tmp_path), make_zip=False)) as f:
        want = json.load(f)
    near = {1: near_threshold(masks, 0.0, 0.05)}
    assert train_check.vis_results_agree(want, want, near) == {"tracks": 2, "excused": 0}

    def flipped(f, j, y, x):
        m = masks.copy()
        m[f, j, y, x] = -m[f, j, y, x]
        got = tyt.tracks_from_prediction(1, m, np.array([0, 3]), np.array([0.5, 0.25]),
                                         list(range(1, 41)))
        return [dict(w, segmentations=g["segmentations"]) for w, g in zip(want, got)]

    close = np.argwhere(np.abs(masks) <= 0.1)[0]
    far = np.argwhere(np.abs(masks) > 1.0)[0]
    assert train_check.vis_results_agree(flipped(*close), want, near)["excused"] == 1
    for bad in (flipped(*far), [dict(want[0], score=0.5 + 2e-5), want[1]],
                [want[0], dict(want[1], category_id=5)]):
        with pytest.raises(AssertionError):
            train_check.vis_results_agree(bad, want, near)
