"""The port's training-time evaluator against the JAX package's, on the CPU.

`video_knet_tpu_torch/train/eval_hook.py` (`evaluate_vps`,
`evaluate_image_panoptic`, `format_pq_table`) and
`video_knet_tpu/train/eval_hook.py` fed the same stub pipeline / decode_fn
over the same dataset trees; then the port's real `VPSInferencePipeline`
with the trained tiny model over the trained golden's sequence written as a
KITTI-STEP tree (`tools/trained_golden.py:write_sequence`): its maps are
`tests/golden/serving_trained_tiny_64x96.npz` bit for bit, so its metrics
equal JAX's evaluator on a stub that replays the golden's maps.

Every comparison here is exact: every metric field equal (floats with ==,
arrays element for element), the table string equal.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch_port_common  # noqa: F401  (one torch thread)

from video_knet_tpu.data import datasets as jds
from video_knet_tpu.train import eval_hook as jeh
from video_knet_tpu_torch.data import datasets as tds
from video_knet_tpu_torch.data.panoptic_png import decode_panoptic_ann, save_png
from video_knet_tpu_torch.data.transforms import nearest_resize
from video_knet_tpu_torch.tools import trained_golden as tg
from video_knet_tpu_torch.train import eval_hook as teh

HW = (48, 80)
SIZE_HW = (32, 64)  # keep-ratio resize (content 32 x 53) and a right pad


def assert_same_metrics(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert type(g) is type(w) and g == w, (k, g, w)


def _write_tree(root, no_ann=()):
    """A KITTI-STEP tree of 2 sequences x 4 frames of HW: stuff bands and
    moving person / car boxes with persistent instance ids."""
    d = os.path.join(str(root), "video_sequence", "val")
    os.makedirs(d)
    rng = np.random.RandomState(0)
    h, w = HW
    for s in range(2):
        for f in range(4):
            save_png(os.path.join(d, f"{s:06d}_{f:06d}_leftImg8bit.png"),
                     rng.randint(0, 256, (*HW, 3)).astype(np.uint8))
            if (s, f) in no_ann:
                continue
            pan = np.zeros((*HW, 3), np.uint8)
            pan[h // 2:, :, 0] = 8
            pan[:4, :, 0] = 10
            pan[-3:, :7, 0] = 255  # void
            for k, (cls, y0) in enumerate(((11, 6), (13, 26), (13, 8))):
                x0 = 5 + 6 * f + 20 * k
                pan[y0:y0 + 14, x0:x0 + 12] = (cls, 0, k + 1 + s)
            save_png(os.path.join(d, f"{s:06d}_{f:06d}_panoptic.png"), pan)
    return str(root)


class StubPipeline:
    """Replays seeded predictions: each frame's GT with its classes and ids
    perturbed, nearest-resized to the content region and padded; reads (and
    checks) every frame it is given, as either package passes it."""

    def __init__(self, samples, ann_mode="kitti_rgb", seed=0):
        self.samples, self.ann_mode, self.seed = samples, ann_mode, seed
        self.flags = None

    def run_sequence(self, frames, flags):
        self.flags = list(flags)
        rng = np.random.RandomState(self.seed)
        for sample, img in zip(self.samples, frames):
            img = np.asarray(img)
            assert img.shape == (1, *SIZE_HW, 3) and img.dtype == np.float32
            sem, inst = decode_panoptic_ann(sample.ann, self.ann_mode)
            h, w = sem.shape
            f = min(SIZE_HW[0] / h, SIZE_HW[1] / w)
            ch, cw = round(h * f), round(w * f)
            sem = np.where(sem == 255, 0, sem)
            sem = np.where(rng.rand(h, w) < 0.05, rng.randint(0, 19, (h, w)), sem)
            trk = np.where(inst > 0, inst + (rng.rand() < 0.3), 0)
            out_sem = np.zeros(SIZE_HW, np.int32)
            out_trk = np.zeros(SIZE_HW, np.int64)
            out_sem[:ch, :cw] = nearest_resize(sem, (ch, cw))
            out_trk[:ch, :cw] = nearest_resize(trk, (ch, cw))
            yield SimpleNamespace(semantic_map=out_sem, track_map=out_trk)


def _kept(ds):
    return [s for s, _ in ds.iter_test() if s.ann is not None]


@pytest.mark.parametrize("max_frames,no_ann", [(None, ()), (5, ()), (None, ((1, 0), (0, 2)))])
def test_evaluate_vps_matches_jax(tmp_path, max_frames, no_ann):
    """A stub pipeline over the same tree: every metric field equal; an
    ann-less sequence head passes its reset to the next kept frame."""
    root = _write_tree(tmp_path, no_ann)
    tds_, jds_ = tds.KittiStepDVPS(root, split="val"), jds.KittiStepDVPS(root, split="val")
    tp, jp = StubPipeline(_kept(tds_)), StubPipeline(_kept(jds_))
    stats = {}
    got = teh.evaluate_vps(tp, tds_, size_hw=SIZE_HW, max_frames=max_frames, stats=stats)
    want = jeh.evaluate_vps(jp, jds_, size_hw=SIZE_HW, max_frames=max_frames)
    assert_same_metrics(got, want)
    assert tp.flags == jp.flags
    n = len(_kept(tds_)) if max_frames is None else max_frames
    assert got["frames"] == n and 0 < got["PQ"] < 100 and 0 < got["STQ"] < 1
    assert set(stats) == {"load", "decode", "resize", "vpq", "stq", "total"}
    assert all(v >= 0 for v in stats.values())


@pytest.mark.parametrize("things_first", [False, True])
def test_evaluate_image_panoptic_matches_jax(tmp_path, things_first):
    """A stub decode_fn gives each image a panoptic map and segments_info
    from its GT (some segments merged, one thing dropped); KITTI-STEP's
    thing ids (11, 13) or a things-first space; the per-class table."""
    root = _write_tree(tmp_path, no_ann=((0, 1),))
    samples_t = list(tds.KittiStepDVPS(root, split="val").frames.values())
    samples_j = list(jds.KittiStepDVPS(root, split="val").frames.values())
    thing_ids = (0, 1) if things_first else (11, 13)
    names = [f"class{i}" for i in range(19)]

    def make_decode(samples):
        queue = [s for s in samples if s.ann is not None]

        def decode_fn(img):
            img = np.asarray(img)
            assert img.shape == (1, *SIZE_HW, 3)
            sem, inst = decode_panoptic_ann(queue.pop(0).ann, "kitti_rgb")
            pan = np.zeros(SIZE_HW, np.int64)
            infos = []
            small_sem = nearest_resize(sem, (32, 53))
            small_inst = nearest_resize(inst, (32, 53))
            for cls in np.unique(small_sem):
                if cls == 255:
                    continue
                mask = small_sem == cls
                if cls in (11, 13):
                    for i in np.unique(small_inst[mask])[1:]:  # one instance dropped
                        pan[:32, :53][mask & (small_inst == i)] = len(infos) + 1
                        infos.append(dict(id=len(infos) + 1, isthing=True,
                                          category_id=(11, 13).index(int(cls))))
                else:
                    pan[:32, :53][mask] = len(infos) + 1
                    stuff = [c for c in range(19) if c not in (11, 13)].index(int(cls))
                    infos.append(dict(id=len(infos) + 1, isthing=False, category_id=stuff + 1))
            return pan, infos

        return decode_fn

    kw = dict(size_hw=SIZE_HW, thing_ids_in_seg=thing_ids, num_classes=19, class_names=names)
    got = teh.evaluate_image_panoptic(make_decode(samples_t), samples_t, **kw)
    want = jeh.evaluate_image_panoptic(make_decode(samples_j), samples_j, **kw)
    assert_same_metrics(got, want)
    # a things-first label space shifts every class off KITTI-STEP's GT
    assert got["images"] == 7 and (things_first or got["PQ"] > 0)
    lines = got["table"].splitlines()
    assert len(lines) == 21 and lines[-1].startswith("ALL")
    limited = teh.evaluate_image_panoptic(make_decode(samples_t), samples_t, max_images=3, **kw)
    assert_same_metrics(limited, jeh.evaluate_image_panoptic(make_decode(samples_j), samples_j,
                                                             max_images=3, **kw))
    assert teh.format_pq_table(got, names[:4]) == jeh.format_pq_table(want, names[:4])


@pytest.fixture(scope="module")
def trained_tree(tmp_path_factory):
    return tg.write_sequence(str(tmp_path_factory.mktemp("trained")))


class Recording:
    """Passes `run_sequence` through, keeping each frame's maps."""

    def __init__(self, pipe):
        self.pipe, self.results = pipe, []

    def run_sequence(self, frames, flags):
        for r in self.pipe.run_sequence(frames, flags):
            self.results.append(r)
            yield r


class Replay:
    def __init__(self, arrs):
        self.arrs = arrs

    def run_sequence(self, frames, flags):
        for i, _ in enumerate(frames):
            yield SimpleNamespace(semantic_map=self.arrs[f"sem_{i}"],
                                  track_map=self.arrs[f"trk_{i}"])


@pytest.mark.parametrize("tracker_type", ["quasi_dense", "quasi_dense_host"])
def test_evaluate_vps_with_the_trained_tiny_model(trained_tree, tracker_type):
    """The port's pipeline on the CPU over the written golden sequence: the
    golden's maps bit for bit, and JAX's evaluator on a replay of them gives
    the same metrics; the trained model tracks, so PQ and STQ are above 0."""
    from video_knet_tpu_torch.models.video.inference import VPSInferencePipeline

    cpu = torch.device("cpu")
    pipe = Recording(VPSInferencePipeline(tg.tiny_model(cpu), tg.tiny_cfg(), tg.HW,
                                          tracker_type=tracker_type, device=cpu))
    got = teh.evaluate_vps(pipe, tds.KittiStepDVPS(trained_tree), size_hw=tg.HW)
    gold = np.load(tg.GOLDEN)
    arrs = tg.flatten_results(pipe.results)
    for i in range(tg.N_FRAMES):
        for key in ("pan", "sem", "trk"):
            np.testing.assert_array_equal(arrs[f"{key}_{i}"], gold[f"{key}_{i}"])
    want = jeh.evaluate_vps(Replay(gold), jds.KittiStepDVPS(trained_tree), size_hw=tg.HW)
    assert_same_metrics(got, want)
    assert got["frames"] == tg.N_FRAMES and got["PQ"] > 0 and got["STQ"] > 0
