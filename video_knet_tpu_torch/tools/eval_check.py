"""Seeded panoptic sequences and one scoring pass over every VPS metric.

The datasets are not in the repository, so the metrics are driven with
synthetic KITTI-STEP-like sequences (`synthetic_sequence`): 19 classes in
the Cityscapes label space, things 11 and 13 (person, car); horizontal
stuff bands; moving thing rectangles with persistent track ids, one that
leaves and one that enters; a crowd region (a thing class, instance 0);
and a void region (255). `perturb` makes a prediction from one: boxes
shifted, an id switch, a missed track, a block of wrong classes.

`score` runs the port's windowed VPQ, STQ (DSTQ given depth maps),
mIoU and video consistency over one sequence, timing each on the host
clock. Only attribute names of `metrics` are read, so the tests pass the
JAX package's eval modules the same way and hold the two results equal.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np

NUM_CLASSES = 19
THINGS = (11, 13)  # KITTI-STEP's person and car
IGNORE = 255


def synthetic_sequence(hw: tuple[int, int], n_frames: int, seed: int = 0
                       ) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """(semantic maps, instance maps) of a seeded sequence, int32 [H, W]."""
    h, w = hw
    rng = np.random.RandomState(seed)
    stuff = [c for c in range(NUM_CLASSES) if c not in THINGS]
    bands = rng.choice(stuff, size=4, replace=False)
    edges = np.sort(rng.randint(h // 8, h - h // 8, size=3))
    base = np.empty((h, w), np.int32)
    for c, (y0, y1) in zip(bands, zip(np.r_[0, edges], np.r_[edges, h])):
        base[y0:y1] = c
    # (track id, class, y, x, height, width, vy, vx, first frame, last frame)
    objs = []
    for tid in range(1, 7):
        oh, ow = rng.randint(h // 8, h // 3), rng.randint(w // 16, w // 5)
        first = 0 if tid != 6 else n_frames // 2
        last = n_frames - 1 if tid != 5 else n_frames // 2
        objs.append((tid, THINGS[tid % 2], rng.randint(0, h - oh), rng.randint(0, w - ow), oh, ow,
                     rng.randint(-2, 3) * h // 96, rng.randint(-3, 4) * w // 96, first, last))
    crowd = (rng.randint(0, h // 2), rng.randint(0, w // 2), h // 6, w // 8)
    void = (rng.randint(0, h - h // 6), rng.randint(0, w - w // 5), h // 6, w // 5)
    sems, inss = [], []
    for t in range(n_frames):
        sem, ins = base.copy(), np.zeros((h, w), np.int32)
        y, x, ch, cw = crowd
        sem[y:y + ch, x:x + cw] = THINGS[1]
        for tid, cls, y, x, oh, ow, vy, vx, first, last in objs:
            if first <= t <= last:
                y0 = int(np.clip(y + vy * t, 0, h - oh))
                x0 = int(np.clip(x + vx * t, 0, w - ow))
                sem[y0:y0 + oh, x0:x0 + ow] = cls
                ins[y0:y0 + oh, x0:x0 + ow] = tid
        y, x, vh, vw = void
        sem[y:y + vh, x:x + vw] = IGNORE
        ins[y:y + vh, x:x + vw] = 0
        sems.append(sem)
        inss.append(ins)
    return sems, inss


def perturb(sems: list[np.ndarray], inss: list[np.ndarray], seed: int = 1
            ) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """A prediction of a synthetic sequence: each frame shifted by a few
    pixels, void filled with the class below it, track 1 relabelled from
    the middle frame on (an id switch), track 4 missed in every other
    frame, and a block of one wrong class."""
    rng = np.random.RandomState(seed)
    out_s, out_i = [], []
    for t, (sem, ins) in enumerate(zip(sems, inss)):
        dy, dx = rng.randint(-3, 4, size=2)
        s = np.roll(sem, (dy, dx), axis=(0, 1))
        i = np.roll(ins, (dy, dx), axis=(0, 1)).copy()
        s = np.where(s == IGNORE, np.roll(s, s.shape[0] // 5, axis=0), s)
        s = np.where(s == IGNORE, 0, s)
        if t >= len(sems) // 2:
            i[i == 1] = 9
        if t % 2:  # track 4 missed
            s[i == 4] = 0
            i[i == 4] = 0
        h, w = s.shape
        y0, x0 = rng.randint(0, h - h // 8), rng.randint(0, w - w // 8)
        s[y0:y0 + h // 8, x0:x0 + w // 8] = rng.randint(NUM_CLASSES)
        i[~np.isin(s, THINGS)] = 0
        out_s.append(s.astype(np.int32))
        out_i.append(i.astype(np.int32))
    return out_s, out_i


def port_metrics() -> SimpleNamespace:
    from video_knet_tpu_torch.eval import miou, stq, vpq

    return SimpleNamespace(vpq=vpq, stq=stq, miou=miou)


def score(pred_sems, pred_inss, gt_sems, gt_inss, *, windows=(1, 2), depth=None,
          metrics: SimpleNamespace | None = None, num_classes: int = NUM_CLASSES,
          things=THINGS) -> tuple[dict, dict]:
    """Every metric of one sequence -> (results, host ms a frame for each).
    `depth`: optional (true, predicted) lists of depth maps for DSTQ."""
    m = metrics or port_metrics()
    n = len(gt_sems)
    things_index = np.isin(np.arange(num_classes), things)
    gt_pans = [s.astype(np.int64) * m.vpq.MAX_INS + i for s, i in zip(gt_sems, gt_inss)]
    res, ms = {}, {}
    for k in windows:
        t0 = time.perf_counter()
        stats = m.vpq.window_vpq(pred_sems, pred_inss, gt_pans, eval_frames=k,
                                 num_cat=num_classes + 1)
        res[f"vpq_k{k}"] = dict(stats=stats, **m.vpq.vpq_from_stats(
            stats, num_classes=num_classes, things_index=things_index))
        ms[f"vpq_k{k}"] = (time.perf_counter() - t0) * 1e3 / n

    def enc(s, i):
        return (s.astype(np.int64) << 16) + i

    t0 = time.perf_counter()
    if depth is None:
        q = m.stq.STQuality(num_classes, list(things), IGNORE, 16, 2**25)
    else:
        q = m.stq.DSTQuality(num_classes, list(things), IGNORE, 16, 2**25)
    for t in range(n):
        d = () if depth is None else (depth[0][t], depth[1][t])
        q.update_state(enc(gt_sems[t], gt_inss[t]), enc(pred_sems[t], pred_inss[t]), *d,
                       sequence_id=0)
    res["stq"] = dict(q.result())
    ms["stq"] = (time.perf_counter() - t0) * 1e3 / n

    t0 = time.perf_counter()
    cm = m.miou.ConfusionMeter(num_classes, IGNORE)
    for s, g in zip(pred_sems, gt_sems):
        cm.update(s, g)
    res["miou"] = cm.result()
    res["vc"] = m.miou.video_consistency(pred_sems, gt_sems, window=2)
    ms["miou"] = (time.perf_counter() - t0) * 1e3 / n
    return res, ms


def flatten(results: dict) -> dict[str, np.ndarray]:
    """results of `score` -> {name: numpy value}, for comparison."""
    flat: dict[str, np.ndarray] = {}

    def walk(prefix, x):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(f"{prefix}/{k}", v)
        elif hasattr(x, "tp") and hasattr(x, "iou"):  # VPQStats
            for f in ("iou", "tp", "fn", "fp"):
                flat[f"{prefix}/{f}"] = np.asarray(getattr(x, f))
        else:
            flat[prefix] = np.asarray(x)

    walk("", results)
    return flat
