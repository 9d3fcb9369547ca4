"""Traffic driver: B video streams served by the program's
`MultiStreamVPSPipeline.run_batched_sequence`, in a closed loop.

The frames are float32 normalised host arrays made at set-up from the
seed: each stream is a random scene (a coarse field plus detail) that
drifts along a closed path, `ring_rounds` rounds long and replayed
cyclically, so consecutive frames of a stream are related as a video's
are and no sequence restarts after the first round. The host-to-device
copy of each round is in the timed path. Rounds arrive at the fixed rate
`offered_fps` (all streams' frames together; null: a closed loop, the next
round handed over as soon as the pipeline asks for it) and are handed over
once due; above the rate the system sustains they queue.

Latency of a frame: from the moment its round was due to the moment the
pipeline yields its result. The window runs from the first timed round to
the last result yielded; no round is offered after `seconds`.

Correctness: rounds drawn from the seed (and the first two) keep the
program's carried state (the previous frame's kernels and the tracker
memory) as it enters them and as it leaves them; after the window the
plain reference serves each such round from the state the program carried
into it, and its frames and the state it leaves are compared with the
program's. The first round starts from an empty state on both sides.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from vkbench import common

K1_KEY, K2_KEY = "mask_pool_", "assemble_kernel"
BACKBONE_SPAN = "vkbench.backbone_neck"


def make_ring(seed, rounds, streams, hw, drift, detail, scene_seed=0):
    """[rounds][streams, H, W, 3] float32 frames. The scenes are one fixed
    set (`scene_seed`); the seed deals them to the streams and sets where
    on its path each stream starts, so every seed serves the same frames in
    another order."""
    h, w = hw
    pool = np.random.default_rng(scene_seed)
    coarse = pool.standard_normal((streams, h // 8 + 1, w // 8 + 1, 3), dtype=np.float32)
    scene = np.repeat(np.repeat(coarse, 8, axis=1), 8, axis=2)[:, :h, :w]
    scene += detail * pool.standard_normal((streams, h, w, 3), dtype=np.float32)
    rng = np.random.default_rng(seed)
    deal, phase = rng.permutation(streams), rng.integers(0, rounds, size=streams)
    ring = []
    for t in range(rounds):
        frame = np.empty((streams, h, w, 3), np.float32)
        for i in range(streams):
            a = 2 * math.pi * (t + phase[i]) / rounds
            shift = (round(drift[0] * math.sin(a)), round(drift[1] * math.cos(a)))
            frame[i] = np.roll(scene[deal[i]], shift, axis=(0, 1))
        ring.append(frame)
    return ring


def reference_cfg(conf):
    m = dict(conf["model"])
    m["thing_ids"] = tuple(m["thing_ids"]) if m.get("thing_ids") is not None else None
    return m


def meta_flops(fn, template, *shapes_and_dtypes) -> int:
    """Operations the plain reference counts for `fn(*inputs, sd)` on meta
    tensors (no memory, no device work)."""
    from torch.utils.flop_counter import FlopCounterMode

    sd = {k: torch.empty(s, device="meta") for k, s in template.items()}
    args = [torch.empty(s, dtype=d, device="meta") for s, d in shapes_and_dtypes]
    with FlopCounterMode(display=False) as fc:
        fn(*args, sd)
    return fc.get_total_flops()


class KernelShapes:
    """Counts the (B, N, H, W, C) of each K1 and K2 launch while `on`, by
    wrapping the program's entry points from outside."""

    def __init__(self):
        from video_knet_tpu_torch.models import kernel_head, kernel_update_head
        from video_knet_tpu_torch.ops import mask_pool

        self.on = False
        self.counts = {"k1": {}, "k2": {}}

        def wrap(fn, kind, shape):
            def counted(*args, **kwargs):
                if self.on:
                    s = shape(*args)
                    self.counts[kind][s] = self.counts[kind].get(s, 0) + 1
                return fn(*args, **kwargs)
            return counted

        def k1(logits, feats, *_):
            return (*logits.shape, feats.shape[-1])

        def k2(kern, feats, *_):
            return (*kern.shape[:2], *feats.shape[1:])

        mask_pool.fused_mask_pool = wrap(mask_pool.fused_mask_pool, "k1", k1)
        for mod in (kernel_head, kernel_update_head):
            mod.fused_assemble = wrap(mod.fused_assemble, "k2", k2)


class Driver:
    def __init__(self, cell, seed, seconds, trace, device):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device = torch.device(device)
        self.conf, self.mix = cell["config"], cell["traffic"]
        self.hw = tuple(self.conf["frame_hw"])
        self.n = self.mix["streams"]

    # ------------------------------------------------------------- set-up

    def setup(self):
        self.marks = [("process start, imports, CUDA init", time.perf_counter())]
        from video_knet_tpu_torch.models.video.inference import MultiStreamVPSPipeline
        from video_knet_tpu_torch.models.video.knet_vps import VideoKNet

        from vkbench.reference.model import test_step

        mix, conf = self.mix, self.conf
        cfg = common.port_config(conf)
        model = VideoKNet(cfg, device=self.device)
        self.marks.append(("model", time.perf_counter()))
        self.template = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        self.sd = common.make_weights(self.template, conf["weight_seed"], self.device)
        model.load_state_dict(self.sd)
        self.marks.append(("weights", time.perf_counter()))
        self.model = model
        self.shapes = KernelShapes() if self.trace else None
        if self.trace:
            inner = model.extract_feat

            def extract_feat(*args, **kwargs):
                with torch.profiler.record_function(BACKBONE_SPAN):
                    return inner(*args, **kwargs)
            model.extract_feat = extract_feat
        thing_ids = conf["model"].get("thing_ids")
        self.pipe = MultiStreamVPSPipeline(
            model, cfg, self.hw, self.n,
            thing_ids_in_orig=None if thing_ids is None else tuple(thing_ids),
            tracker_type=mix["tracker"], device=self.device)
        self.ring = make_ring(self.seed, mix["ring_rounds"], self.n, self.hw, mix["drift_px"],
                              mix["detail"], mix["scene_seed"])
        self.marks.append(("pipeline and frames", time.perf_counter()))
        # rounds whose state and results are kept for the output check
        draws = np.random.default_rng(self.seed).random(1 << 16)
        every = mix["check_every"]
        self.checked = lambda r: r < 2 or (
            r >= mix["warmup_rounds"] and draws[r % len(draws)] < 1 / every)
        self.states, self.results, self.take, self.due, self.lat = {}, {}, {}, {}, {}
        self.n_stepped, self.t_start, self.stopped = 0, None, False
        step = self.pipe._step

        def kept_step(imgs, flags):
            r = self.n_stepped
            self.n_stepped += 1
            if self.checked(r) or self.checked(r - 1):
                self.states[r] = (self.pipe.prev_obj, self.pipe.track_state)
            return step(imgs, flags)
        self.pipe._step = kept_step
        if self.trace:  # only the traced run's MFU reads it
            n_tot = cfg.num_proposals + cfg.num_stuff_classes
            self.flops_round = meta_flops(
                lambda img, prev, first, sd: test_step(img, prev, first, reference_cfg(conf), sd),
                self.template, ((self.n, *self.hw, 3), torch.float32),
                ((self.n, n_tot, 1, cfg.head.in_channels), torch.float32), ((self.n,), torch.bool))
            self.marks.append(("operation count", time.perf_counter()))
        self.stats = []
        self.results_it = iter(self.pipe.run_batched_sequence(
            self._source(), depth=mix["depth"], window=mix["window"], stats=self.stats))
        self.got = 0
        while self.got < mix["warmup_rounds"]:
            self._next()
        self.marks.append(("warm-up", time.perf_counter()))

    def _source(self):
        """Rounds as the pipeline pulls them. Warm-up rounds go at once; a
        timed round is due `streams / offered_fps` seconds after the one
        before it (closed loop, `offered_fps` null: due when pulled) and is
        handed over once due. No round is offered once the window closes."""
        rate, w0 = self.mix["offered_fps"], self.mix["warmup_rounds"]
        r = 0
        while True:
            now = time.perf_counter()
            if r == w0:
                self.t_start = now
            due = now
            if r >= w0:
                if rate:
                    due = self.t_start + (r - w0) * self.n / rate
                if r > w0 and self._stop(now, due):
                    return
                if due > now:
                    time.sleep(due - now)
            self.due[r] = due
            self.take[r] = time.perf_counter()
            yield self.ring[r % len(self.ring)]
            r += 1

    def _stop(self, now, due):
        if not self.stopped and not self.trace:
            self.stopped = max(now, due) - self.t_start >= self.seconds
        return self.stopped

    def _next(self):
        out = next(self.results_it)
        t = time.perf_counter()
        r = self.got
        self.got += 1
        self.lat[r] = t - self.due[r]
        if self.checked(r):
            self.results[r] = out
        return r, t

    def _drain(self):
        last = None
        for _ in iter(self._next_or_none, None):
            last = time.perf_counter()
        return last

    def _next_or_none(self):
        try:
            return self._next()
        except StopIteration:
            return None

    # ------------------------------------------------------------- window

    def window(self):
        """The end-to-end metrics of a timed window (profiler off)."""
        last = self._drain()
        w0 = self.mix["warmup_rounds"]
        rounds = self.got - w0
        lat_ms = np.repeat([self.lat[r] * 1e3 for r in range(w0, self.got)], self.n)
        late = [self.take[r] - self.due[r] for r in range(w0, self.got)]
        # frames a second in each sixth of the window: phases inside a run
        edges = np.linspace(self.t_start, last, 7)
        ends = np.array([self.due[r] + self.lat[r] for r in range(w0, self.got)])
        sixths = np.histogram(ends, edges)[0] * self.n / np.diff(edges)
        self.attempted = rounds * self.n
        self.notes = [f"timed rounds {rounds}; a round handed over after it was due by "
                      f"{np.mean(late) * 1e3:.1f} ms on average, {np.max(late) * 1e3:.1f} at most; "
                      f"frame latency p50 {np.percentile(lat_ms, 50):.1f} ms, "
                      f"p95 {np.percentile(lat_ms, 95):.1f} ms; frames/s by sixth of the window "
                      f"{np.round(sixths, 1).tolist()}"]
        return {"serve_fps": rounds * self.n / (last - self.t_start),
                "frame_p95_ms": float(np.percentile(lat_ms, 95))}, self.attempted

    def window_traced(self):
        """Records for the per-layer readers: the first half of the window
        with the profiler off, then `profiled_rounds` rounds under it."""
        from torch.profiler import ProfilerActivity, profile

        w0 = self.mix["warmup_rounds"]
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        stats0 = len(self.stats)
        while True:
            r, t = self._next()
            if t - self.t_start >= self.seconds / 2:
                break
        plain_rounds, plain_s, stats1 = r + 1 - w0, t - self.t_start, len(self.stats)
        peak = torch.cuda.max_memory_allocated(self.device) if cuda else None
        self.shapes.on = True
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            p0 = time.perf_counter()
            for _ in range(self.mix["profiled_rounds"]):
                self._next()
            if cuda:
                torch.cuda.synchronize(self.device)
            p1 = time.perf_counter()
        self.shapes.on = False
        self.stopped = True
        self._drain()
        self.attempted = (self.got - w0) * self.n
        plain = self.stats[stats0:stats1]
        return dict(
            kind="serve", events=prof.events(), profiled_s=p1 - p0,
            profiled_items=self.mix["profiled_rounds"] * self.n,
            plain_s=plain_s, plain_items=plain_rounds * self.n,
            flops_per_item=self.flops_round / self.n, peak_alloc=peak,
            host_s=sum(s["host_s"] for s in plain), host_frames=sum(s["frames"] for s in plain),
            shapes=self.shapes.counts, spans={"backbone": BACKBONE_SPAN},
            kernels={"k1": K1_KEY, "k2": K2_KEY},
        ), self.attempted

    def release(self):
        """Frees the program, keeping what the check reads."""
        self.final_state = (self.pipe.prev_obj, self.pipe.track_state)
        self.pipe.close()
        del self.pipe, self.model, self.results_it
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -------------------------------------------------------------- check

    def check(self, modes=("program",)):
        """{mode: {number: value}} for the checked rounds, and the lines
        that say what work the seed gave."""
        from vkbench.reference.serve import TRACKER_FIELDS, empty_tracker, serve_round

        cfg = reference_cfg(self.conf)
        tc = cfg["tracker"]
        out = {m: dict(pan_px=0.0, sem_px=0.0, track_px=0.0, pan_px_worst=0.0, kernels_rel=0.0,
                       memo_rel=0.0, memo_slots=0, frames=0) for m in modes}
        things, tracks, frames = 0, 0, 0
        last = self.got - 1
        for r in sorted(self.results):
            imgs = torch.from_numpy(self.ring[r % len(self.ring)]).to(self.device)
            first = torch.full((self.n,), r == 0, device=self.device)
            prev, ts = self.states[r]
            trackers = [empty_tracker(tc["memo_capacity"], cfg["max_per_img"], prev.shape[-1])
                        if r == 0 else {f: getattr(ts, f)[i].cpu() for f in TRACKER_FIELDS}
                        for i in range(self.n)]
            if r == 0:
                prev = torch.zeros_like(prev)
            after = self.states.get(r + 1, self.final_state if r == last else None)
            runs = {}
            for mode in set(modes) | {"program"}:
                torch.backends.cuda.matmul.allow_tf32 = mode == "control"
                torch.backends.cudnn.allow_tf32 = mode == "control"
                runs[mode] = serve_round(imgs, prev, trackers, first, cfg, self.sd, self.hw)
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
            ref = runs["program"]
            for mode in modes:
                if mode == "program":
                    got = ([dict(pan=f.panoptic_seg, sem=f.semantic_map, track=f.track_map)
                            for f in self.results[r]],
                           None if after is None else after[0],
                           None if after is None else [
                               {f: getattr(after[1], f)[i].cpu() for f in TRACKER_FIELDS}
                               for i in range(self.n)])
                else:
                    got = runs[mode]
                _compare(out[mode], ref, got)
            for f in self.results[r]:
                things += sum(1 for s in f.segments_info if s["isthing"])
                tracks += len(np.unique(f.track_map[f.track_map > 0]))
                frames += 1
        for acc in out.values():
            for key in ("pan_px", "sem_px", "track_px"):
                acc[key] /= max(acc["frames"], 1)
            del acc["frames"]
        work = getattr(self, "notes", []) + [f"checked rounds: {sorted(self.results)}",
                f"things kept a frame: {things / max(frames, 1):.2f}; "
                f"live tracks a frame: {tracks / max(frames, 1):.2f} (checked frames)"]
        return out, work


def segment_mismatch(ref_ids, got_ids):
    """Share of pixels whose segment differs, whatever the ids: each of
    `got`'s segments stands for the reference segment it overlaps most."""
    ref_ids, got_ids = np.asarray(ref_ids, np.int64).ravel(), np.asarray(got_ids, np.int64).ravel()
    pairs, count = np.unique(got_ids * (ref_ids.max() + 1) + ref_ids, return_counts=True)
    got_of, ref_of = np.divmod(pairs, ref_ids.max() + 1)
    best = {}
    for g, r, c in zip(got_of, ref_of, count):
        if c > best.get(g, (0, -1))[0]:
            best[g] = (c, r)
    agree = sum(c for c, _ in best.values())
    return float(1.0 - agree / ref_ids.size)


def _compare(acc, ref, got):
    """Adds each frame's shares of differing pixels (the run's number is
    their mean over the checked frames) and keeps the worst state gaps."""
    ref_frames, ref_k, ref_tr = ref
    got_frames, got_k, got_tr = got
    for a, b in zip(ref_frames, got_frames):
        pan = segment_mismatch(a["pan"], b["pan"])
        acc["pan_px"] += pan
        acc["pan_px_worst"] = max(acc["pan_px_worst"], pan)
        for key in ("sem", "track"):
            acc[key + "_px"] += float(np.mean(np.asarray(a[key]) != np.asarray(b[key])))
        acc["frames"] += 1
    if got_k is not None:
        for i in range(ref_k.shape[0]):
            rel = float((got_k[i] - ref_k[i]).norm() / ref_k[i].norm().clamp(min=1e-30))
            acc["kernels_rel"] = max(acc["kernels_rel"], rel)
    if got_tr is not None:
        for a, b in zip(ref_tr, got_tr):
            same = ((a["valid"] == b["valid"]) & (a["ids"] == b["ids"])
                    & (a["labels"] == b["labels"]))
            acc["memo_slots"] += int((~same).sum()) + int(a["next_id"] != b["next_id"])
            v = a["valid"] & b["valid"]
            if bool(v.any()):
                rel = float((a["embeds"][v] - b["embeds"][v]).norm()
                            / a["embeds"][v].norm().clamp(min=1e-30))
                acc["memo_rel"] = max(acc["memo_rel"], rel)
