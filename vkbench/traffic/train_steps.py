"""Traffic driver: the program's VPS train step (`train/vps.py:train_step`)
on one (ref, key) pair a step, fed from batches staged on the device.

The batches are the benchmark's own: frames of seeded noise and panoptic
ground truth at the mask-assign stride, drawn from the seed. Each key
frame holds a number of thing instances of random thing classes over a
few stuff classes in bands; its ref frame holds the same instances, with
the same ids, shifted. The counts a batch takes are a fixed set that the
seed only reorders, so every seed asks the same work. `staged` batches are
cycled, as a prefetching loader hands them; stochastic depth draws from a
generator seeded from the seed and the step.

Correctness: set-up builds the train state once and drives it through its
first `check_steps` steps with the window's own call on distinct batches;
it keeps each step's loss, the first gradient as AdamW holds it after one
step (its first moment over 1 - beta1) and the parameters after the last
of them. After the window the plain reference runs the same steps from the
same weights and batches, and the losses, the gradient and the change of
the parameters are compared leaf by leaf. One step of the window, drawn
from the seed among its first `window_check_span`, is kept too: the
program's state entering it (weights, buffers, AdamW's moments), its loss
and the weights leaving it. The reference runs that step from the state
the program carried into it, and its loss and each leaf's change are
compared.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from vkbench import common
from vkbench.traffic.serve_streams import KernelShapes


def step_generator(seed, step, device):
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + step) % (1 << 62))
    return g


def make_batches(seed, mix, conf, device):
    """`staged` (img, ref_img, gt, ref_gt) on the device; gt is a dict of
    fixed-slot tensors (masks [1, G, h, w], labels, valid, ids, stuff
    masks [1, S, h, w], stuff valid)."""
    m = conf["model"]
    h, w = conf["frame_hw"]
    s = m["mask_assign_stride"]
    gh, gw = h // s, w // s
    nt, ns, slots = m["num_thing_classes"], m["num_stuff_classes"], m["max_insts"]
    rng = np.random.default_rng(seed)
    things = rng.permutation(mix["things_per_batch"])
    stuffs = rng.permutation(mix["stuff_per_batch"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 62))
    batches = []
    for k in range(mix["staged"]):
        cls = rng.choice(nt, size=slots)
        boxes = []
        for _ in range(things[k]):
            bh = int(rng.integers(gh // 10, gh * 2 // 5))
            bw = int(rng.integers(gw // 20, gw * 3 // 10))
            boxes.append((int(rng.integers(0, gh - bh)), int(rng.integers(0, gw - bw)), bh, bw))
        stuff_cls = rng.choice(ns, size=stuffs[k], replace=False)
        cuts = np.sort(rng.choice(np.arange(1, gh), size=stuffs[k] - 1, replace=False))
        shift = rng.integers(-mix["ref_shift_px"], mix["ref_shift_px"] + 1, size=2)
        frames = []
        for dy, dx in ((0, 0), tuple(shift)):
            inst = np.full((gh, gw), -1, np.int64)
            for j, (y, x, bh, bw) in enumerate(boxes):
                y0, x0 = np.clip(y + dy, 0, gh - bh), np.clip(x + dx, 0, gw - bw)
                inst[y0:y0 + bh, x0:x0 + bw] = j
            band = np.searchsorted(cuts, np.arange(gh), side="right")
            stuff = np.broadcast_to(stuff_cls[band][:, None], (gh, gw))
            frames.append((inst, stuff))
        gts = []
        for inst, stuff in frames:
            inst_t = torch.from_numpy(inst).to(device)
            stuff_t = torch.from_numpy(np.ascontiguousarray(stuff)).to(device)
            masks = (inst_t[None, None] == torch.arange(slots, device=device)[None, :, None, None])
            sem = ((stuff_t[None, None] == torch.arange(ns, device=device)[None, :, None, None])
                   & (inst_t < 0)[None, None])
            valid = masks.flatten(2).any(-1)
            gts.append(dict(
                masks=masks.float(), labels=torch.from_numpy(cls[None].astype(np.int32)).to(device),
                valid=valid,
                ids=torch.where(valid, torch.arange(slots, device=device, dtype=torch.int32), -1),
                sem_masks=sem.float(), sem_valid=sem.flatten(2).any(-1)))
        img = torch.randn((2, h, w, 3), generator=gen, device=device)
        batches.append((img[:1], img[1:], gts[0], gts[1]))
    return batches


def port_batch(batch):
    from video_knet_tpu_torch.ops.targets import PanopticGT
    from video_knet_tpu_torch.train.vps import VPSBatch

    img, ref_img, gt, ref_gt = batch

    def pan(g):
        return PanopticGT(g["masks"], g["labels"], g["valid"], g["ids"], g["sem_masks"],
                          g["sem_valid"])

    return VPSBatch(img, ref_img, pan(gt), pan(ref_gt))


def train_flops(template, conf, hw):
    """Operations of the reference's forward and backward of one step, on
    meta tensors (the loss block's own products are not counted)."""
    from torch.utils.flop_counter import FlopCounterMode

    from vkbench.reference.model import forward_train
    from vkbench.reference.train import trainable

    cfg = conf["model"]
    sd = {k: torch.empty(s, device="meta", requires_grad=trainable(k, cfg))
          for k, s in template.items()}
    img = torch.empty((1, *hw, 3), device="meta")
    with FlopCounterMode(display=False) as fc:
        out = forward_train(img, img, cfg, sd)
        leaves = [out["key_embeds"], out["ref_embeds"]]
        for br in ("key", "ref"):
            leaves += [out[br + "_head"]["seg"], out[br + "_head"]["masks"]]
            leaves += [t for o in out[br + "_outs"] for t in (o["cls"], o["scaled"])]
        sum(t.sum() for t in leaves).backward()
    return fc.get_total_flops()


class Driver:
    def __init__(self, cell, seed, seconds, trace, device):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device = torch.device(device)
        self.conf, self.mix = cell["config"], cell["traffic"]
        self.hw = tuple(self.conf["frame_hw"])
        self.cuda = self.device.type == "cuda"

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def setup(self):
        self.marks = [("process start, imports, CUDA init", time.perf_counter())]
        from video_knet_tpu_torch.models.video.knet_vps import VideoKNet
        from video_knet_tpu_torch.train.optim import make_optimizer
        from video_knet_tpu_torch.train.train_state import create_train_state
        from video_knet_tpu_torch.train.vps import train_step

        conf, mix = self.conf, self.mix
        o = conf["model"]["optim"]
        cfg = common.port_config(conf)
        model = VideoKNet(cfg, device=self.device)
        self.marks.append(("model", time.perf_counter()))
        self.template = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        self.sd = common.make_weights(self.template, conf["weight_seed"], self.device)
        model.load_state_dict(self.sd)
        self.marks.append(("weights", time.perf_counter()))
        opt = make_optimizer(model, o["steps_per_epoch"], base_lr=o["base_lr"],
                             weight_decay=o["weight_decay"], backbone_lr_mult=o["backbone_lr_mult"],
                             grad_clip=o["grad_clip"], warmup_iters=o["warmup_iters"])
        self.state = create_train_state(model, opt)
        self.marks.append(("optimizer", time.perf_counter()))
        self.train_step = train_step
        self.shapes = KernelShapes() if self.trace else None
        self.batches = make_batches(self.seed, mix, conf, self.device)
        self.port_batches = [port_batch(b) for b in self.batches]
        self.marks.append(("batches", time.perf_counter()))
        if self.trace:  # only the traced run's MFU reads it
            self.flops_step = train_flops(self.template, conf, self.hw)
            self.marks.append(("operation count", time.perf_counter()))
        names = {p: n for n, p in model.named_parameters()}
        self.names = names
        first = mix["check_steps"]
        self.k_check = first + int(np.random.default_rng(self.seed).integers(
            mix["window_check_span"]))
        self.kept = None
        self.losses = []
        for i in range(mix["check_steps"]):
            out = self._step(i)
            self.losses.append(float(out["total_loss"]))
            if i == 0:  # a new tensor a leaf: later steps leave it alone
                self.first_grad = {names[p]: s["exp_avg"] / (1 - o["beta1"])
                                   for p, s in opt.adamw.state.items()}
        self.after = {n: p.detach().clone() for n, p in model.named_parameters()}
        self._sync()
        self.t_start = time.perf_counter()
        self.marks.append(("first steps (warm-up)", self.t_start))

    def _step(self, i):
        batch = self.port_batches[i % len(self.port_batches)]
        gen = step_generator(self.seed, i, self.device)
        self.state, out = self.train_step(self.state, batch, gen)
        return out

    def _run_until(self, deadline, first):
        """Steps from `first` until `deadline`, and on past it until the
        step the check keeps has run."""
        i, totals = first, []
        while time.perf_counter() < deadline or self.kept is None:
            if i == self.k_check:
                entering = self._snapshot()
            totals.append(self._step(i)["total_loss"])
            if i == self.k_check:
                self.kept = dict(entering, loss=totals[-1], after={
                    n: p.detach().clone() for p, n in self.names.items()})
            i += 1
        return i, totals

    def _snapshot(self):
        """The program's train state entering a step, copied on the device:
        weights and buffers, AdamW's moments and its step count."""
        model, adamw = self.state.model, self.state.optimizer.adamw
        sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
        moments, counts = {}, []
        for p, n in self.names.items():
            st = adamw.state.get(p)
            if st:
                moments[n] = (st["exp_avg"].clone(), st["exp_avg_sq"].clone())
                step = st["step"]  # read after the window: no wait on the device in it
                counts.append(step.clone() if torch.is_tensor(step) else step)
        return dict(sd=sd, moments=moments, counts=counts)

    def _held_bytes(self):
        """Device bytes the check holds (copies the program does not make)."""
        kept = [] if self.kept is None else (
            list(self.kept["sd"].values()) + list(self.kept["after"].values())
            + [t for pair in self.kept["moments"].values() for t in pair])
        tensors = list(self.after.values()) + list(self.first_grad.values()) + kept
        return sum(-(-t.untyped_storage().nbytes() // 512) * 512 for t in tensors)

    def window(self):
        first = self.mix["check_steps"]
        end, totals = self._run_until(self.t_start + self.seconds, first)
        self._sync()
        wall = time.perf_counter() - self.t_start
        steps = end - first
        self.attempted = steps
        self.failed = int((~torch.isfinite(torch.stack(totals))).sum())
        return {"train_step_ms": wall / steps * 1e3}, steps

    def window_traced(self):
        from torch.profiler import ProfilerActivity, profile

        first = self.mix["check_steps"]
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        end, totals = self._run_until(self.t_start + self.seconds / 2, first)
        self._sync()
        plain_s = time.perf_counter() - self.t_start
        peak = (torch.cuda.max_memory_allocated(self.device) - self._held_bytes()
                if self.cuda else None)
        self.shapes.on = True
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            p0 = time.perf_counter()
            for i in range(end, end + self.mix["profiled_steps"]):
                totals.append(self._step(i)["total_loss"])
            self._sync()
            p1 = time.perf_counter()
        self.shapes.on = False
        self.attempted = end + self.mix["profiled_steps"] - first
        self.failed = int((~torch.isfinite(torch.stack(totals))).sum())
        return dict(
            kind="train", events=prof.events(), profiled_s=p1 - p0,
            profiled_items=self.mix["profiled_steps"], plain_s=plain_s, plain_items=end - first,
            flops_per_item=self.flops_step, peak_alloc=peak, shapes=self.shapes.counts,
            kernels={"k1": "mask_pool_", "k2": "assemble_kernel"},
            loss_block_ms=self._loss_block_ms(),
        ), self.attempted

    def _loss_block_ms(self, warm=2, calls=5):
        """ms of one call of the program's loss block (`video_knet_loss`)
        and its backward at fixed model outputs: isolated synchronised
        calls, the step's other parts left out."""
        from video_knet_tpu_torch.models.video.knet_vps import video_knet_loss

        model = self.state.model
        batch = self.port_batches[0]
        model.train()
        try:
            with torch.no_grad():
                outs = model.forward_train(batch.img, batch.ref_img, None)
        finally:
            model.eval()

        def leaves(x):
            if torch.is_tensor(x):
                return x.detach().requires_grad_() if x.is_floating_point() else x
            if isinstance(x, tuple) and hasattr(x, "_fields"):
                return type(x)(*[leaves(v) for v in x])
            if isinstance(x, (list, tuple)):
                return type(x)(leaves(v) for v in x)
            return x

        ms = []
        for k in range(warm + calls):
            key, ref, key_emb, ref_emb = leaves(outs)
            self._sync()
            t = time.perf_counter()
            loss = sum(video_knet_loss((key, ref), (key_emb, ref_emb), batch.gt, batch.ref_gt,
                                       model.cfg).values())
            loss.backward()
            self._sync()
            if k >= warm:
                ms.append((time.perf_counter() - t) * 1e3)
        return float(np.mean(ms))

    def release(self):
        del self.state, self.train_step, self.port_batches
        if self.cuda:
            torch.cuda.empty_cache()

    def check(self, modes=("program",)):
        from vkbench.reference.train import train_step_from, train_steps

        cfg = self.conf["model"]
        n = self.mix["check_steps"]
        runs = {}
        for mode in set(modes) | {"program"}:
            torch.backends.cuda.matmul.allow_tf32 = mode == "control"
            torch.backends.cudnn.allow_tf32 = mode == "control"
            runs[mode] = train_steps(self.sd, cfg, self.batches[:n],
                                     [step_generator(self.seed, i, self.device) for i in range(n)])
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        ref_losses, ref_grad, ref_after, matched = runs["program"]
        out = {}
        for mode in modes:
            if mode == "program":
                got = (self.losses, self.first_grad, self.after)
            else:
                got = runs[mode][:3]
            out[mode] = compare(ref_losses, ref_grad, ref_after, self.sd, *got)
        # the window's step, from the state the program carried into it
        k, kept = self.k_check, self.kept
        batch = self.batches[k % len(self.batches)]
        wins = {}
        for mode in set(modes) | {"program"}:
            torch.backends.cuda.matmul.allow_tf32 = mode == "control"
            torch.backends.cudnn.allow_tf32 = mode == "control"
            wins[mode] = train_step_from(kept["sd"], kept["moments"], k, cfg, batch,
                                         step_generator(self.seed, k, self.device))
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        w_loss, w_grad, w_after, w_matched = wins["program"]
        for mode in modes:
            got = ((float(kept["loss"]), kept["after"]) if mode == "program"
                   else (wins[mode][0], wins[mode][2]))
            out[mode].update(compare_step(w_loss, w_grad, w_after, kept["sd"], *got))
        work = [f"GT thing instances a staged batch: "
                f"{[int(b[2]['valid'].sum()) for b in self.batches]}",
                f"instances matched a check step (key frame): {matched}",
                f"losses a check step: program {self.losses}, reference {ref_losses}",
                f"window step checked: {k} (AdamW's count entering it: "
                f"{sorted({int(c) for c in kept['counts']})}), instances matched {w_matched}, "
                f"loss program {float(kept['loss'])!r}, reference {w_loss!r}"]
        return out, work


def compare(ref_losses, ref_grad, ref_after, start, losses, grad, after):
    """The first step's loss gap (both sides start from the same weights),
    the worst step's, and by the worst leaf the gap between the two sides'
    norms of the first gradient and of the parameters' change, over the
    larger of the leaf's reference norm and the median leaf's."""
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    loss1_rel = abs(losses[0] - ref_losses[0]) / abs(ref_losses[0])
    gnorm, g_med, kept = _moving_leaves(ref_grad)
    # a leaf the program's optimizer holds no moment for took no gradient
    grad_gap = max(abs((float(grad[k].norm()) if k in grad else 0.0) - gnorm[k])
                   / max(gnorm[k], g_med) for k in kept)
    return dict(loss1_rel=loss1_rel, loss_rel=loss_rel, grad_gap=grad_gap,
                step_gap=_change_gap(kept, ref_after, start, after),
                leaves_left_out=len(gnorm) - len(kept))


def compare_step(ref_loss, ref_grad, ref_after, start, loss, after):
    """One step from a state both sides share: its loss gap and, by the
    worst leaf, the gap between the two sides' norms of the parameters'
    change, as `compare` takes them."""
    _, _, kept = _moving_leaves(ref_grad)
    return dict(window_loss_rel=abs(loss - ref_loss) / abs(ref_loss),
                window_step_gap=_change_gap(kept, ref_after, start, after))


def _moving_leaves(ref_grad):
    """Each leaf's reference gradient norm, the median leaf's, and the
    leaves compared: those under a thousandth of the median move by
    round-off alone and are left out."""
    gnorm = {k: float(v.norm()) for k, v in ref_grad.items()}
    g_med = float(np.median(list(gnorm.values())))
    return gnorm, g_med, [k for k, v in gnorm.items() if v >= 1e-3 * g_med]


def _change_gap(kept, ref_after, start, after):
    """By the worst leaf, the gap between the two sides' norms of the
    change from `start`, over the larger of the leaf's reference norm and
    the median leaf's."""
    dref = {k: float((ref_after[k] - start[k]).norm()) for k in kept}
    d_med = float(np.median(list(dref.values())))
    return max(abs(float((after[k] - start[k]).norm()) - dref[k]) / max(dref[k], d_med)
               for k in kept)
