"""Where a VPS train step's time goes, on one NVIDIA GPU.

    python3 -m video_knet_tpu_torch.tools.profile_train [--hw 384 1248]
        [--batch 1] [--bf16] [--iters 10] [--device cuda|cpu]

Counterpart of the reference package's `scripts/profile_train.py`: Video
K-Net R-50 + FPN with the KITTI-STEP heads (`VideoKNetConfig(max_insts=8)`,
100 + 17 kernels), seeded random weights, one `make_synthetic_batch`, the
port's AdamW (`train/optim.py`, lr 1e-4, weight decay 5e-2). Times each
part of the step apart, each its own call:

  full        the production step, `train/vps.py:train_step` (forward,
              losses, backward, the per-group clip, AdamW)
  fwd         the loss value only (`make_vps_loss_fn`, no autograd)
  backbone    backbone + neck forward and backward on [ref; key] with a
              proxy loss, the sum of each level's mean square
  loss_block  `video_knet_loss` forward and backward at fixed model
              outputs (the costs, the Hungarian solve, the targets, the
              loss math; no model)

`heads_fwd_bwd_ms_est` = full - backbone - loss_block, as the reference
estimates it: the heads, and what the step shares (the optimizer, the GT
preparation). With `--bf16` every part runs as the bf16 step does
(`utils/precision.py:bf16_forward`, bf16 images; the losses in fp32).

A part's time is the median, and its spread the min and max, of `--iters`
calls after warm-up calls, each call between two `torch.cuda.synchronize()`
on the host clock: a host sync inside a part is part of its time. The
sub-blocks run before the `full` steps, which move the weights.

FLOPs and bytes come from one separate call of each part, never a timed
one: FLOPs by `torch.utils.flop_counter.FlopCounterMode` over the forward
and the backward plus the two mask kernels' forwards
(`ops/kernels/mask_ops.py:FLOPS`), under `tools/get_flops.py`'s convention;
bytes by a dispatch mode that adds each aten op's tensor inputs and outputs
once (views and empty allocations move none) plus the bytes each CUDA
kernel must move, reckoned from its shapes (`mask_ops.BYTES`,
`hungarian.BYTES`), which no dispatch mode sees. The ideal times divide
them by the published peaks of an H100 SXM (NVIDIA's data sheet, dense
rates): 67 TFLOP/s fp32 outside the tensor cores (training keeps TF32 off),
989 TFLOP/s bf16 with `--bf16`, 3.35 TB/s HBM.

Prints one JSON line; writes nothing. On the card the line carries the
card's name and power limit as `nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader` gives them.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from video_knet_tpu_torch.tools import _cli
from video_knet_tpu_torch.tools.get_flops import COUNTING

HW = (384, 1248)
PARTS = ("full", "fwd", "backbone", "loss_block")
# the reference's key of each part's time
MS_KEYS = {"full": "full_ms", "fwd": "fwd_ms", "backbone": "backbone_fwd_bwd_ms",
           "loss_block": "loss_block_fwd_bwd_ms"}
PEAKS = {False: ("67 TFLOP/s fp32 outside the tensor cores (H100 SXM)", 67e12),
         True: ("989 TFLOP/s bf16 on the tensor cores, dense (H100 SXM)", 989e12)}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BYTES_COUNTING = ("Bytes add each aten op's tensor inputs and outputs once (views and empty "
                  "allocations none) and each CUDA kernel's inputs read once and outputs "
                  "written once, reckoned from its shapes.")
WARMUP = 2
# what moves no bytes: views, and allocations that write nothing
_NO_BYTES = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
             torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
             torch.ops.aten.new_empty_strided.default}


class ByteCounter(TorchDispatchMode):
    """Inside: `bytes` adds the tensor inputs and outputs of every aten op
    that moves data, each once."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func not in _NO_BYTES:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out)) if torch.is_tensor(t))
        return out


def backbone_loss(model, batch, bf16: bool) -> torch.Tensor:
    """The reference's proxy loss of the backbone and neck: the sum over the
    levels of `model.extract_feat([ref; key])` of each level's mean square,
    in fp32; with `bf16` the features of the bf16 forward on bf16 images."""
    both = torch.cat([batch.ref_img, batch.img])
    if bf16:
        from video_knet_tpu_torch.utils.precision import bf16_forward

        feats = bf16_forward(model, "extract_feat", both.to(torch.bfloat16))
    else:
        feats = model.extract_feat(both)
    return sum(torch.mean(torch.square(f.float())) for f in feats)


def model_outputs(model, batch, bf16: bool):
    """(key, ref, key_emb, ref_emb) of the step's train forward on `batch`
    (fp32 outputs, also under `bf16`)."""
    from video_knet_tpu_torch.train.vps import vps_train_forward

    gt_masks = ((batch.gt.masks, batch.ref_gt.masks)
                if model.cfg.track_head_type == "roi_gt_box" else ())
    return vps_train_forward(model, bf16, batch.img, batch.ref_img, None, *gt_masks)


def output_leaves(outs):
    """`outs` with every floating tensor a new leaf that requires grad (no
    copy), the rest as it is."""
    from video_knet_tpu_torch.utils.tree import tree_map

    return tree_map(lambda x: x.detach().requires_grad_()
                    if torch.is_tensor(x) and x.is_floating_point() else x, outs)


def loss_block(outs, batch, cfg) -> torch.Tensor:
    """The sum of `video_knet_loss` at the model outputs `outs`."""
    from video_knet_tpu_torch.models.video.knet_vps import video_knet_loss

    key, ref, key_emb, ref_emb = outs
    return sum(video_knet_loss((key, ref), (key_emb, ref_emb), batch.gt, batch.ref_gt,
                               cfg).values())


@contextlib.contextmanager
def _training(model):
    """Training mode, as the step sets it, and eval mode after."""
    model.train()
    try:
        yield
    finally:
        model.eval()


def make_parts(state, batch) -> dict:
    """{part: a call of it} on `state`'s model and `batch`. The loss block
    runs at the outputs of one forward made here, with no autograd."""
    from video_knet_tpu_torch.train.vps import make_vps_loss_fn, train_step

    model = state.model
    cfg = model.cfg
    loss_fn = make_vps_loss_fn(model, cfg)  # TF32 off first (check_train_config)
    with torch.no_grad(), _training(model):
        outs = model_outputs(model, batch, cfg.bf16_train)

    def full():
        return train_step(state, batch)[1]

    def fwd():
        with torch.no_grad(), _training(model):
            return loss_fn(batch)[0]

    def backbone():
        model.zero_grad(set_to_none=True)
        with _training(model):
            loss = backbone_loss(model, batch, cfg.bf16_train)
        loss.backward()
        return loss

    def block():
        leaves = output_leaves(outs)
        loss = loss_block(leaves, batch, cfg)
        loss.backward()
        return leaves

    return {"full": full, "fwd": fwd, "backbone": backbone, "loss_block": block}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device: torch.device, iters: int) -> list[float]:
    """ms of each of `iters` calls of `fn`, after WARMUP calls."""
    for _ in range(WARMUP):
        fn()
    ms = []
    for _ in range(iters):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def _kernel_work() -> tuple[int, int]:
    """(FLOPs, bytes) the CUDA kernels counted so far."""
    from video_knet_tpu_torch.ops.kernels import hungarian, mask_ops

    return (sum(mask_ops.FLOPS.values()),
            sum(mask_ops.BYTES.values()) + sum(hungarian.BYTES.values()))


def count(fn) -> tuple[int, int]:
    """(FLOPs, bytes) of one call of `fn`, as the module docstring counts
    them."""
    from torch.utils.flop_counter import FlopCounterMode

    flops0, bytes0 = _kernel_work()
    with FlopCounterMode(display=False) as flops, ByteCounter() as moved:
        fn()
    flops1, bytes1 = _kernel_work()
    return flops.get_total_flops() + flops1 - flops0, moved.bytes + bytes1 - bytes0


def _launches() -> dict:
    from video_knet_tpu_torch.ops.kernels import hungarian, mask_ops

    return {**mask_ops.LAUNCHES, **hungarian.LAUNCHES}


def _card(device: torch.device) -> tuple[str, str | None]:
    """(the device's name, the card's power limit or None)."""
    if device.type != "cuda":
        return "cpu", None
    from video_knet_tpu_torch.utils.device import card_name_and_power

    return torch.cuda.get_device_name(device), card_name_and_power().rsplit(",", 1)[1].strip()


def profile(cfg, hw: tuple[int, int] = HW, batch: int = 1, *, iters: int = 10,
            device=None) -> dict:
    """The report of `main` for `cfg` at `hw` and batch `batch` on `device`
    (CUDA unless named)."""
    from video_knet_tpu_torch.models.video.knet_vps import VideoKNet
    from video_knet_tpu_torch.train.optim import make_optimizer
    from video_knet_tpu_torch.train.train_state import create_train_state
    from video_knet_tpu_torch.train.vps import make_synthetic_batch
    from video_knet_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    model = VideoKNet(cfg, generator=torch.Generator().manual_seed(_cli.INIT_SEED),
                      device=device)
    state = create_train_state(model, make_optimizer(model, steps_per_epoch=1000,
                                                     base_lr=1e-4, weight_decay=5e-2))
    data = make_synthetic_batch(cfg, batch, tuple(hw), device=device)
    parts = make_parts(state, data)
    res: dict = {}
    ms: dict = {}
    # the sub-blocks first: the full steps move the weights
    for part in ("fwd", "backbone", "loss_block", "full"):
        if part == "full":
            start = _launches()
            parts["full"]()
            _sync(device)
            res["launches"] = {k: v - start[k] for k, v in _launches().items()}
        res[f"{part}_flops"], res[f"{part}_bytes"] = count(parts[part])
        ms[part] = _timed(parts[part], device, iters)
        if part == "backbone":
            model.zero_grad(set_to_none=True)
        elif part == "loss_block":
            reached = [n for n, p in model.named_parameters() if p.grad is not None]
            if reached:
                raise AssertionError(f"the loss block reached the model: {reached[:8]}")
    label, peak = PEAKS[bool(cfg.bf16_train)]
    for part in PARTS:
        key = MS_KEYS[part]
        res[key] = statistics.median(ms[part])
        res[f"{key}_spread"] = [min(ms[part]), max(ms[part])]
        res[f"{part}_compute_ms_ideal"] = res[f"{part}_flops"] / peak * 1e3
        res[f"{part}_mem_ms_ideal"] = res[f"{part}_bytes"] / HBM_BYTES_PER_S * 1e3
    res["heads_fwd_bwd_ms_est"] = (res["full_ms"] - res["backbone_fwd_bwd_ms"]
                                   - res["loss_block_fwd_bwd_ms"])
    res["shares"] = {part: res[MS_KEYS[part]] / res["full_ms"] for part in PARTS[1:]}
    res["shares"]["heads_est"] = res["heads_fwd_bwd_ms_est"] / res["full_ms"]
    name, power = _card(device)
    res.update(hw=list(hw), batch=batch, bf16=bool(cfg.bf16_train), iters=iters,
               device=name, power_limit=power, peak=label, hbm="3.35 TB/s (H100 SXM)",
               counting=f"{COUNTING} {BYTES_COUNTING}")
    return res


def parse_args(argv=None):
    p = _cli.parser(__doc__.splitlines()[0])
    p.add_argument("--hw", type=int, nargs=2, default=list(HW))
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--bf16", action="store_true", help="profile the bf16_train step")
    p.add_argument("--iters", type=int, default=10, help="timed calls a part")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from video_knet_tpu_torch.config import VideoKNetConfig

    device = _cli.setup_device(args.device)
    cfg = VideoKNetConfig(max_insts=8, bf16_train=args.bf16)
    print(json.dumps(profile(cfg, tuple(args.hw), args.batch, iters=args.iters,
                             device=device)))


if __name__ == "__main__":
    main()
