"""Mesh checks: R ranks (D data indices at B/D each, n_model ranks on the
`model` axis of each) against one process at B.

`run_ranks(world, specs, tmp)` starts `world` processes of this module
(the environment torchrun gives its workers: RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE), which join one process group through a `file://` store
under `tmp` (no port, so concurrent runs cannot collide), run
`train_steps` on their rows of each spec's global batches and write their
results; it returns, rank by rank, the list of results (one a spec). A
spec {"kind": "gather", "items"} instead runs
`parallel/distributed.py:allgather_results` on rank r's `items[r]`, and
{"kind": "any_rank", "flags"} `any_rank` on rank r's `flags[r]` (the
preemption flag's agreement), {"kind": "replicated"} `mesh.replicated`
on a module filled with rank + 1, and {"kind": "pyramid"} a backbone +
FPN's (or an RFP backbone's) `backbone_and_neck` under the band or the
frame split (`pyramid_share`), {"kind": "rfp_pieces"} the RFP's SAC and
bottleneck on a band (`rfp_pieces`), {"kind": "band_pieces"} the heads'
banded layers and sums (`band_pieces`), {"kind": "resize_pieces"} the banded resizes whose
factor is not whole (`resize_pieces`), and {"kind": "frame_pieces"} the VIS heads' and loss
block's pieces on a rank's frames (`frame_pieces`).
`launch(world, argv, tmp)` starts any module's command line that way (the
train CLIs under a file:// init).
`train_steps(mesh, device, spec)` in one process is the reference;
`run_reference(specs, tmp)` runs it for each spec in a process of its own
(the CPU, no process group), recording the ReLU decisions for the ranks
to replay.

A spec: {"kind": "vps" | "vis" | "image", "cfg", "seed" (the weights'
init), "n_model" (optional: ranks on the mesh's `model` axis, 1 by
default), "neck_layers" (optional: the MSDeformAttn decoder cut to that
many encoder layers, `train_check.shallow_neck`), "spread_offsets"
(optional: its sampling offsets drawn to spread that many pixels from the
spec's seed, `train_check.spread_sampling_offsets`), "weights" (optional:
a state dict loaded over it),
"batches" (global batches of CPU tensors, one a step), "opt" (keyword
arguments of `make_optimizer`), "ddp" (optional, one rank only: "plain"
runs the one-process step in the rank's process, "none" the step over the
mesh without DistributedDataParallel (its collectives only), "find_unused"
DDP walking the autograd graph for unused parameters whatever the model;
by default the step as the port runs it), "timing" (optional: a rank
writes only the losses, milliseconds and launches back), "record_steps"
(optional: `train_steps(..., record=)` records that many first steps'
ReLU decisions), "decisions" (optional: before each step, the hard
decisions of its forward, `step_decisions`), "relus" (optional: for the
first steps, the one-process step's ReLU decisions over the global batch,
recorded by `train_steps(..., record=)`, or the path of a file that
`write_relus` writes them to later, which each rank replays on its rows,
band or frames (`rank_rows`, `model_axis.local_share`) so that a ReLU
input within rounding of zero cannot send the two backwards down
different sides of its kink), "pools" (optional, with "relus": the same
steps' hard mask-pool binarizations, recorded by `train_steps(...,
pools=)`, or the path of a file that `write_relus` writes them to later,
which each rank replays on its rows, band or frames
(`pool_share`) so that a pixel within rounding of the threshold cannot
send the two runs' kernels apart)}. A result: the per-step loss dicts, the
first step's gradients before the clip, the model's final parameters and
buffers (CPU tensors), each step's milliseconds (host clock, the device
synchronized around the step), its kernel launches (the wrappers' counts,
set to 0 before the steps) and the bytes this rank handed to the `model`
axis's collectives (`model_axis.BYTES`), the shapes the backbone took in
the first step, each step's decisions (with "decisions"), every (B, N, H,
W, C) at which this process launched the mask kernels (`mask_ops.SHAPES`),
the peak device memory from the model's creation to the last step, above what was
allocated before (CUDA; 0 on the CPU), the trainable parameters' names
and the model's `leaves_parameters_unused`; with "relus", whether each
replayed step replayed every decision and how many elements its own
decisions would have sent the other way (with "pools", every mask pool's
binarization too, and `pool_differ`, how many pixels its own
binarizations would have sent the other way).

Run as a worker: `python -m video_knet_tpu_torch.tools.dp_check SPEC OUT_DIR`,
or as the reference: `... dp_check --reference SPEC OUT`. `... dp_check --cli
NAME ARGS...` runs the train CLI `video_knet_tpu_torch.tools.NAME` with ARGS
(under torchrun: `torchrun --nproc_per_node=2 -m
video_knet_tpu_torch.tools.dp_check --cli train_vps ...`) and prints this
rank's kernel launches as `LAUNCHES rank=R {...}` at the end.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import os
import pickle
import subprocess
import sys
import time

import torch

from video_knet_tpu_torch.parallel import model_axis
from video_knet_tpu_torch.parallel.mesh import DataMesh, batch_sharding, shard_batch


def _model_and_step(kind: str, cfg, seed: int, device):
    gen = torch.Generator().manual_seed(seed)
    if kind == "vps":
        from video_knet_tpu_torch.models.video.knet_vps import VideoKNet
        from video_knet_tpu_torch.train.vps import train_step

        return VideoKNet(cfg, generator=gen, device=device), train_step
    if kind == "vis":
        from video_knet_tpu_torch.models.vis.knet_vis import KNetVIS
        from video_knet_tpu_torch.train.vis import train_step

        return KNetVIS(cfg, generator=gen, device=device), train_step
    from video_knet_tpu_torch.models.knet import KNet
    from video_knet_tpu_torch.train.image import train_step

    return KNet(cfg, generator=gen, device=device), train_step


SPLITS = {"vps": "rows", "vis": "frames"}  # the step's split over the `model` axis


def step_decisions(kind: str, model, batch) -> list[torch.Tensor]:
    """The hard decisions a train step's forward takes on `batch` (no
    gradient; in training mode, as the step runs, with BatchNorm's running
    statistics put back after it): every hard-threshold mask pool's
    binarization (`train_check.vps_decisions` / `vis_decisions`; under the
    band split gathered into the whole map's rows, under the frame split
    into the whole clips' frames) and every Hungarian assignment (the
    per-frame ones gathered likewise), on the host."""
    import math

    from video_knet_tpu_torch.models.knet import solve_lanes
    from video_knet_tpu_torch.models.vis.knet_vis import gt_frames, knet_vis_costs
    from video_knet_tpu_torch.tools.train_check import vis_decisions, vps_decisions

    buffers = {k: v.clone() for k, v in model.named_buffers()}
    model.train()
    try:
        with torch.no_grad():
            if kind == "vps":
                masks, assigned = vps_decisions(model, batch)
                masks = [_whole_rows(m) for m in masks]
            else:
                cfg, b = model.cfg, batch.clip.shape[0]
                outs = model(batch.clip)
                # [B*T, ...] per-frame pools, [B, T, ...] the tubes' and clip stages'
                masks = [_whole_frames(x > math.log(thr / (1 - thr)), b, not name.startswith(
                    ("clip", "tubes"))) for name, (x, thr) in vis_decisions(outs, cfg).items()]
                assigned = solve_lanes(*knet_vis_costs(outs, gt_frames(batch.gt), cfg))[0]
                per_frame = (0 if cfg.kernel_head_mode == "volume"
                             else 1 + min(cfg.assign_stages, len(outs.frame_stage_outs)))
                assigned = [_whole_frames(a, b, True) if i < per_frame else a
                            for i, a in enumerate(assigned)]
    finally:
        model.eval()
        model.load_state_dict(buffers, strict=False)
    return [t.cpu() for t in (*masks, *assigned)]


def _whole_rows(t: torch.Tensor) -> torch.Tensor:
    """[B, N, h, w] decisions of a band gathered into the whole map's rows
    (`t` itself outside a band)."""
    b, n, h, w = t.shape
    whole = model_axis.whole_map(t.reshape(b * n, h, w, 1).float())
    return whole.reshape(b, n, -1, w) > 0.5


def _whole_frames(t: torch.Tensor, clips: int, folded: bool) -> torch.Tensor:
    """Decisions of this rank's frames of each of `clips` clips, laid out
    [B*T_r, ...] (`folded`) or [B, T_r, ...], gathered into the whole
    clips' frames (`t` itself outside the frame split)."""
    if model_axis.in_frames() is None:
        return t
    x = t.reshape(clips, -1, *t.shape[1:]) if folded else t
    whole = model_axis.gather_frames(x.float() if t.dtype == torch.bool else x)
    whole = whole.reshape(-1, *t.shape[1:]) if folded else whole
    return whole > 0.5 if t.dtype == torch.bool else whole


def rank_rows(decision: torch.Tensor, mesh: DataMesh, batch_size: int, kind: str) -> torch.Tensor:
    """This rank's data index's rows of a tensor of the global batch: VPS's
    backbone, neck and init head see [ref; key], two slices of the global
    batch (`mesh.batch_blocks`); everything else is batch-major. Within the
    backbone, the neck and the heads' per-pixel or per-frame layers,
    `model_axis.local_share` then cuts them to this rank's band or
    frames."""
    n = decision.shape[0]
    blocks = 2 if kind == "vps" and n == 2 * batch_size else 1
    per = n // blocks
    rows = batch_sharding(mesh, per)
    return torch.cat([decision[j * per:(j + 1) * per][rows] for j in range(blocks)])


class _Bare(torch.nn.Module):
    """Stands in for DistributedDataParallel: the wrapped module, called
    as is (one rank: the same step without DDP's bookkeeping)."""

    def __init__(self, module, **_):
        super().__init__()
        self.module = module

    def forward(self, *inputs):
        return self.module(*inputs)

    def register_comm_hook(self, *_):
        pass


@contextlib.contextmanager
def ddp_variant(variant: str, mesh: DataMesh):
    """While active, the train steps build DDP as `variant` says (see the
    module doc)."""
    parallel = torch.nn.parallel
    real = parallel.DistributedDataParallel
    if variant == "none":
        if mesh.world != 1:
            raise ValueError("a step without DDP sums no gradient: one rank only")
        parallel.DistributedDataParallel = _Bare
    elif variant == "find_unused":
        parallel.DistributedDataParallel = lambda *a, **k: real(
            *a, **{**k, "find_unused_parameters": True})
    try:
        yield
    finally:
        parallel.DistributedDataParallel = real


def _to(batch, device):
    if torch.is_tensor(batch):
        return batch.to(device)
    return type(batch)(*(_to(x, device) for x in batch))


def pool_share(decision: torch.Tensor) -> torch.Tensor:
    """A mask pool's binarization [B*T, N, H, W] (or [B, N, H, W]) of the
    data index's batch cut to this rank's frames or band, as the pool runs
    on them; itself outside a split."""
    share = model_axis.in_frames()
    if share is None:
        return model_axis.band_slice(decision, 2)
    t = sum(share.units)
    return decision[model_axis.frame_rows(decision.shape[0] // t, t, share)]


def train_steps(mesh: DataMesh, device, spec: dict, record: list | None = None,
                pools: list | None = None) -> dict:
    """`len(spec["batches"])` train steps of the spec's model on this rank's
    rows of each global batch (see the module doc). With `record`, each
    step's ReLU decisions are appended to it, and with `pools` its mask
    pools' binarizations (the one-process reference, for the ranks to
    replay)."""
    from video_knet_tpu_torch.tools.train_check import pool_pattern, relu_pattern
    from video_knet_tpu_torch.train.optim import make_optimizer
    from video_knet_tpu_torch.train.train_state import create_train_state

    kind = spec["kind"]
    cuda = torch.device(device).type == "cuda"
    if cuda:
        from video_knet_tpu_torch.utils.device import set_fp32_numerics

        set_fp32_numerics()  # before any forward, the decisions' too
        # an earlier run's garbage, freed during this run, would hide its peak
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    model, step = _model_and_step(kind, spec["cfg"], spec["seed"], device)
    if spec.get("neck_layers"):
        from video_knet_tpu_torch.tools.train_check import shallow_neck

        shallow_neck(model, spec["neck_layers"])
    if spec.get("spread_offsets"):
        from video_knet_tpu_torch.tools.train_check import spread_sampling_offsets

        spread_sampling_offsets(model.neck, torch.Generator().manual_seed(spec["seed"]),
                                spec["spread_offsets"])
    if "weights" in spec:
        model.load_state_dict(spec["weights"], strict=True)
    state = create_train_state(model, make_optimizer(model, 1000, **spec.get("opt", {})), mesh)
    first: dict = {}
    optimizer_step = state.optimizer.step

    def keep_first_grads():
        if not first:
            first.update({n: p.grad.detach().cpu().clone()
                          for n, p in model.named_parameters() if p.grad is not None})
        optimizer_step()

    state.optimizer.step = keep_first_grads
    for key in ("relus", "pools"):
        if isinstance(spec.get(key), str):  # a file the caller writes while the model builds
            spec = {**spec, key: _wait_for(spec[key])}
    losses, replayed, differ, ms, launches, comm, inputs, decided = [], [], [], [], [], [], [], []
    pool_differ = []
    in_first = []  # non-empty while the first step runs
    hook = model.backbone.register_forward_pre_hook(
        lambda _, args: inputs.append(tuple(args[0].shape)) if in_first else None)
    reset_counts()
    for i, batch in enumerate(spec["batches"]):
        b = batch[0].shape[0]
        local = _to(shard_batch(mesh, batch), device)
        if spec.get("decisions"):
            from video_knet_tpu_torch.parallel.mesh import data_parallel

            with data_parallel(mesh), model_axis.model_split(mesh, SPLITS[kind]):
                decided.append(step_decisions(kind, model, local))
        relus = spec.get("relus")
        if cuda:
            torch.cuda.synchronize()
        model_axis.reset_bytes()
        in_first[:] = [True] if i == 0 else []
        start, t0 = counts(), time.perf_counter()
        if record is not None and i < spec.get("record_steps", len(spec["batches"])):
            record.append([])
            if pools is not None:
                pools.append([])
            with relu_pattern(record[-1]), (contextlib.nullcontext() if pools is None
                                            else pool_pattern(pools[-1])):
                state, out = step(state, local)
        elif relus is None or i >= len(relus):
            state, out = step(state, local)
        else:
            # mapped as each ReLU runs: inside the backbone, to this rank's share
            pattern = (model_axis.local_share(rank_rows(d, mesh, b, kind)) for d in relus[i])
            binarized = spec.get("pools")
            with relu_pattern(pattern, replay=True) as stats, (
                    contextlib.nullcontext({"calls": 0, "differ": 0}) if binarized is None else
                    pool_pattern((pool_share(rank_rows(d, mesh, b, kind)) for d in binarized[i]),
                                 replay=True)) as pool_stats:
                state, out = step(state, local)
            replayed.append(stats["calls"] == len(relus[i]) and (
                binarized is None or pool_stats["calls"] == len(binarized[i])))
            differ.append(stats["differ"])
            pool_differ.append(pool_stats["differ"])
        if cuda:
            torch.cuda.synchronize()
        in_first.clear()
        ms.append((time.perf_counter() - t0) * 1e3)
        end = counts()
        launches.append({k: end[k] - start[k] for k in end})
        comm.append(dict(model_axis.BYTES))
        losses.append({k: float(v) for k, v in out.items()})
    hook.remove()
    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    from video_knet_tpu_torch.ops.kernels import mask_ops

    return dict(losses=losses, grads=first, state=sd, replayed=replayed, differ=differ,
                pool_differ=pool_differ, ms=ms,
                launches=launches, comm=comm, inputs=inputs, decisions=decided,
                shapes={k: sorted(v) for k, v in mask_ops.SHAPES.items()},
                peak_bytes=torch.cuda.max_memory_allocated() - base if cuda else 0,
                trainable=[n for n, p in model.named_parameters() if p.requires_grad],
                declares_unused=getattr(model, "leaves_parameters_unused", False))


def pyramid_share(mesh: DataMesh, device, spec: dict) -> dict:
    """The backbone `spec["backbone"]` (a `build_backbone` name: ResNet,
    Swin, MiT or an RFP backbone) with the neck `spec["neck"]` (a
    `build_neck` type, the FPN by default; None over an RFP backbone, whose
    output is the pyramid; `spec["weights"]`: their state dicts, the RFP's
    neck's None; eval mode) through
    `backbone_and_neck` under the band split of `mesh`'s
    `model` axis, or with `spec["frames"]` (clips of that many frames in
    `spec["img"]`) the frame split, on this rank's data index's rows of
    `spec["img"]` (one data index), replaying the one-process forward's
    ReLU decisions `spec["relus"]` if given, and backward from this rank's
    share of `spec["cotangents"]` (one a level), all in `spec["img"]`'s
    dtype. Returns this rank's band
    or frames of each level (no gather) and its (first, end) rows (the
    levels' rows of a band; the batch rows b*T + t of the frames), the
    image's gradient (None where the backbone cuts the image from the
    graph: DetectoRS's frozen stem) and the parameters' that reach the
    levels from this rank, the shape the backbone took and the bytes handed
    to the collectives."""
    from video_knet_tpu_torch.models.backbones import (
        backbone_and_neck,
        build_backbone,
        build_neck,
    )
    from video_knet_tpu_torch.parallel.mesh import data_parallel
    from video_knet_tpu_torch.tools.train_check import relu_pattern
    from video_knet_tpu_torch.utils.device import set_fp32_numerics

    set_fp32_numerics()
    dtype = spec["img"].dtype
    backbone = build_backbone(spec["backbone"]).to(device, dtype).eval()
    backbone.load_state_dict(spec["weights"][0])
    neck = build_neck(spec.get("neck", "fpn"), backbone)
    if neck is not None:
        neck = neck.to(device, dtype).eval()
        neck.load_state_dict(spec["weights"][1])
    img = shard_batch(mesh, spec["img"]).to(device).requires_grad_(True)
    inputs = []
    backbone.register_forward_pre_hook(lambda _, args: inputs.append(tuple(args[0].shape)))
    model_axis.reset_bytes()
    relus = spec.get("relus")
    replay = (contextlib.nullcontext() if relus is None else
              relu_pattern((model_axis.local_share(d) for d in relus), replay=True))
    frames = spec.get("frames")
    with data_parallel(mesh), model_axis.model_split(mesh, "rows" if frames is None else
                                                     "frames"), replay:
        levels = backbone_and_neck(backbone, neck, img, frames=frames)
        share = model_axis.in_frames()
        if frames is None:
            cots = [model_axis.band_slice(shard_batch(mesh, c), 1).to(device)
                    for c in spec["cotangents"]]
            rows = [model_axis.band_rows(c.shape[1], c.shape[2], model_axis.in_band())
                    for c in spec["cotangents"]]
        else:
            mine = (torch.arange(img.shape[0]) if share is None else
                    model_axis.frame_rows(img.shape[0] // frames, frames, share))
            cots = [shard_batch(mesh, c)[mine].to(device) for c in spec["cotangents"]]
            rows = [mine.tolist()] * len(cots)
    sum((lv * c).sum() for lv, c in zip(levels, cots)).backward()
    grads = {f"{tag}.{n}": p.grad.detach().cpu() for tag, m in (("backbone", backbone),
                                                                 ("neck", neck))
             if m is not None for n, p in m.named_parameters() if p.grad is not None}
    return dict(levels=[lv.detach().cpu() for lv in levels],
                rows=[r if isinstance(r, list) else (r.start, r.stop) for r in rows],
                grad_img=None if img.grad is None else img.grad.detach().cpu(), grads=grads,
                inputs=inputs, comm=dict(model_axis.BYTES))


def rfp_pieces(mesh: DataMesh, device, spec: dict) -> list[dict]:
    """The RFP's modules (`models/rfp.py`: SAC, the DetectoRS bottleneck)
    on this rank's band of an image of `spec["hw"]` under the band split of
    `mesh`'s `model` axis (one data index). Each of `spec["cases"]`:
    {"module": (a class of `models/rfp.py`, its args, its kwargs),
    "weights": its state dict (eval mode), "inputs": NHWC whole maps of
    strides of the image, "cot": the output's cotangent, "relus": the whole
    maps' ReLU decisions, replayed on the band}; it runs on the band of each
    input, backward from the band of `cot`. Returns, a case, the output's
    band and its (first, end) rows, each input's gradient (its band), the
    parameters' gradients from this rank, whether every ReLU decision was
    replayed, and the bytes handed to the collectives. In one process: the
    whole maps."""
    from video_knet_tpu_torch.models import rfp
    from video_knet_tpu_torch.parallel.mesh import data_parallel
    from video_knet_tpu_torch.tools.train_check import relu_pattern

    out = []
    with data_parallel(mesh), model_axis.model_split(mesh, "rows"):
        split = model_axis.active_split()
        for case in spec["cases"]:
            name, args, kwargs = case["module"]
            module = getattr(rfp, name)(*args, **kwargs).to(device).eval()
            module.load_state_dict(case["weights"])
            model_axis.reset_bytes()
            with (contextlib.nullcontext() if split is None else
                  model_axis.running_share(*model_axis.image_band(split, *spec["hw"]))):
                xs = [_band_of(x, 1, device, grad=True) for x in case["inputs"]]
                relus = case["relus"]
                with relu_pattern((model_axis.local_share(d) for d in relus),
                                  replay=True) as stats:
                    y = module(*xs)
                cot = case["cot"]
                (y * _band_of(cot, 1, device)).sum().backward()
                band = model_axis.in_band()
                rows = (slice(0, cot.shape[1]) if band is None else
                        model_axis.band_rows(cot.shape[1], cot.shape[2], band))
            out.append(dict(out=y.detach().cpu(), rows=(rows.start, rows.stop),
                            grad_inputs=[x.grad.cpu() for x in xs],
                            grads={n: p.grad.cpu() for n, p in module.named_parameters()},
                            replayed=stats["calls"] == len(relus),
                            comm=dict(model_axis.BYTES)))
    return out


def sac_reduces(backbone: torch.nn.Module, images: int) -> tuple[int, int]:
    """The all-reduces a rank hands the `model` group for the SAC global
    contexts of `backbone` (an RFP's or its DetectoRS ResNet) in one train
    step on the bands of `images` images, and their bytes (fp32): two a SAC
    a pass (the pre- and post-context sums, [images, 1, 1, C] each),
    forward and again backward; (0, 0) without SAC."""
    from video_knet_tpu_torch.models.rfp import SAConv

    sacs = [m for m in backbone.modules() if isinstance(m, SAConv)]
    passes = getattr(backbone, "rfp_steps", 1)
    widths = sum(m.pre_context.weight.shape[0] + m.post_context.weight.shape[0] for m in sacs)
    return 2 * 2 * passes * len(sacs), 2 * passes * widths * images * 4


def decoder_gather_bytes(hw: tuple[int, int], n_model: int, images: int, layers: int,
                         width: int = 256, strides=(8, 16, 32)) -> int:
    """The bytes a rank hands to the `model` axis's gathers in one step of
    the MSDeformAttn decoder on the bands of `images` images of `hw` (fp32):
    each encoder layer's forward gathers every rank's value maps padded to
    the largest band's tokens, its backward all-reduces the whole maps'
    gradient."""
    split = model_axis.Split("rows", None, 0, n_model, tuple(model_axis.band_units(hw[0],
                                                                                   n_model)), hw)
    cols = [-(-hw[1] // s) for s in strides]
    bands = [model_axis.map_bands(split, c) for c in cols]
    share = max(sum((b[j][1] - b[j][0]) * c for b, c in zip(bands, cols))
                for j in range(n_model))
    whole = sum(b[-1][1] * c for b, c in zip(bands, cols))
    return (share + whole) * images * width * 4 * layers


def _band_of(t: torch.Tensor, dim: int, device, grad: bool = False) -> torch.Tensor:
    """This rank's band of whole-map tensor `t` along `dim`, on `device`."""
    out = model_axis.band_slice(t, dim).to(device).clone()
    return out.requires_grad_(True) if grad else out


def _piece_results(inp: dict, device) -> dict:
    """The heads' banded layers and sums on this rank's band of `inp`'s
    whole-map tensors (in one process: the whole map), each as (how the
    ranks' results make the whole map's: "rows:D" stacked along dim D,
    "same" equal on every rank, "sum" summed over the ranks; the result).
    A replicated output's cotangent counts 1 / n_model on each rank, as a
    step's loss share does."""
    from video_knet_tpu_torch.models import knet
    from video_knet_tpu_torch.models.kernel_iter_head import upscale_masks
    from video_knet_tpu_torch.models.layers import (
        GroupNorm,
        band_positional_encoding,
        resize_bilinear,
        upsample2x,
    )
    from video_knet_tpu_torch.ops import hungarian as hung
    from video_knet_tpu_torch.ops import losses as L
    from video_knet_tpu_torch.ops.mask_pool import mask_pool

    band = model_axis.in_band()
    share = 1.0 / (1 if band is None else band.count)
    out = {}

    def banded(name, fn, x, cot, dim, rows_dim=1):
        xb = _band_of(x, rows_dim, device, grad=True)
        y = fn(xb)
        (y * _band_of(cot, dim, device)).sum().backward()
        out[name] = (f"rows:{dim}", y.detach().cpu())
        out[f"{name}.grad"] = (f"rows:{rows_dim}", xb.grad.cpu())

    gn = GroupNorm(inp["gn_x"].shape[-1]).to(device)
    with torch.no_grad():
        gn.weight.copy_(inp["gn_weight"])
        gn.bias.copy_(inp["gn_bias"])
    banded("group_norm", gn, inp["gn_x"], inp["gn_cot"], 1)
    out["group_norm.weight_grad"] = ("sum", gn.weight.grad.cpu())
    out["group_norm.bias_grad"] = ("sum", gn.bias.grad.cpu())
    banded("upsample2x", upsample2x, inp["up_x"], inp["up_cot"], 1)
    banded("resize_bilinear", lambda x: resize_bilinear(x, (4 * x.shape[1], 4 * x.shape[2])),
           inp["seg_x"], inp["seg_cot"], 1)
    banded("upscale_masks", lambda m: upscale_masks(m, 4), inp["masks"], inp["masks_cot"], 2,
           rows_dim=2)
    h, w, c = inp["pe_hwc"]
    rows = slice(0, h) if band is None else model_axis.band_rows(h, w, band)
    out["positional_encoding"] = ("rows:0", band_positional_encoding(
        rows.stop - rows.start, w, c // 2, device=device).cpu())
    # K1's partial sums over the band, summed over the `model` group
    feats = _band_of(inp["pool_feats"], 1, device, grad=True)
    pooled = mask_pool(_band_of(inp["pool_logits"], 2, device), feats)
    (pooled * inp["pool_cot"].to(device) * share).sum().backward()
    out["mask_pool"] = ("same", pooled.detach().cpu())
    out["mask_pool.grad"] = ("rows:1", feats.grad.cpu())
    # the dice loss (its gradient too) and the Hungarian mask costs
    pred = _band_of(inp["pred"], 1, device, grad=True)
    tgt, wts = _band_of(inp["tgt"], 1, device), inp["w"].to(device)
    dice = L.dice_loss(pred, tgt, wts, loss_weight=4.0, avg_factor=wts.sum())
    (dice * share).backward()
    out["dice_loss"] = ("same", dice.detach().cpu())
    out["dice_loss.grad"] = ("rows:1", pred.grad.cpu())
    logits, gt = _band_of(inp["cost_logits"], 2, device), _band_of(inp["cost_gt"], 2, device)
    out["dice_cost"] = ("same", hung.dice_cost(logits, gt).cpu())
    out["mask_cost"] = ("same", hung.mask_cost(logits, gt).cpu())
    # every pixel-count normalizer of the loss block
    pred = pred.detach()
    seg, labels = _band_of(inp["seg_logits"], 1, device), _band_of(inp["seg_labels"], 1, device)
    rank_t = _band_of(inp["rank_target"], 1, device)
    c = seg.shape[-1]
    out.update({k: ("same", v.detach().cpu()) for k, v in {
        "bce_default": L.binary_cross_entropy(pred, tgt, wts),
        "softmax_ce_default": L.softmax_cross_entropy(seg, labels, ignore_index=c),
        "focal_over_pixels": L.sigmoid_focal_loss(seg.reshape(-1, c), labels.reshape(-1),
                                                  num_classes=c, over_pixels=True),
        "rank_loss": knet._rank_loss_batched(_band_of(inp["rank_logits"], 2, device), rank_t,
                                             0.1),
        "pixels": knet._pixels((labels != c).float().sum()),
        **knet.mask_losses(pred, tgt, wts, 1.0, 4.0, ("mask_bce", "mask_dice")),
    }.items()})
    return out


def band_pieces(mesh: DataMesh, device, spec: dict) -> dict:
    """`_piece_results` on this rank's band of an image of `spec["height"]`
    rows (and `spec["width"]` columns; by default four times the first
    level's) under the band split of `mesh`'s `model` axis (one data index;
    the band held as after the backbone), and the Semantic-FPN and the
    kernel head (`spec["head"]`: its config and state dict, eval mode) on
    the band of `spec["levels"]`, the pyramid. In one process: the whole
    map."""
    from video_knet_tpu_torch.models.kernel_head import ConvKernelHead
    from video_knet_tpu_torch.parallel.mesh import data_parallel

    model_axis.reset_bytes()
    with data_parallel(mesh), model_axis.model_split(mesh, "rows"):
        split = model_axis.active_split()
        if split is not None:
            model_axis.hold_share(*model_axis.image_band(
                split, spec["height"], spec.get("width", 4 * spec["levels"][0].shape[2])))
        out = _piece_results(spec["inputs"], device)
        cfg, weights = spec["head"]
        head = ConvKernelHead(cfg, in_channels=spec["levels"][0].shape[-1]).to(device).eval()
        head.load_state_dict(weights)
        levels = [_band_of(x, 1, device) for x in spec["levels"]]
        with torch.no_grad():
            fpn = head.localization_fpn(levels)
            rpn = head(levels)
    out.update({f"fpn.{i}": ("rows:1", x.cpu()) for i, x in enumerate(fpn)})
    for name, dim in (("proposal_feats", None), ("x_feats", 1), ("mask_preds", 2),
                      ("seg_preds", 1), ("thing_mask_preds", 2)):
        out[f"head.{name}"] = ("same" if dim is None else f"rows:{dim}",
                               getattr(rpn, name).cpu())
    out["comm"] = dict(model_axis.BYTES)
    return out


def resize_pieces(mesh: DataMesh, device, spec: dict) -> dict:
    """The resizes of the band split whose factor is not whole, on this
    rank's band of an image of `spec["hw"]` under the band split of `mesh`'s
    `model` axis (one data index, the band held as after the backbone), to
    the stride-8 level, each as `band_pieces` gives its pieces ("rows:1",
    its output band and its input's gradient, from the cotangent
    `spec["cot"]`): "nearest", the FPN's top-down resize of the stride-16
    level `spec["x16"]`; "shrink", the Semantic-FPN's antialiased resize of
    `spec["up"]`, the stride-16 level upsampled twice (its rows
    `model_axis.scaled_bands`); "upsample", the Semantic-FPN's chain on the
    stride-32 level `spec["x32"]`: upsampled twice over, then resized. In
    one process: the whole map."""
    from video_knet_tpu_torch.models.layers import resize_bilinear, resize_nearest, upsample2x
    from video_knet_tpu_torch.parallel.mesh import data_parallel

    h8, w8 = spec["cot"].shape[1:3]
    out = {}
    model_axis.reset_bytes()
    with data_parallel(mesh), model_axis.model_split(mesh, "rows"):
        split = model_axis.active_split()
        if split is not None:
            model_axis.hold_share(*model_axis.image_band(split, *spec["hw"]))
        band = model_axis.in_band()
        rows8 = h8 if band is None else len(range(h8)[model_axis.band_rows(h8, w8, band)])
        src16 = None if band is None else model_axis.map_bands(band, spec["x16"].shape[2])

        def banded(name, fn, x):
            xb = _band_of(x, 1, device, grad=True)
            y = fn(xb)
            (y * _band_of(spec["cot"], 1, device)).sum().backward()
            out[name] = ("rows:1", y.detach().cpu())
            out[f"{name}.grad"] = ("rows:1", xb.grad.cpu())

        def chain(x):
            bands = model_axis.map_rows(x)
            y = upsample2x(x)
            bands = model_axis.scaled_bands(bands, 2)
            y = upsample2x(y, bands)
            return resize_bilinear(y, (rows8, w8), model_axis.scaled_bands(bands, 2))

        banded("nearest", lambda x: resize_nearest(x, (rows8, w8), dims=(1, 2)), spec["x16"])
        banded("shrink", lambda x: resize_bilinear(x, (rows8, w8),
                                                   model_axis.scaled_bands(src16, 2)), spec["up"])
        banded("upsample", chain, spec["x32"])
    out["comm"] = dict(model_axis.BYTES)
    return out


def _frames_of(t: torch.Tensor, dim: int, device, grad: bool = False) -> torch.Tensor:
    """This rank's frames of whole-clip tensor `t` along `dim` (the frames
    axis; `dim` 0 for rows b*T + t of B clips, laid out [B, T, ...] first
    by `frame_pieces`), on `device`."""
    out = model_axis.frame_slice(t, dim).to(device).clone()
    return out.requires_grad_(True) if grad else out


def _fold(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, *t.shape[2:])


def _frame_piece_results(inp: dict, heads: dict, device) -> dict:
    """The VIS heads' and loss block's pieces on this rank's frames of
    `inp`'s whole-clip tensors ([B, T, ...]; in one process: the whole
    clips), each as (how the ranks' results make the whole clips':
    "frames:D" this rank's frames along dim D, "rows" its rows b*T_r + t of
    [B*T_r, ...], "same" equal on every rank; the result). A replicated
    output's cotangent counts 1 / n_model on each rank, as a step's loss
    share does. `heads`: the clip head's and the per-frame heads'
    (config, state dict) pairs."""
    from video_knet_tpu_torch.models import knet
    from video_knet_tpu_torch.models.kernel_head import ConvKernelHead, RPNOutputs
    from video_knet_tpu_torch.models.kernel_iter_head import (
        KernelIterHead,
        StageOutput,
        upscale_masks,
    )
    from video_knet_tpu_torch.models.layers import sine_positional_encoding_3d
    from video_knet_tpu_torch.models.vis import knet_vis as kv
    from video_knet_tpu_torch.models.vis.clip_head import ClipKernelHead
    from video_knet_tpu_torch.models.vis.volume_head import VolumeRPNOutputs

    share = model_axis.in_frames()
    part = 1.0 / (1 if share is None else share.count)
    cfg = heads["cfg"]
    b, t = inp["kernels"].shape[:2]
    out = {}

    def backward(name, value, leaves, cot=None):
        loss = value * part if cot is None else (value * cot.to(device) * part).sum()
        loss.backward()
        for key, (dim, leaf) in leaves.items():
            out[f"{name}.grad.{key}"] = (dim, leaf.grad.cpu())

    # the temporal positional encoding: the whole clip's rows of these frames
    tt, h, w, c = inp["pe_thwc"]
    out["positional_encoding"] = ("frames:0", model_axis.frame_slice(
        sine_positional_encoding_3d(tt, h, w, c // 2, device=device), 0).cpu())
    # the clip kernels' merge (the attention merge: every frame's kernels)
    clip_head = ClipKernelHead(cfg.head, num_stages=cfg.tracker_num_stages,
                               assign_stages=cfg.tracker_assign_stages,
                               num_proposals=cfg.num_proposals,
                               query_merge_method=cfg.query_merge_method).to(device)
    clip_head.load_state_dict(heads["clip"])
    kern = _frames_of(inp["kernels"], 1, device, grad=True)
    merged = clip_head._merge(kern)
    out["merge"] = ("same", merged.detach().cpu())
    backward("merge", merged, {"kernels": ("frames:1", kern)}, inp["merge_cot"])
    # the clip stages' mean over the clip's frames
    feats = _frames_of(inp["pooled"], 1, device, grad=True)
    mean = model_axis.frame_mean(feats, 1)
    out["clip_mean"] = ("same", mean.detach().cpu())
    backward("clip_mean", mean, {"pooled": ("frames:1", feats)}, inp["merge_cot"])
    # the tube costs and the tube losses over T*H*W
    gt = kv.gt_frames(kv.ClipGT(*(x.to(device) for x in inp["gt"])))
    scaled = _frames_of(inp["scaled"], 1, device, grad=True)
    cls = inp["cls"].to(device).requires_grad_(True)
    with torch.no_grad():
        out["tube_cost"] = ("same", kv.tube_cost(scaled, cls, gt, cfg).cpu())
    stage = kv.ClipStageOutput(cls, scaled, scaled, None)
    tube = kv.tube_stage_loss(stage, inp["tube_assign"].to(device), gt, cfg, "tube")
    out.update({k: ("same", v.detach().cpu()) for k, v in tube.items()})
    backward("tube", sum(tube.values()), {"scaled": ("frames:1", scaled), "cls": ("sum", cls)})
    # the volume init head's losses: its tube masks and its per-frame seg
    tubes = _frames_of(inp["tubes"], 1, device, grad=True)
    seg = _frames_of(inp["seg"], 1, device, grad=True)
    vol = VolumeRPNOutputs(None, None, tubes, seg)
    vcfg = heads["volume_cfg"]
    volume = kv.volume_rpn_loss(vol, gt, vcfg, inp["tube_assign"].to(device))
    out.update({f"volume.{k}": ("same", v.detach().cpu()) for k, v in volume.items()})
    backward("volume", sum(volume.values()), {"tubes": ("frames:1", tubes),
                                              "seg": ("frames:1", seg)})
    # the per-frame losses: this rank's shares, summed over the group
    fgt = kv.frame_gt_from_clip(gt)
    frame_masks = _frames_of(inp["frame_masks"], 1, device, grad=True)
    frame_cls = _frames_of(inp["frame_cls"], 1, device, grad=True)
    frame_seg = _frames_of(inp["frame_seg"], 1, device, grad=True)
    masks, fcls, fseg = _fold(frame_masks), _fold(frame_cls), _fold(frame_seg)
    assign = _fold(_frames_of(inp["frame_assign"], 1, device))
    rpn = RPNOutputs(None, None, masks, fseg, masks, None)
    scaled_masks = upscale_masks(masks, cfg.head.mask_upsample_stride)
    shares = knet.rpn_loss(rpn, fgt, cfg, gt_of_pred=assign)
    shares.update(knet.stage_loss(StageOutput(fcls, masks, scaled_masks, None), assign, fgt,
                                  cfg, "s0"))
    frame = dict(zip(shares, model_axis.frame_sum(*shares.values())))
    out.update({f"frame.{k}": ("same", v.detach().cpu()) for k, v in frame.items()})
    backward("frame", sum(frame.values()), {"masks": ("frames:1", frame_masks),
                                            "cls": ("frames:1", frame_cls),
                                            "seg": ("frames:1", frame_seg)})
    out["pixels"] = ("same", knet._pixels(fgt.masks.sum()).cpu())
    # the heads on these frames: the kernel head (the temporal encoding),
    # the stage loop and the clip head, as the VIS forward runs them
    levels = [_fold(_frames_of(x, 1, device)) for x in inp["levels"]]
    kernel_head = ConvKernelHead(cfg.rpn, in_channels=levels[0].shape[-1]).to(device)
    kernel_head.load_state_dict(heads["rpn"])
    iter_head = KernelIterHead(cfg.head, num_stages=cfg.num_stages).to(device)
    iter_head.load_state_dict(heads["roi"])
    with torch.no_grad():
        rpn_out = kernel_head(levels, num_frames=t)
        with model_axis.held_share():
            stages = iter_head(rpn_out.x_feats, rpn_out.proposal_feats, rpn_out.mask_preds)
        n = cfg.num_proposals
        tr = model_axis.local_frames(t)
        x_clip = rpn_out.x_feats.reshape(b, tr, *rpn_out.x_feats.shape[1:])
        clip_outs = clip_head(x_clip, stages[-1].object_feats[:, :n, 0].reshape(b, tr, n, -1),
                              stages[-1].mask_preds[:, :n].reshape(b, tr, n, *x_clip.shape[2:4]))
    for k in ("x_feats", "mask_preds", "seg_preds", "proposal_feats"):
        out[f"rpn.{k}"] = ("rows", getattr(rpn_out, k).cpu())
    for s, st in enumerate(stages):
        for k in ("cls_score", "mask_preds", "object_feats"):
            out[f"roi.s{s}.{k}"] = ("rows", getattr(st, k).cpu())
    for s, st in enumerate(clip_outs):
        if st.cls_score is not None:
            out[f"clip.s{s}.cls_score"] = ("same", st.cls_score.cpu())
        out[f"clip.s{s}.mask_preds"] = ("frames:1", st.mask_preds.cpu())
        out[f"clip.s{s}.object_feats"] = (
            "frames:1" if st.object_feats.dim() == 4 else "same", st.object_feats.cpu())
    return out


def frame_pieces(mesh: DataMesh, device, spec: dict) -> dict:
    """`_frame_piece_results` on this rank's frames of `spec["inputs"]`'
    clips under the frame split of `mesh`'s `model` axis (one data index;
    the frames held as after the backbone). In one process: the whole
    clips."""
    from video_knet_tpu_torch.parallel.mesh import data_parallel

    model_axis.reset_bytes()
    inp = spec["inputs"]
    b, t = inp["kernels"].shape[:2]
    with data_parallel(mesh), model_axis.model_split(mesh, "frames"):
        split = model_axis.active_split()
        if split is not None:
            rows = model_axis.frame_rows(b, t, split)
            model_axis.hold_share(model_axis.frame_share(split, t), lambda x: x[rows])
        out = _frame_piece_results(inp, spec["heads"], device)
    out["comm"] = dict(model_axis.BYTES)
    return out


def reset_counts() -> None:
    from video_knet_tpu_torch.ops.kernels import hungarian, mask_ops

    mask_ops.reset_launch_counts()
    hungarian.reset_launch_counts()


def counts() -> dict:
    """The kernel wrappers' launch counts of this process."""
    from video_knet_tpu_torch.ops.kernels import hungarian, mask_ops

    return {**mask_ops.LAUNCHES, **hungarian.LAUNCHES}


ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _rank_env(rank: int, world: int, threads: int = 1) -> dict:
    """torchrun's worker environment for one host, the repo on the path,
    `threads` intra-op threads a rank."""
    path = os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)
    return dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                LOCAL_WORLD_SIZE=str(world), PYTHONPATH=path, OMP_NUM_THREADS=str(threads))


def launch(world: int, argv: list[str], tmp: str, timeout: float = 600.0,
           threads: int = 1, nice: int = 0, while_running=None) -> list[str]:
    """`python -m <argv>` in `world` processes with torchrun's rank
    environment, at `nice`; `while_running()`, if given, runs once they
    have started. Returns each rank's output (standard output and errors).
    Raises if any rank fails."""
    procs = [subprocess.Popen([sys.executable, "-m", *argv], env=_rank_env(r, world, threads),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              preexec_fn=(lambda: os.nice(nice)) if nice else None)
             for r in range(world)]
    outs = []
    try:
        if while_running is not None:
            while_running()
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {world} exited {p.returncode}:\n{out[-4000:]}")
    return outs


def run_ranks(world: int, specs: list[dict], tmp: str, timeout: float = 600.0,
              device: str = "cpu", backend: str | None = None, threads: int = 1,
              nice: int = 0, while_running=None) -> list[list]:
    """Each spec over `world` ranks joined through a file:// store in `tmp`
    (see the module doc), `threads` intra-op threads a rank, at `nice`;
    `while_running()`, if given, runs once they have started (it may write
    the files a spec's "relus" name). Rank by rank, the list of the specs'
    results."""
    os.makedirs(tmp, exist_ok=True)
    spec_path, store = os.path.join(tmp, "dp_spec.pkl"), os.path.join(tmp, "dp_store")
    if os.path.exists(store):  # a file store is good for one group only
        os.remove(store)
    with open(spec_path, "wb") as f:
        pickle.dump(dict(specs=specs, device=device, backend=backend,
                         init="file://" + os.path.abspath(store)), f)
    try:
        launch(world, ["video_knet_tpu_torch.tools.dp_check", spec_path, tmp], tmp, timeout,
               threads, nice, while_running)
    finally:
        os.remove(spec_path)
    out = []
    for r in range(world):
        path = os.path.join(tmp, f"dp_rank_{r}.pkl")
        with open(path, "rb") as f:
            out.append(pickle.load(f))
        os.remove(path)
    return out


def write_relus(path: str, relus: list) -> None:
    """ReLU decisions for a spec's "relus" path (or mask-pool binarizations
    for its "pools" path), written whole at once."""
    with open(path + ".tmp", "wb") as f:
        pickle.dump(relus, f)
    os.replace(path + ".tmp", path)


def _wait_for(path: str, timeout: float = 600.0):
    """The pickle at `path`, once it exists."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.05)
    with open(path, "rb") as f:
        return pickle.load(f)


def run_reference(specs: list[dict], tmp: str, timeout: float = 600.0,
                  threads: int = 1, nice: int = 0) -> list[tuple]:
    """`train_steps` of each spec in one process of its own on the CPU, at
    `nice`: a list of (its result, the ReLU decisions it recorded, or
    replayed where the spec gives them)."""
    os.makedirs(tmp, exist_ok=True)
    spec_path, out = os.path.join(tmp, "ref_spec.pkl"), os.path.join(tmp, "ref_out.pkl")
    with open(spec_path, "wb") as f:
        pickle.dump(specs, f)
    env = {**_rank_env(0, 1, threads), "WORLD_SIZE": ""}
    proc = subprocess.run([sys.executable, "-m", "video_knet_tpu_torch.tools.dp_check",
                           "--reference", spec_path, out], env=env, capture_output=True,
                          text=True, timeout=timeout,
                          preexec_fn=(lambda: os.nice(nice)) if nice else None)
    os.remove(spec_path)
    if proc.returncode != 0:
        raise RuntimeError(f"reference run exited {proc.returncode}:\n{proc.stdout[-2000:]}"
                           f"{proc.stderr[-4000:]}")
    with open(out, "rb") as f:
        result = pickle.load(f)
    os.remove(out)
    return result


def _reference(spec_path: str, out: str) -> None:
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "1")))
    with open(spec_path, "rb") as f:
        specs = pickle.load(f)
    results = []
    for spec in specs:
        if "relus" in spec:  # replaying given decisions
            results.append((train_steps(DataMesh(), "cpu", spec), spec["relus"]))
            continue
        relus: list = []
        results.append((train_steps(DataMesh(), "cpu", spec, record=relus), relus))
    with open(out, "wb") as f:
        pickle.dump(results, f)


def _worker(spec_path: str, out_dir: str) -> None:
    from video_knet_tpu_torch.parallel import distributed

    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "1")))
    with open(spec_path, "rb") as f:
        job = pickle.load(f)
    device = distributed.initialize(job["device"], backend=job["backend"],
                                    init_method=job["init"])
    mesh = distributed.global_mesh()
    try:
        results = []
        for spec in job["specs"]:
            if spec["kind"] == "gather":
                results.append(distributed.allgather_results(
                    spec["items"][mesh.rank], os.path.join(out_dir, "gather")))
            elif spec["kind"] == "any_rank":
                results.append(distributed.any_rank(spec["flags"][mesh.rank]))
            elif spec["kind"] == "pyramid":
                results.append(pyramid_share(distributed.global_mesh(spec["n_model"]), device,
                                             spec))
            elif spec["kind"] == "rfp_pieces":
                results.append(rfp_pieces(distributed.global_mesh(spec["n_model"]), device,
                                          spec))
            elif spec["kind"] == "band_pieces":
                results.append(band_pieces(distributed.global_mesh(spec["n_model"]), device,
                                           spec))
            elif spec["kind"] == "resize_pieces":
                results.append(resize_pieces(distributed.global_mesh(spec["n_model"]), device,
                                             spec))
            elif spec["kind"] == "frame_pieces":
                results.append(frame_pieces(distributed.global_mesh(spec["n_model"]), device,
                                            spec))
            elif spec["kind"] == "replicated":
                from video_knet_tpu_torch.parallel.mesh import replicated

                module = torch.nn.BatchNorm1d(3)
                with torch.no_grad():
                    for t in [*module.parameters(), *module.buffers()]:
                        t.fill_(mesh.rank + 1)
                results.append(replicated(mesh, module).state_dict())
            else:
                variant = spec.get("ddp", "ddp")
                on = (DataMesh() if variant == "plain"
                      else distributed.global_mesh(spec.get("n_model", 1)))
                with ddp_variant(variant, on):
                    res = train_steps(on, device, spec)
                if spec.get("timing"):
                    res = {k: res[k] for k in ("losses", "ms", "launches")}
                results.append(res)
        with open(os.path.join(out_dir, f"dp_rank_{mesh.rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        distributed.shutdown()


def _cli(name: str, argv: list[str]) -> None:
    from video_knet_tpu_torch.parallel import distributed

    reset_counts()
    try:
        importlib.import_module(f"video_knet_tpu_torch.tools.{name}").main(argv)
        # one write: torchrun merges the ranks' standard outputs
        rank = os.environ.get("RANK", "0")
        sys.stdout.write(f"LAUNCHES rank={rank} {json.dumps(counts())}\n")
        sys.stdout.flush()
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    if sys.argv[1] == "--reference":
        _reference(*sys.argv[2:4])
    elif sys.argv[1] == "--cli":
        _cli(sys.argv[2], sys.argv[3:])
    else:
        _worker(*sys.argv[1:3])
