"""The mesh's `model` axis: the frame split (VIS clip parallelism) and the
band split (VPS spatial sharding over the image rows) of the backbone and
the neck.

Counterpart of the `model` axis of JAX's sharded steps:
`video_knet_tpu/train/vis.py:make_sharded_vis_train_step` shards the clip's
frame axis over `model`, and `train/vps.py:make_sharded_train_step` the
image height (its `constrain`); XLA then splits the work and adds the halo
exchanges and the gathers. The port does it by hand. The train steps open
`model_split(mesh, kind)`, and `models/backbones.py:backbone_and_neck` runs
the backbone and the neck on this rank's share of its data index's rows:
- "frames": contiguous frames of each clip (T=5 over 2 ranks: 3 + 2), for
  every backbone and neck (frames are independent);
- "rows": a band of H / n_model image rows, for ResNet + FPN. Bands are
  whole multiples of the backbone's total stride (`STRIDE`), so every
  level's band starts on a whole row and the FPN's nearest 2x top-down
  resize is local. Inside the band (`in_band`), each convolution and the
  stem's max-pool take the rows their window reaches past the band from the
  neighbouring ranks (`halo`); zero (-inf for the pool) padding applies only
  at the image's global top and bottom.
`gather_shares` then all-gathers the pyramid over the `model` group, back
into the data index's order; its backward sums each share's gradient over
the group and keeps this rank's. Everything after the neck (the kernel
heads, the assignment, the losses) runs replicated on the `model` ranks of
one data index, so each rank's loss is its data index's share over n_model
(`train/train_state.py`): the gradient summed over the world then counts
the replicated heads once and sums the backbone and the neck over the
shares.

The collectives are all_gather and all_reduce, which gloo runs on CUDA
tensors too (ranks sharing a card). `BYTES` counts what this rank hands to
them, forward and backward.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.nn.functional as F

from video_knet_tpu_torch.parallel.mesh import DataMesh

STRIDE = 32  # ResNet + FPN's total stride: a band is a whole multiple of it
KINDS = ("rows", "frames")

BYTES = {"halo": 0, "gather": 0}


def reset_bytes() -> None:
    for k in BYTES:
        BYTES[k] = 0


@dataclass(frozen=True)
class Split:
    """The step's split over the `model` axis: `kind` ("rows" or
    "frames"), the `model` group, this rank's index on it and the count."""

    kind: str
    group: Any
    index: int
    count: int


_SPLIT: contextvars.ContextVar[Split | None] = contextvars.ContextVar(
    "vknet_model_split", default=None)
_BAND: contextvars.ContextVar[Split | None] = contextvars.ContextVar("vknet_band", default=None)
_SHARE: contextvars.ContextVar[Callable | None] = contextvars.ContextVar(
    "vknet_share", default=None)


@contextlib.contextmanager
def model_split(mesh: DataMesh | None, kind: str | None):
    """While active, `backbone_and_neck` splits its batch over `mesh`'s
    `model` axis as `kind` says (nothing for no kind, with one rank on the
    axis or without a process group)."""
    if kind not in (None, *KINDS):
        raise ValueError(f"split kind {kind!r}, not one of {KINDS}")
    split = None
    if kind is not None and mesh is not None and mesh.distributed and mesh.n_model > 1:
        split = Split(kind, mesh.model_group, mesh.model_index, mesh.n_model)
    token = _SPLIT.set(split)
    try:
        yield
    finally:
        _SPLIT.reset(token)


def active_split() -> Split | None:
    return _SPLIT.get()


def in_band() -> Split | None:
    """The band split while the backbone and the neck run on a band, else
    None: the layers that reach across rows exchange halos then."""
    return _BAND.get()


def local_share(t: torch.Tensor) -> torch.Tensor:
    """`t`, laid out as the backbone's batch of this rank's data index, cut
    to this rank's share while the backbone and the neck run on a share;
    `t` itself elsewhere (a ReLU decision replayed on a rank,
    `tools/dp_check.py`)."""
    select = _SHARE.get()
    return t if select is None else select(t)


@contextlib.contextmanager
def running_share(split: Split, select: Callable):
    """The backbone and the neck run on `select(...)` of the batch."""
    tokens = (_BAND.set(split if split.kind == "rows" else None), _SHARE.set(select))
    try:
        yield
    finally:
        _BAND.reset(tokens[0])
        _SHARE.reset(tokens[1])


def band_rows(h: int, split: Split, stride: int = STRIDE) -> slice:
    """This rank's band of `h` rows (of the image, or with `stride=1` of a
    level inside the backbone). Raises when `h` does not split into
    `split.count` bands of whole multiples of `stride` rows."""
    if h % (stride * split.count):
        raise ValueError(f"{h} image rows do not split into {split.count} bands of whole "
                         f"multiples of {stride} rows (the backbone's total stride)")
    per = h // split.count
    return slice(split.index * per, (split.index + 1) * per)


def frame_counts(t: int, count: int) -> list[int]:
    """Frames a rank of a clip of `t` over `count` ranks: contiguous, the
    first ranks one more where `t` does not divide (5 over 2: 3 + 2)."""
    if t < count:
        raise ValueError(f"a clip of {t} frames does not split over {count} model ranks")
    return [t // count + (i < t % count) for i in range(count)]


def frame_rows(clips: int, t: int, split: Split) -> torch.Tensor:
    """The rows (b*t + frame) of this rank's frames of each of `clips`
    clips of `t` frames."""
    counts = frame_counts(t, split.count)
    t0 = sum(counts[:split.index])
    frames = torch.arange(t0, t0 + counts[split.index])
    return (torch.arange(clips)[:, None] * t + frames[None]).reshape(-1)


# ------------------------------------------------------------ collectives


def _all_gather(x: torch.Tensor, split: Split, what: str) -> list[torch.Tensor]:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(split.count)]
    torch.distributed.all_gather(parts, x, group=split.group)
    BYTES[what] += x.numel() * x.element_size()
    return parts


def halo(x: torch.Tensor, top: int, bottom: int, fill: float, split: Split) -> torch.Tensor:
    """NHWC band `x` with `top` rows above it and `bottom` below it: the
    neighbouring bands' edge rows, or `fill` past the image's global top
    and bottom. The backward adds each halo row's gradient to the rank
    that owns the row."""
    if top == 0 and bottom == 0:
        return x
    if x.shape[1] < max(top, bottom):
        raise ValueError(f"a band of {x.shape[1]} rows cannot lend a halo of {max(top, bottom)}")
    return _Halo.apply(x, top, bottom, fill, split)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, top, bottom, fill, split):
        ctx.top, ctx.bottom, ctx.split = top, bottom, split
        rows = x.shape[1]
        # this rank's first `bottom` rows (the band above takes them) and its
        # last `top` rows (the band below takes them)
        parts = _all_gather(torch.cat([x[:, :bottom], x[:, rows - top:]], dim=1), split, "halo")
        i, n = split.index, split.count
        b, _, w, c = x.shape
        above = parts[i - 1][:, bottom:] if i > 0 else x.new_full((b, top, w, c), fill)
        below = parts[i + 1][:, :bottom] if i < n - 1 else x.new_full((b, bottom, w, c), fill)
        return torch.cat([above, x, below], dim=1)

    @staticmethod
    def backward(ctx, g):
        top, bottom, split = ctx.top, ctx.bottom, ctx.split
        rows = g.shape[1] - top - bottom
        parts = _all_gather(torch.cat([g[:, :top], g[:, top + rows:]], dim=1), split, "halo")
        gx = g[:, top:top + rows].clone()
        i, n = split.index, split.count
        if i < n - 1 and top:  # the band below's top halo is this band's last rows
            gx[:, rows - top:] += parts[i + 1][:, :top]
        if i > 0 and bottom:  # the band above's bottom halo is this band's first rows
            gx[:, :bottom] += parts[i - 1][:, top:]
        return gx, None, None, None, None


def gather_shares(shares: list[torch.Tensor], split: Split, clips: int | None = None,
                  frames: int | None = None) -> list[torch.Tensor]:
    """Each level of this rank's pyramid share gathered over the `model`
    group into the data index's order: bands stacked along the rows, or
    (`clips`, `frames`) each clip's frames back in b*T + t order."""
    counts = None if frames is None else tuple(frame_counts(frames, split.count))
    return list(_Gather.apply(split, clips, counts, *shares))


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, split, clips, counts, *shares):
        ctx.split, ctx.clips, ctx.counts = split, clips, counts
        flat = torch.cat([s.reshape(-1) for s in shares])
        if counts is None:  # bands: equal shares
            parts = _all_gather(flat, split, "gather")
            out, off = [], 0
            for s in shares:
                out.append(torch.cat([p[off:off + s.numel()].view(s.shape) for p in parts], 1))
                off += s.numel()
            ctx.full = [o.shape for o in out]
            return tuple(out)
        per_frame = [math.prod(s.shape[1:]) for s in shares]
        longest = clips * max(counts) * sum(per_frame)
        parts = _all_gather(F.pad(flat, (0, longest - flat.numel())), split, "gather")
        out = []
        for level, s in enumerate(shares):
            pieces = []
            for p, c in zip(parts, counts):
                off = clips * c * sum(per_frame[:level])
                pieces.append(p[off:off + clips * c * per_frame[level]].view(
                    clips, c, *s.shape[1:]))
            out.append(torch.cat(pieces, 1).reshape(clips * sum(counts), *s.shape[1:]))
        ctx.full = [o.shape for o in out]
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        split, clips, counts = ctx.split, ctx.clips, ctx.counts
        flat = torch.cat([g.reshape(-1) for g in grads])
        torch.distributed.all_reduce(flat, group=split.group)
        BYTES["gather"] += flat.numel() * flat.element_size()
        out, off = [], 0
        for shape in ctx.full:
            g = flat[off:off + math.prod(shape)].view(shape)
            off += math.prod(shape)
            if counts is None:
                per = shape[1] // split.count
                out.append(g[:, split.index * per:(split.index + 1) * per])
            else:
                t0 = sum(counts[:split.index])
                mine = g.view(clips, sum(counts), *shape[1:])[:, t0:t0 + counts[split.index]]
                out.append(mine.reshape(-1, *shape[1:]))
        return (None, None, None, *out)
