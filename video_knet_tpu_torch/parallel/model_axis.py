"""The mesh's `model` axis: the frame split (VIS clip parallelism) and the
band split (VPS spatial sharding over the image rows).

Counterpart of the `model` axis of JAX's sharded steps:
`video_knet_tpu/train/vis.py:make_sharded_vis_train_step` shards the clip's
frame axis over `model`, and `train/vps.py:make_sharded_train_step` the
image height (its `constrain`); XLA then splits the work and adds the halo
exchanges, the gathers and the partial-sum all-reduces. The port does it by
hand. The train steps open `model_split(mesh, kind)`, and
`models/backbones.py:backbone_and_neck` runs the backbone and the neck on
this rank's share of its data index's rows; the share stays active past
the neck, through the heads and the loss block, until the split closes
(`in_frames`, `in_band`; `hold_share`), so that nothing gathers the
pyramid:
- "frames": contiguous frames of each clip (T=5 over 2 ranks: 3 + 2; the
  split's `units` are each rank's frames), for every backbone and neck
  (frames are independent). The per-frame heads (the kernel head, the
  stage loop, the per-frame clip stages, K1 and K2) run on this rank's
  frames. What spans the clip's frames: the temporal positional encoding
  takes the whole clip's rows of this rank's frames (`frame_slice`); the
  clip kernels' merge takes every frame's kernels (`gather_frames`, a few
  hundred kB, never the features); the clip stages' mean over T and the
  volume head's tube pool are this rank's partial sums, summed over the
  group and divided by the clip's length (`frame_mean`, `frame_sum`).
  The rule for a sum in the heads and the loss block: a sum within one
  frame (its pixels: K1, GroupNorm, a frame's dice) stays local; a sum
  over the clip's T frames (the tube costs and the tube losses over
  T*H*W, the mean over T) is this rank's partial sum, summed over the
  group (`frame_sum`) before it is used; a count over the B*T frames (a
  per-frame loss's normalizer) is summed there too (`frame_count`), and
  each per-frame loss is this rank's share (its frames' sum over the
  global normalizer), the shares summed over the group
  (`models/vis/knet_vis.py:knet_vis_loss`); a count over the clips (the
  matched tubes) is the same on every rank and is not summed. Each call
  site names its sum: `model_sum` never sums over frames and `frame_sum`
  never over bands;
- "rows": a band of the image rows, for ResNet, Swin and MiT with the FPN
  or the MSDeformAttn pixel decoder and for the RFP backbones (DetectoRS,
  the RFP Swin; no neck), at every height at which JAX's whole VPS step
  runs: a multiple of 8 rows (`ROWS_MULTIPLE`; at other heights the step's
  stride-8 mask logits, upscaled, miss the GT's rows). The image's ceil(H / 32) stride-32 rows
  split as frames do (`band_units`: the first bands one more where the
  count does not divide); every band but the last ends on a whole
  stride-32 row and the last holds the partial one (376 rows over 2: 6 + 6
  units, bands of 192 + 184 rows; 720 over 2: 12 + 11, 384 + 336). A map
  of the model is told by its columns, which every rank holds whole: at
  stride s (its columns ceil(W / s)) rank i owns rows [a_i / s, a_{i+1} /
  s) of it, a_i its band's first image row, and the last rank the rows
  from its start to the map's global end, ceil(H / s) at a level of the
  backbone (`level_bands`; the Semantic-FPN's upsampled maps, whose end is
  twice their source's, pass their rows explicitly: `scaled_bands`). So a
  band's rows are its global rows' share of the whole map, never guessed
  from their count (72 rows over 2: 64 + 8, the last band holds one row at
  strides 8, 16 and 32 alike), and every rank builds the same exchange.
  Interior bands have even heights below stride 32, so 2x2 patch merging
  pairs the right rows, and all padding of the whole map falls at its
  global bottom, in the last band. The layers that reach across rows take
  the rows they lack from the other bands (`fetch_rows`): each
  convolution and the stem's max-pool the rows its window reads for the
  output rows it owns, at the whole level's "SAME" padding
  (`window_rows`; zero, or -inf for the pool, only past the level's
  global top and bottom), each bilinear upsampling by a whole factor one
  neighbour row on either side, any other resize (the FPN's nearest
  top-down resize, the Semantic-FPN's antialiased shrink) the source rows
  its own output rows read, each Swin block the rows of every window that
  meets its band (`models/swin.py`: a halo, and for the shifted windows the
  ring that joins the map's last rows to its first), each MiT block the
  whole spatially reduced keys and values (`whole_map`), each layer of the
  deformable encoder the whole value maps of its three levels
  (`whole_maps`: its sampling points reach anywhere), SAC's 5x5 pool and
  its dilated 3x3 convs a halo of 2 and of d rows at dilation d (3 at
  most; on bands of one row the halo reaches past the neighbouring band,
  and `fetch_rows` serves it from the band that owns it), and the aligned
  head and the RoI track head, whose warps and boxes reach anywhere, the
  whole pyramid and the whole fused map. SAC's global context is a band's
  partial sum, summed over `model`, over the whole map's pixels.
  Every sum over pixels is a band's partial sum, summed over the `model`
  group before it is used (`model_sum`: GroupNorm's statistics, K1's
  pooled features, the Hungarian costs' and the dice loss's sums, the
  pixel losses), and every pixel count a normalizer takes is summed there
  too (`model_count`).

The loss share: each rank's loss is its data index's loss over n_model
(`train/train_state.py`). Every value that reaches the loss from a band or
from this rank's frames goes through a `model_sum` or a `frame_sum`, and
the work on the N x C kernels is replicated, so every rank of a data index
holds the same loss. `_ModelSum`'s backward sums the incoming gradients
over the group, so each partial sum takes the whole loss's gradient
(n_model ranks each handing it 1 / n_model), and the gradient DDP sums
over the world counts each replicated parameter once and sums the
per-pixel and per-frame layers over their bands or frames; `_Gather`'s
backward does the same for the gathered kernels.

The collectives are all_gather and all_reduce, which gloo runs on CUDA
tensors too (ranks sharing a card). `BYTES` counts what this rank hands to
them, forward and backward: "halo" the rows lent to or returned from other
bands, "ring" those of them that a shifted Swin window takes across the
map's bottom edge to its top, "gather" the frame split's per-frame kernels
and the band split's `whole_map`s (the deformable encoder's value maps
among them), "reduce" the sums over the group.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F

from video_knet_tpu_torch.parallel.mesh import DataMesh

STRIDE = 32  # the backbones' total stride: interior bands end on a whole row of it
# JAX's whole VPS step runs at heights that are multiples of 8 (its stride-8
# mask logits, upscaled, match the GT's floor(H / 2) or floor(H / 4) rows
# only there); the band split takes those heights
ROWS_MULTIPLE = 8
# the strides of the model's maps on a band: a map of ceil(W / s) columns is
# at stride s (an upsampled map: its source's stride over the factor)
STRIDES = (1, 2, 4, 8, 16, 32)
KINDS = ("rows", "frames")

BYTES = {"halo": 0, "ring": 0, "gather": 0, "reduce": 0}


def reset_bytes() -> None:
    for k in BYTES:
        BYTES[k] = 0


@dataclasses.dataclass(frozen=True)
class Split:
    """The step's split over the `model` axis: `kind` ("rows" or
    "frames"), the `model` group, this rank's index on it and the count;
    once the backbone runs on a share, `units`: each rank's stride-32 rows
    of the image (the last one's partial row counted whole), or its frames
    of a clip, and under the band split `image`: the image's (rows,
    columns)."""

    kind: str
    group: Any
    index: int
    count: int
    units: tuple[int, ...] = ()
    image: tuple[int, int] = (0, 0)


_SPLIT: contextvars.ContextVar[Split | None] = contextvars.ContextVar(
    "vknet_model_split", default=None)
_BAND: contextvars.ContextVar[Split | None] = contextvars.ContextVar("vknet_band", default=None)
_SHARE: contextvars.ContextVar[Callable | None] = contextvars.ContextVar(
    "vknet_share", default=None)
# under a split: [share, select] once the backbone has run on this rank's share
_HELD: contextvars.ContextVar[list | None] = contextvars.ContextVar("vknet_held", default=None)
_OFF: contextvars.ContextVar[bool] = contextvars.ContextVar("vknet_off_band", default=False)


@contextlib.contextmanager
def model_split(mesh: DataMesh | None, kind: str | None):
    """While active, `backbone_and_neck` splits its batch over `mesh`'s
    `model` axis as `kind` says (nothing for no kind, with one rank on the
    axis or without a process group); the band or the frames it takes
    stay active until the context closes."""
    if kind not in (None, *KINDS):
        raise ValueError(f"split kind {kind!r}, not one of {KINDS}")
    split = None
    if kind is not None and mesh is not None and mesh.distributed and mesh.n_model > 1:
        split = Split(kind, mesh.model_group, mesh.model_index, mesh.n_model)
    tokens = (_SPLIT.set(split), _HELD.set(None if kind is None else []))
    try:
        yield
    finally:
        _SPLIT.reset(tokens[0])
        _HELD.reset(tokens[1])


def active_split() -> Split | None:
    return _SPLIT.get()


def in_band() -> Split | None:
    """The band split (with its `units`) while the model runs on a band of
    the image rows: from the backbone on, until `model_split` closes
    (outside `off_band`); else None. The layers that reach across rows
    exchange them then, and the sums over pixels sum over the `model`
    group."""
    if _OFF.get():
        return None
    band = _BAND.get()
    if band is not None:
        return band
    held = _HELD.get()
    return held[0] if held and held[0].kind == "rows" else None


def in_frames() -> Split | None:
    """The frame split (with its `units`, each rank's frames of a clip)
    while the model runs on this rank's frames of each clip: from the end
    of the backbone and the neck until `model_split` closes; else None.
    Sums over the clip's frames sum over the `model` group then
    (`frame_sum`)."""
    held = _HELD.get()
    return held[0] if held and held[0].kind == "frames" else None


def hold_share(share: Split, select: Callable) -> None:
    """Keep `share` (a band, or this rank's frames) active past the
    backbone and the neck (`in_band`, `in_frames`), with `select` the cut
    of a whole batch to it (`held_share`)."""
    held = _HELD.get()
    if held is None:
        raise RuntimeError("a share is held only inside model_split(mesh, kind)")
    held[:] = [share, select]


@contextlib.contextmanager
def off_band():
    """While active, the model runs as on the whole map: for a module fed a
    whole map under the band split (the RoI track head, Swin's absolute
    position embedding)."""
    token = _OFF.set(True)
    try:
        yield
    finally:
        _OFF.reset(token)


def local_share(t: torch.Tensor) -> torch.Tensor:
    """`t`, laid out as the backbone's batch of this rank's data index, cut
    to this rank's share while the backbone and the neck run on a share, or
    the heads' per-pixel or per-frame layers on the held one
    (`held_share`); `t` itself elsewhere (a ReLU decision replayed on a
    rank, `tools/dp_check.py`)."""
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


@contextlib.contextmanager
def held_share(frame_axis: int = 0):
    """Around the heads' per-pixel or per-frame layers (the kernel head's
    convolutions; under the frame split also the stage loop and the
    per-frame clip stages): `local_share` cuts a whole batch to the held
    band or frames there, as it does in the backbone; `frame_axis` 1 for
    tensors laid out [B, T, ...] (the per-frame clip stages) instead of
    [B*T, ...]. Nothing outside a split."""
    held = _HELD.get()
    if not held or _OFF.get():
        yield
        return
    share, select = held
    if share.kind == "frames" and frame_axis == 1:
        frames = _frame_range(share)
        select = lambda t: t[:, frames]  # noqa: E731
    with running_share(share, select):
        yield


def band_slice(t: torch.Tensor, dim: int) -> torch.Tensor:
    """`t`, laid out over the image rows (or a level's) along `dim`, cut to
    this rank's band of them while a band is active; `t` itself otherwise
    (the GT masks, a positional encoding made for the whole level)."""
    band = in_band()
    if band is None:
        return t
    rows = band_rows(t.shape[dim], t.shape[dim + 1 if dim >= 0 else dim + t.dim() + 1], band)
    return t.narrow(dim, rows.start, rows.stop - rows.start)


def _shares(n: int, count: int) -> list[int]:
    """`n` split into `count` contiguous shares, the first ones one more
    where `count` does not divide `n`."""
    return [n // count + (i < n % count) for i in range(count)]


def band_units(h: int, count: int) -> list[int]:
    """Each band's stride-32 rows of an image of `h` rows over `count`
    ranks, the last band's partial row counted whole (736 over 2: 12 + 11;
    376 over 2: 6 + 6, bands of 192 + 184 rows). Raises ValueError for a
    height JAX's whole VPS step refuses (not a multiple of
    `ROWS_MULTIPLE`) and for fewer stride-32 rows than bands."""
    if h % ROWS_MULTIPLE:
        raise ValueError(
            f"JAX's whole VPS step refuses {h} image rows (its stride-8 mask logits, upscaled, "
            f"miss the GT's rows): the band split takes multiples of {ROWS_MULTIPLE}")
    units = -(-h // STRIDE)
    if units < count:
        raise ValueError(f"{h} image rows ({units} at stride {STRIDE}) do not split "
                         f"into {count} bands")
    return _shares(units, count)


def image_band(split: Split, h: int, w: int) -> tuple[Split, Callable]:
    """This rank's band of an image of `h` x `w` under the band split
    `split` (with its `units` and `image`), and the cut of a batch laid out
    over the rows of any of the model's maps, [B, rows, columns, ...], to
    it. Raises ValueError where `band_units` does, and for an image too
    narrow for its maps' columns to tell their strides apart."""
    band = dataclasses.replace(split, units=tuple(band_units(h, split.count)), image=(h, w))
    if len({-(-w // s) for s in STRIDES}) < len(STRIDES):
        raise ValueError(f"an image {w} columns wide is too narrow for the band split: its "
                         f"maps' columns {[-(-w // s) for s in STRIDES]} repeat")
    return band, lambda t: t[:, band_rows(t.shape[1], t.shape[2], band)]


def _stride_of(band: Split, cols: int) -> int:
    """The stride of a map `cols` columns wide: ceil(W / s) columns at
    stride s, or f * ceil(W / s) for a map upsampled f times from stride s
    (stride s / f). The same on every rank: each holds the map's columns
    whole."""
    w = band.image[1]
    found = {s // f for s in STRIDES for f in STRIDES if f <= s and f * -(-w // s) == cols}
    if len(found) != 1:
        raise ValueError(f"a map {cols} columns wide is not one of the model's maps of an "
                         f"image {w} wide on a band")
    return found.pop()


def map_bands(band: Split, cols: int, end: int | None = None) -> tuple[tuple[int, int], ...]:
    """Every rank's (first, end) global rows of the map `cols` columns wide
    at `band`'s split: at stride s, rank i starts at its band's first image
    row over s, and the last rank ends at the map's global end `end`
    (default: ceil(H / s), a level of the backbone)."""
    s = _stride_of(band, cols)
    per = STRIDE // s
    starts = [per * sum(band.units[:i]) for i in range(band.count)]
    end = -(-band.image[0] // s) if end is None else end
    if end <= starts[-1]:
        raise ValueError(f"a map of {end} rows at stride {s} leaves the last of the bands "
                         f"{band.units} no row")
    return tuple(zip(starts, [*starts[1:], end]))


def scaled_bands(bands: tuple | None, factor: int) -> tuple | None:
    """The rows of a map `bands` (None outside a band) upsampled `factor`
    times: every rank's rows times the factor."""
    return None if bands is None else tuple((factor * a, factor * b) for a, b in bands)


def band_rows(h: int, cols: int, band: Split) -> slice:
    """This rank's rows of a map of `h` rows and `cols` columns in all (the
    image, a level inside the backbone, an upsampled map)."""
    start, stop = map_bands(band, cols, h)[band.index]
    return slice(start, stop)


def level_bands(rows: int, cols: int, band: Split) -> tuple[tuple[int, int], ...]:
    """Every rank's (first, end) global rows of the level of the backbone
    (or a map of the heads at its stride) whose band, on this rank, is
    `rows` x `cols`: told by its columns (`map_bands`), checked by its rows.
    An upsampled map whose end is not its stride's level's passes its rows
    (`scaled_bands`) to the layers instead."""
    bands = map_bands(band, cols)
    a, b = bands[band.index]
    if b - a != rows:
        raise ValueError(f"a band of {rows} x {cols} is not this rank's rows {(a, b)} of a level "
                         f"of the bands {band.units} of {band.image}")
    return bands


def map_rows(x: torch.Tensor) -> tuple | None:
    """The bands of NHWC `x`, a level's band (`level_bands`); None outside
    a band."""
    band = in_band()
    return None if band is None else level_bands(x.shape[1], x.shape[2], band)


def level_height(rows: int, cols: int) -> int:
    """The global height of the level whose band on this rank is `rows` x
    `cols`; `rows` itself outside a band."""
    band = in_band()
    return rows if band is None else level_bands(rows, cols, band)[-1][1]


def level_rows(rows: int, cols: int) -> tuple[int, int, int]:
    """(first, end, height): this rank's global rows of the level whose band
    here is `rows` x `cols`, and the level's height; (0, rows, rows)
    outside a band."""
    band = in_band()
    if band is None:
        return 0, rows, rows
    bands = level_bands(rows, cols, band)
    return (*bands[band.index], bands[-1][1])


@contextlib.contextmanager
def token_share(shapes: list[tuple[int, int]]):
    """Around layers on this rank's tokens of a band's levels, flattened
    level by level ([B, sum_l rows_l * cols_l, ...], each level's band
    `shapes[l]`: the deformable encoder): `local_share` cuts a whole batch's
    tokens (every level's whole rows) to this rank's there. Nothing outside
    a band."""
    band = in_band()
    if band is None:
        yield
        return
    index, start = [], 0
    for h, w in shapes:
        bands = level_bands(h, w, band)
        a, b = bands[band.index]
        index.append(torch.arange(start + a * w, start + b * w))
        start += bands[-1][1] * w
    index = torch.cat(index)
    token = _SHARE.set(lambda t: t.index_select(1, index.to(t.device)))
    try:
        yield
    finally:
        _SHARE.reset(token)


def frame_counts(t: int, count: int) -> list[int]:
    """Frames a rank of a clip of `t` over `count` ranks: contiguous, the
    first ranks one more where `t` does not divide (5 over 2: 3 + 2)."""
    if t < count:
        raise ValueError(f"a clip of {t} frames does not split over {count} model ranks")
    return _shares(t, count)


def frame_share(split: Split, t: int) -> Split:
    """`split` with its `units`: each rank's frames of a clip of `t`."""
    return dataclasses.replace(split, units=tuple(frame_counts(t, split.count)))


def _frame_range(share: Split) -> slice:
    t0 = sum(share.units[:share.index])
    return slice(t0, t0 + share.units[share.index])


def frame_rows(clips: int, t: int, split: Split) -> torch.Tensor:
    """The rows (b*t + frame) of this rank's frames of each of `clips`
    clips of `t` frames."""
    mine = _frame_range(frame_share(split, t))
    frames = torch.arange(mine.start, mine.stop)
    return (torch.arange(clips)[:, None] * t + frames[None]).reshape(-1)


def clip_frames(t: int) -> int:
    """The clip's length where this rank holds `t` of its frames: the held
    clip's under the frame split, `t` itself otherwise."""
    share = in_frames()
    if share is None:
        return t
    if t != share.units[share.index]:
        raise ValueError(f"{t} frames are not this rank's {share.units[share.index]} of the "
                         f"clip's {sum(share.units)}")
    return sum(share.units)


def local_frames(t: int) -> int:
    """This rank's frames of a clip of `t` frames under the frame split;
    `t` itself otherwise."""
    share = in_frames()
    if share is None:
        return t
    if t != sum(share.units):
        raise ValueError(f"a clip of {t} frames is not the held clip of {sum(share.units)}")
    return share.units[share.index]


def frame_slice(t: torch.Tensor, dim: int) -> torch.Tensor:
    """`t`, laid out over a clip's frames along `dim`, cut to this rank's
    frames under the frame split; `t` itself otherwise (the GT tubes, the
    temporal positional encoding made for the whole clip)."""
    share = in_frames()
    if share is None:
        return t
    if t.shape[dim] != sum(share.units):
        raise ValueError(f"{t.shape[dim]} frames along dim {dim}, not the held clip's "
                         f"{sum(share.units)}")
    mine = _frame_range(share)
    return t.narrow(dim, mine.start, mine.stop - mine.start)


# ------------------------------------------------------------ collectives


def _all_gather(x: torch.Tensor, split: Split, what: str | None = None) -> list[torch.Tensor]:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(split.count)]
    torch.distributed.all_gather(parts, x, group=split.group)
    if what is not None:
        BYTES[what] += x.numel() * x.element_size()
    return parts


@dataclasses.dataclass(frozen=True)
class _Plan:
    """Where each row of `fetch_rows`' output comes from, for this rank:
    `source[p]` indexes [own rows, the fill row, every rank's lent rows
    (each padded to `lend_len`)]; `lend` are the own rows this rank lends
    (`lend_ring` of them to a ring); `borrowed` the output positions it
    borrows (`borrowed_ring` of them through a ring) and `returned[j]` the
    (position in rank j's borrowed rows, own row) pairs whose gradient
    comes back from rank j."""

    source: tuple[int, ...]
    lend: tuple[int, ...]
    lend_len: int
    lend_ring: int
    own: tuple[tuple[int, int], ...]
    borrowed: tuple[int, ...]
    borrowed_len: int
    borrowed_ring: int
    returned: tuple[tuple[tuple[int, int], ...], ...]


@functools.lru_cache(maxsize=1024)  # a plan a block or conv geometry
def _plan(need: tuple, ring: tuple, bands: tuple, me: int) -> _Plan:
    h = bands[-1][1]

    def owner(g: int) -> int | None:
        if not 0 <= g < h:
            return None
        return next(j for j, (a, b) in enumerate(bands) if a <= g < b)

    lent = [sorted({g for j, rows in enumerate(need) if j != i for g in rows
                    if owner(g) == i}) for i in range(len(bands))]
    lend_len = max(len(rows) for rows in lent)
    rows_here = bands[me][1] - bands[me][0]
    source = []
    for g in need[me]:
        j = owner(g)
        if j is None:
            source.append(rows_here)
        elif j == me:
            source.append(g - bands[me][0])
        else:
            source.append(rows_here + 1 + j * lend_len + lent[j].index(g))
    borrowed = [[p for p, g in enumerate(rows) if owner(g) not in (None, i)]
                for i, rows in enumerate(need)]
    returned = tuple(
        tuple((q, need[j][p] - bands[me][0]) for q, p in enumerate(borrowed[j])
              if owner(need[j][p]) == me) if j != me else ()
        for j in range(len(bands)))
    return _Plan(
        source=tuple(source), lend=tuple(g - bands[me][0] for g in lent[me]),
        lend_len=lend_len,
        lend_ring=sum(any(g in ring[j] for j in range(len(bands)) if j != me) for g in lent[me]),
        own=tuple((p, g - bands[me][0]) for p, g in enumerate(need[me]) if owner(g) == me),
        borrowed=tuple(borrowed[me]), borrowed_len=max(len(b) for b in borrowed),
        borrowed_ring=sum(need[me][p] in ring[me] for p in borrowed[me]), returned=returned)


def fetch_rows(x: torch.Tensor, need: tuple, split: Split, fill: float = 0.0,
               ring: tuple | None = None, bands: tuple | None = None) -> torch.Tensor:
    """The rows `need[split.index]` (global rows of the map of NHWC band
    `x`; rows past the map's top or bottom are `fill`) of the whole map, in
    that order. `need` holds every rank's rows (all ranks call this
    together with the same `need`); `ring[j]`, if given, the rows rank j
    takes through a ring (counted apart in `BYTES`); `bands`: every rank's
    rows of the map (default: `x` a level's band, `level_bands`). The
    backward adds each borrowed row's gradient to the rank that owns the
    row."""
    if bands is None:
        bands = level_bands(x.shape[1], x.shape[2], split)
    ring = tuple(frozenset() for _ in need) if ring is None else ring
    return _Fetch.apply(x, _plan(tuple(need), tuple(ring), bands, split.index), fill, split)


def _count(rows: int, ring_rows: int, row_bytes: int) -> None:
    BYTES["ring"] += ring_rows * row_bytes
    BYTES["halo"] += (rows - ring_rows) * row_bytes


@functools.lru_cache(maxsize=4096)
def index_on(rows: tuple, device: torch.device) -> torch.Tensor:
    """`rows` as an index tensor on `device`, made once (the plans repeat
    every step)."""
    return torch.tensor(rows, dtype=torch.long, device=device)


class _Fetch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan: _Plan, fill, split):
        ctx.plan, ctx.split, ctx.rows = plan, split, x.shape[1]
        b, _, w, c = x.shape
        pieces = [x, x.new_full((b, 1, w, c), fill)]
        if plan.lend_len:
            mine = x.index_select(1, index_on(plan.lend, x.device))
            mine = F.pad(mine, (0, 0, 0, 0, 0, plan.lend_len - len(plan.lend)))
            pieces += _all_gather(mine, split)
            _count(plan.lend_len, plan.lend_ring, b * w * c * x.element_size())
        return torch.cat(pieces, 1).index_select(1, index_on(plan.source, x.device))

    @staticmethod
    def backward(ctx, g):
        plan, split = ctx.plan, ctx.split
        b, _, w, c = g.shape
        gx = g.new_zeros((b, ctx.rows, w, c))
        if plan.own:
            pos, rows = zip(*plan.own)
            gx.index_add_(1, index_on(rows, g.device), g.index_select(1, index_on(pos, g.device)))
        if plan.borrowed_len:
            mine = g.index_select(1, index_on(plan.borrowed, g.device))
            mine = F.pad(mine, (0, 0, 0, 0, 0, plan.borrowed_len - len(plan.borrowed)))
            parts = _all_gather(mine, split)
            _count(plan.borrowed_len, plan.borrowed_ring, b * w * c * g.element_size())
            for j, pairs in enumerate(plan.returned):
                if pairs:
                    pos, rows = zip(*pairs)
                    gx.index_add_(1, index_on(rows, g.device),
                                  parts[j].index_select(1, index_on(pos, g.device)))
        return gx, None, None, None


def window_rows(x: torch.Tensor, bands: tuple, k: int, s: int, lo: int, hi: int,
                fill: float, split: Split) -> torch.Tensor:
    """The rows of the whole map (NHWC band `x` of it, every rank's rows
    `bands`) that a `k`-row window at stride `s` reads, over the map padded
    by `lo` rows on top and `hi` below (`fill` there), for the output rows
    this rank owns, from the other bands where they lie there. A rank owns
    the output rows from its first row over `s` (interior bands start on a
    multiple of it) to the next rank's, the last to the output's end; run
    on the rows with no row padding, the window gives exactly them."""
    end = (bands[-1][1] + lo + hi - k) // s + 1
    starts = []
    for a, _ in bands:
        if a % s:
            raise ValueError(f"a band starting at row {a} of its map does not start a "
                             f"stride-{s} window")
        starts.append(a // s)
    need = tuple(tuple(range(o0 * s - lo, (o1 - 1) * s - lo + k))
                 for o0, o1 in zip(starts, [*starts[1:], end]))
    if need == tuple(tuple(range(a, b)) for a, b in bands):
        return x
    return fetch_rows(x, need, split, fill, bands=bands)


def neighbour_rows(x: torch.Tensor, band: Split,
                   bands: tuple | None = None) -> tuple[torch.Tensor, int]:
    """NHWC band `x` with the row above it and the row below it from the
    neighbouring bands, none past the map's global top or bottom: (the
    rows, the rows added on top). What a bilinear resize of the band by a
    whole factor needs to give each output row the whole map's arithmetic.
    `bands`: as for `fetch_rows`."""
    if bands is None:
        bands = level_bands(x.shape[1], x.shape[2], band)
    h = bands[-1][1]
    need = tuple(tuple(range(max(a - 1, 0), min(b + 1, h))) for a, b in bands)
    return fetch_rows(x, need, band, bands=bands), int(bands[band.index][0] > 0)


class _ModelSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, flat):
        ctx.group = group
        out = flat.clone()
        torch.distributed.all_reduce(out, group=group)
        BYTES["reduce"] += out.numel() * out.element_size()
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        torch.distributed.all_reduce(g, group=ctx.group)
        BYTES["reduce"] += g.numel() * g.element_size()
        return None, g


def _group_sum(share: Split | None, ts: tuple):
    if share is not None:
        dtype = functools.reduce(torch.promote_types, (t.dtype for t in ts))
        flat = _ModelSum.apply(share.group, torch.cat([t.reshape(-1).to(dtype) for t in ts]))
        ts = tuple(part.view(t.shape).to(t.dtype) for part, t in
                   zip(flat.split([t.numel() for t in ts]), ts))
    return ts[0] if len(ts) == 1 else ts


def _group_count(share: Split | None, x: torch.Tensor) -> torch.Tensor:
    if share is None:
        return x
    out = x.detach().clone()
    torch.distributed.all_reduce(out, group=share.group)
    BYTES["reduce"] += out.numel() * out.element_size()
    return out


def model_sum(*ts: torch.Tensor):
    """Each of `ts` (a band's partial sums over its pixels) summed over the
    `model` group in one all_reduce, whose backward sums the gradients over
    the group too (as `parallel/mesh.py:sum_with_grad` does over the
    world); the tensor for one, a tuple for several. The identity outside
    a band."""
    return _group_sum(in_band(), ts)


def model_count(x: torch.Tensor) -> torch.Tensor:
    """A count over a band's pixels (no gradient) summed over the `model`
    group: a loss normalizer's share of the whole map. The identity outside
    a band."""
    return _group_count(in_band(), x)


def frame_sum(*ts: torch.Tensor):
    """Each of `ts` (this rank's partial sums over its frames of the clip:
    a tube cost's or a tube loss's sums over T*H*W, a per-frame loss's
    share) summed over the `model` group in one all_reduce, whose backward
    sums the gradients over the group too; the tensor for one, a tuple for
    several. The identity outside the frame split."""
    return _group_sum(in_frames(), ts)


def frame_count(x: torch.Tensor) -> torch.Tensor:
    """A count over this rank's frames (no gradient: matched rows or
    pixels of the B*T frames) summed over the `model` group: a per-frame
    loss normalizer's share of the clips' frames. The identity outside the
    frame split."""
    return _group_count(in_frames(), x)


def frame_mean(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The mean of `x` over the clip's frames along `dim`: under the frame
    split this rank's partial sum, summed over the group, over the clip's
    length; `x.mean(dim)` otherwise."""
    if in_frames() is None:
        return x.mean(dim=dim)
    return frame_sum(x.sum(dim=dim)) / clip_frames(x.shape[dim])


def gather_frames(t: torch.Tensor) -> torch.Tensor:
    """`t` [B, T_r, ...], this rank's frames of each clip, gathered over the
    `model` group into [B, T, ...] (the backward keeps this rank's frames
    of the gradient summed over the group); `t` itself outside the frame
    split. For small per-frame tensors only: the clip kernels' merge takes
    every frame's kernels."""
    share = in_frames()
    if share is None:
        return t
    b, rest = t.shape[0], t.shape[2:]
    whole = gather_shares([t.reshape(-1, *rest)], share, clips=b, frames=sum(share.units))[0]
    return whole.reshape(b, -1, *rest)


def whole_map(t: torch.Tensor) -> torch.Tensor:
    """NHWC `t`, a band of a level, gathered over the `model` group into the
    whole level (the backward keeps this rank's rows of the gradient summed
    over the group); `t` itself outside a band. For a consumer whose reach
    is the whole map: MiT's reduced keys, the aligned head's warps, the
    RoI head's boxes."""
    return whole_maps([t])[0]


def whole_maps(ts: list[torch.Tensor]) -> list[torch.Tensor]:
    """`whole_map` of each of `ts` in one all_gather (the deformable
    encoder's value maps, every level's in each layer)."""
    band = in_band()
    return list(ts) if band is None else gather_shares(list(ts), band)


def gather_shares(shares: list[torch.Tensor], split: Split, clips: int | None = None,
                  frames: int | None = None) -> list[torch.Tensor]:
    """Each of this rank's shares gathered over the `model` group into the
    data index's order: bands (`split.units`) stacked along the rows, or
    (`clips`, `frames`) each clip's frames back in b*T + t order."""
    if frames is None:  # each level's rows of every band
        sizes = tuple(tuple(b - a for a, b in level_bands(s.shape[1], s.shape[2], split))
                      for s in shares)
    else:  # each rank's frames of a clip
        sizes = (tuple(frame_counts(frames, split.count)),) * len(shares)
    return list(_Gather.apply(split, clips, sizes, *shares))


def _layout(s: torch.Tensor, clips: int | None) -> tuple[int, int, tuple]:
    """A share as (lead, along, rest): [B, rows, W, C] of a band, or
    [clips * frames, ...] of a clip's frames."""
    if clips is None:
        return s.shape[0], s.shape[1], tuple(s.shape[2:])
    return clips, s.shape[0] // clips, tuple(s.shape[1:])


class _Gather(torch.autograd.Function):
    """Each rank's share of level l is `sizes[l][rank]` rows, or frames of
    each clip, along its second axis; the shares are padded to the longest
    for the all_gather."""

    @staticmethod
    def forward(ctx, split, clips, sizes, *shares):
        levels = []
        for s, n in zip(shares, sizes):
            lead, along, rest = _layout(s, clips)
            if along != n[split.index]:
                raise ValueError(f"a share of {along} along its rows or frames, not this "
                                 f"rank's {n[split.index]}")
            levels.append((lead, list(n), rest))
        size = [sum(lead * n[j] * math.prod(rest) for lead, n, rest in levels)
                for j in range(split.count)]
        flat = torch.cat([s.reshape(-1) for s in shares])
        parts = _all_gather(F.pad(flat, (0, max(size) - flat.numel())), split, "gather")
        out, offs = [], [0] * split.count
        for s, (lead, n, rest) in zip(shares, levels):
            pieces = []
            for j, p in enumerate(parts):
                pieces.append(p[offs[j]:offs[j] + lead * n[j] * math.prod(rest)].view(
                    lead, n[j], *rest))
                offs[j] += lead * n[j] * math.prod(rest)
            whole = torch.cat(pieces, 1)
            out.append(whole if clips is None else whole.reshape(-1, *rest))
        ctx.split, ctx.clips, ctx.levels = split, clips, levels
        ctx.full = [o.shape for o in out]
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        split = ctx.split
        flat = torch.cat([g.reshape(-1) for g in grads])
        torch.distributed.all_reduce(flat, group=split.group)
        BYTES["gather"] += flat.numel() * flat.element_size()
        out, off = [], 0
        for shape, (lead, n, rest) in zip(ctx.full, ctx.levels):
            g = flat[off:off + math.prod(shape)].view(lead, sum(n), *rest)
            off += math.prod(shape)
            start = sum(n[:split.index])
            mine = g[:, start:start + n[split.index]]
            out.append(mine if ctx.clips is None else mine.reshape(-1, *rest))
        return (None, None, None, *out)
