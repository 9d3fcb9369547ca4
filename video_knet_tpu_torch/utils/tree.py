"""Leaf-wise maps over the nested payloads of the serving path, and their
transfer to the host as one packed buffer.

A payload is a dict, NamedTuple, tuple or list whose leaves are tensors or
numpy arrays (`jax.tree_util.tree_map` in the reference).

`pack` lays every tensor leaf of a payload into one contiguous uint8 device
buffer (each leaf at a 16-byte aligned offset) and returns it with a static
`Layout`; `unpack` rebuilds the payload on the host as numpy views of the
copied buffer. `HostCopy` enqueues the buffer's one copy into pinned memory
and records an event; `HostCopy.result()` waits on that event only.
The reference fetches a payload in one `jax.device_get` in the same way.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

ALIGN = 16  # bytes; every leaf starts at a multiple
_ZEROS: dict[torch.device, torch.Tensor] = {}  # one ALIGN-byte block a device, for pads

_NUMPY_DTYPES = {
    torch.bool: np.bool_, torch.uint8: np.uint8, torch.int8: np.int8,
    torch.int16: np.int16, torch.int32: np.int32, torch.int64: np.int64,
    torch.float16: np.float16, torch.float32: np.float32, torch.float64: np.float64,
    torch.bfloat16: np.uint16,  # re-floated on the host (exact)
}


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` applied to the leaves of `tree` and the matching leaves of `rest`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_stack(trees: list) -> Any:
    """Stack a list of same-structure trees along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def tree_index(tree: Any, i: int) -> Any:
    return tree_map(lambda x: x[i], tree)


class _Slot:
    """Where leaf `index` of a packed payload goes back in."""

    def __init__(self, index: int):
        self.index = index


@dataclass(frozen=True)
class LeafSpec:
    path: str
    dtype: torch.dtype
    shape: tuple[int, ...]
    offset: int  # bytes into the buffer, a multiple of ALIGN
    nbytes: int


@dataclass(frozen=True)
class Layout:
    skeleton: Any  # the payload with each tensor leaf replaced by a _Slot
    leaves: tuple[LeafSpec, ...]
    nbytes: int


def pack(tree: Any) -> tuple[torch.Tensor, Layout]:
    """Every tensor leaf of `tree` -> one contiguous uint8 buffer on their
    device, plus the static layout. Other leaves stay in the layout."""
    tensors: list[tuple[str, torch.Tensor]] = []

    def skeleton(node, path):
        if isinstance(node, dict):
            return {k: skeleton(v, f"{path}/{k}") for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(skeleton(v, f"{path}/{f}") for f, v in zip(node._fields, node)))
        if isinstance(node, (tuple, list)):
            return type(node)(skeleton(v, f"{path}/{i}") for i, v in enumerate(node))
        if torch.is_tensor(node):
            tensors.append((path, node))
            return _Slot(len(tensors) - 1)
        return node

    skel = skeleton(tree, "")
    if len({x.device for _, x in tensors}) > 1:
        raise ValueError(f"payload leaves on several devices: {[x.device for _, x in tensors]}")
    pieces, specs, offset = [], [], 0
    for path, x in tensors:
        raw = x.detach().contiguous().reshape(-1).view(torch.uint8)
        specs.append(LeafSpec(path, x.dtype, tuple(x.shape), offset, raw.numel()))
        pieces.append(raw)
        pad = -raw.numel() % ALIGN
        if pad:
            pieces.append(_zeros(raw.device)[:pad])
        offset += raw.numel() + pad
    device = tensors[0][1].device if tensors else torch.device("cpu")
    buf = torch.cat(pieces) if pieces else torch.empty(0, dtype=torch.uint8, device=device)
    return buf, Layout(skel, tuple(specs), offset)


def _zeros(device: torch.device) -> torch.Tensor:
    """ALIGN zero bytes on `device`, made once: a pad costs no launch."""
    if device not in _ZEROS:
        _ZEROS[device] = torch.zeros(ALIGN, dtype=torch.uint8, device=device)
    return _ZEROS[device]


def unpack(buf: np.ndarray, layout: Layout, copy: bool = False) -> Any:
    """The payload from its packed host bytes: numpy views of `buf` (copies
    with `copy`); bf16 leaves are re-floated to float32 (exact)."""
    arrays = []
    for s in layout.leaves:
        a = buf[s.offset:s.offset + s.nbytes].view(_NUMPY_DTYPES[s.dtype]).reshape(s.shape)
        if s.dtype == torch.bfloat16:
            a = (a.astype(np.uint32) << 16).view(np.float32)
        elif copy:
            a = a.copy()
        arrays.append(a)
    return tree_map(lambda x: arrays[x.index] if isinstance(x, _Slot) else x, layout.skeleton)


class HostCopy:
    """A payload on its way to the host: one packed buffer, one copy
    enqueued on the current stream into pinned memory, one event. On the
    CPU the packed buffer is the host buffer (no copy)."""

    def __init__(self, tree: Any):
        buf, self.layout = pack(tree)
        self.event = None
        if buf.device.type == "cuda":
            self.host = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=True)
            self.host.copy_(buf, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = buf

    def result(self) -> Any:
        """Wait for this copy only, then the numpy payload. From pinned
        memory the leaves are copied out, so the pinned block goes back to
        the caching allocator at once and the next frame reuses it."""
        if self.event is None:
            return unpack(self.host.numpy(), self.layout)
        self.event.synchronize()
        out = unpack(self.host.numpy(), self.layout, copy=True)
        self.host = None
        return out


def to_host(tree: Any) -> Any:
    """Device tensors -> numpy through one packed copy; bf16 leaves cross as
    bf16 and are re-floated on the host (exact), as the reference's
    `np.asarray(x, np.float32)`."""
    return HostCopy(tree).result()
