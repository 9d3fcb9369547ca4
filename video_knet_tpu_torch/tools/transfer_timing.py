"""A serving payload's trip to the host, and frame times by path, on one
NVIDIA GPU.

    python3 -m video_knet_tpu_torch.tools.transfer_timing fetch [--reps 200]
    python3 -m video_knet_tpu_torch.tools.transfer_timing frames [--frames 12]

Both use the R-50 serving model of `profile_serving` (`smoke_config`,
`smoke_model`) at 384x1248 on three paths: `device` (the tracker on the
device), `host` (the numpy tracker, compact payload) and `full`
(fast_decode=False, full payload).

`fetch` takes one payload of each path and, in turns on an otherwise idle
card, times three ways to bring it to the host as numpy (host ms from the
call to the finished payload, median over `--reps`):
  per_leaf  one blocking `.cpu()` a leaf
  packed    `utils/tree.py:to_host` (pack on the device, one copy into pinned
            memory, one event, leaves copied out of the pinned block)
  pinned    one non_blocking copy a leaf into slices of one pinned block,
            one event, leaves copied out
and the CUDA launches and copies each issues (from a torch.profiler trace).

`frames` serves `--frames` frames through each path with `run_frame`, the
paths in turn frame by frame, and prints the median frame ms of each over
frames 1..N (host clock; a frame ends with its payload on the host). It
reads only what every tree of the port since online serving has, so it can
be run against another checkout's package to compare two trees in one call:

    cd OTHER_CHECKOUT && PYTHONPATH=. python3 PATH/TO/transfer_timing.py frames
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from video_knet_tpu_torch.models.video.inference import VPSInferencePipeline
from video_knet_tpu_torch.tools.profile_serving import HW, smoke_config, smoke_model
from video_knet_tpu_torch.utils.device import card_name_and_power, set_fp32_numerics

def _pipelines() -> dict:
    import dataclasses

    cfg = smoke_config()
    full = dataclasses.replace(cfg, test=dataclasses.replace(cfg.test, fast_decode=False))
    out = {}
    for path, c, tracker in (("device", cfg, "quasi_dense"), ("host", cfg, "quasi_dense_host"),
                             ("full", full, "quasi_dense_host")):
        out[path] = VPSInferencePipeline(smoke_model(c, "cuda"), c, HW, tracker_type=tracker,
                                         device="cuda")
    return out


def _frames(n: int) -> list:
    rng = np.random.RandomState(0)
    return [torch.from_numpy(rng.randn(1, *HW, 3).astype(np.float32)).cuda() for _ in range(n)]


def frames(n: int) -> dict:
    pipes = _pipelines()
    imgs = _frames(n)
    ms: dict = {p: [] for p in pipes}
    for i, img in enumerate(imgs):
        for path, pipe in pipes.items():
            t0 = time.perf_counter()
            pipe.run_frame(img, is_first=(i == 0))
            ms[path].append((time.perf_counter() - t0) * 1e3)
    return {p: dict(median_ms=statistics.median(v[1:]), frame_ms=v) for p, v in ms.items()}


def _per_leaf(tree):
    from video_knet_tpu_torch.utils.tree import tree_map

    def leaf(x):
        if not torch.is_tensor(x):
            return x
        x = x.cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()

    return tree_map(leaf, tree)


def _pinned(tree):
    from video_knet_tpu_torch.utils.tree import ALIGN, tree_map

    leaves: list = []
    tree_map(lambda x: leaves.append(x) if torch.is_tensor(x) else None, tree)
    offsets, total = [], 0
    for x in leaves:
        offsets.append(total)
        total += -(-x.numel() * x.element_size() // ALIGN) * ALIGN
    host = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    slots = [host[o:o + x.numel() * x.element_size()].view(x.dtype).view(x.shape)
             for x, o in zip(leaves, offsets)]
    for x, slot in zip(leaves, slots):
        slot.copy_(x, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    ev.synchronize()
    arrays = iter([(s.float() if s.dtype == torch.bfloat16 else s).numpy().copy()
                   for s in slots])
    return tree_map(lambda x: next(arrays) if torch.is_tensor(x) else x, tree)


def fetch(reps: int) -> dict:
    from torch.profiler import ProfilerActivity

    from video_knet_tpu_torch.utils.tree import to_host

    ways = {"per_leaf": _per_leaf, "packed": to_host, "pinned": _pinned}
    out = {}
    img = _frames(1)[0]
    for path, pipe in _pipelines().items():
        payload = pipe._step(img, True)
        torch.cuda.synchronize()
        ref = _per_leaf(payload)
        for fn in ways.values():  # warm-up, and every way gives the same payload
            got = fn(payload)
            for a, b in zip(_leaves(ref), _leaves(got)):
                if not np.array_equal(a, b):
                    raise AssertionError(f"[{path}] a transfer changed the payload")
        ms: dict = {w: [] for w in ways}
        for _ in range(reps):
            for w, fn in ways.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(payload)
                ms[w].append((time.perf_counter() - t0) * 1e3)
        calls = {}
        for w, fn in ways.items():
            with torch.profiler.profile(
                    activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn(payload)
            names = [e.name for e in prof.events()]
            calls[w] = dict(
                launches=sum(n.startswith(("cudaLaunchKernel", "cuLaunchKernel")) for n in names),
                copies=sum(n in ("cudaMemcpyAsync", "cudaMemcpy") for n in names))
        nbytes = sum(a.nbytes for a in _leaves(ref))
        out[path] = dict(leaves=len(_leaves(ref)), host_bytes=nbytes,
                         **{w: dict(median_ms=statistics.median(v), **calls[w])
                            for w, v in ms.items()})
    return out


def _leaves(tree) -> list:
    from video_knet_tpu_torch.utils.tree import tree_map

    acc: list = []
    tree_map(lambda x: acc.append(x) if isinstance(x, np.ndarray) else None, tree)
    return acc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("fetch", "frames"))
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--frames", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("transfer_timing: no CUDA device available")
    set_fp32_numerics()
    report = fetch(args.reps) if args.mode == "fetch" else frames(args.frames)
    print(card_name_and_power())
    print(json.dumps({args.mode: report}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
