"""Profiling and timing harness.

Counterpart of `video_knet_tpu/utils/profiling.py`:
- `trace(logdir)`: a `torch.profiler` capture of the host and the card,
  written into `logdir` as a Chrome trace (`trace.json`, which Perfetto
  and chrome://tracing open);
- `span(name)`: the program's own spans (`SPANS`), `record_function`
  events on the profiler's clock while a profiler records this thread, a
  shared null context otherwise;
- `benchmark(fn, *args)`: the first call's seconds apart (the port has no
  compile step; the first call builds the kernels and warms the caches),
  then steady-state seconds a call, each call waited for on the devices of
  `fn`'s outputs (JAX's `block_until_ready`);
- `device_memory_stats()`: `torch.cuda.memory_stats` of every visible card.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass

import torch

TRACE_FILE = "trace.json"

# every span the program opens, by layer: the model, the serving pipeline
# (all on the thread that drives it), the train step
SPANS = (
    "vk.model.backbone_neck",  # VideoKNet.extract_feat
    "vk.model.init_head",  # the init (RPN) head
    "vk.model.stage",  # one kernel-update stage
    "vk.serve.h2d",  # a frame or round's host-to-device copy
    "vk.serve.decode",  # panoptic decode, semantic filter, payload casts
    "vk.serve.track",  # the device tracker: detections, reset, association
    "vk.serve.round",  # one round's enqueue in the serving loop
    "vk.serve.pack",  # stack, pack and the enqueued device-to-host copy
    "vk.serve.wait_input",  # the serving loop pulling its next round
    "vk.serve.wait_result",  # the serving loop blocked on a drain
    "vk.train.step",
    "vk.train.forward",
    "vk.train.loss",  # the loss block, `assign` inside it
    "vk.train.assign",  # the assignment costs and the one Hungarian solve
    "vk.train.backward",  # its kernels launch on autograd's device thread
    "vk.train.optimizer",  # zero fills, per-group clip, AdamW, schedule
)
_OFF = contextlib.nullcontext()


def span(name: str):
    """`with span(name):` records a `name` span while a profiler records
    this thread, and costs one check otherwise (`record_function` itself
    costs about ten times that with no profiler on). No span stays open
    across a `yield`, and none opens on a worker thread: a profiler
    records neither."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def trace(logdir: str):
    """`with trace(dir): step()` captures CPU and CUDA activity and writes
    `dir/trace.json` when the block ends."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


@dataclass
class BenchResult:
    compile_s: float
    mean_s: float
    p50_s: float
    p99_s: float
    iters: int

    @property
    def per_sec(self) -> float:
        return 1.0 / self.mean_s if self.mean_s > 0 else float("inf")


def _tensors(out):
    if torch.is_tensor(out):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _tensors(v)


def block_until_ready(out):
    """Wait for every CUDA device that holds a tensor of `out` (any nesting
    of tuples, lists, dicts and NamedTuples); returns `out`."""
    for d in {t.device for t in _tensors(out) if t.device.type == "cuda"}:
        torch.cuda.synchronize(d)
    return out


def benchmark(fn, *args, warmup: int = 3, iters: int = 20) -> BenchResult:
    """Time `fn(*args)`: the first call apart (`compile_s`), `warmup - 1`
    more untimed, then `iters` timed calls."""
    t0 = time.perf_counter()
    block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t0
    for _ in range(max(warmup - 1, 0)):
        block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return BenchResult(
        compile_s=compile_s,
        mean_s=sum(times) / len(times),
        p50_s=times[len(times) // 2],
        p99_s=times[min(int(len(times) * 0.99), len(times) - 1)],
        iters=iters,
    )


def device_memory_stats() -> dict:
    """{"cuda:i (name)": torch.cuda.memory_stats(i)} for every visible card
    (empty without one)."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i} ({torch.cuda.get_device_name(i)})": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}
