"""Device time of the port's CUDA kernels, on one NVIDIA GPU.

    python3 -m video_knet_tpu_torch.tools.kernel_timing [--splits 15,30,60] [--out DIR]
    python3 -m video_knet_tpu_torch.tools.kernel_timing --build

`device_ms` and `call_ms` are the timers chip_smoke.py uses. As a script,
this takes the serving stage shape (N=117 kernels, 48x156 features, C=256)
and prints, for K1 (mask pool) and K2 (assemble), the device time of one
wrapper call and its split by kernel (torch.profiler; K1's three kernels are
chained by programmatic dependent launch, so each one's span includes its
wait for the one before); then K1's device time
at each HW split count given with --splits (the wrapper's own choice marked
with *). Then K2's device time against C (8 slabs of 32 channels at
C=256) and against its number of blocks (HW tiles of 64), beside
`torch.matmul` on the same inputs: how the time splits into a fixed part
and a part per slab, and whether it depends on how many blocks share the
card. With --out, the report also goes to DIR/kernel_timing.json.

--build times only the kernel library's build from scratch, in turns: one
nvcc over all sources (serial) and `build.py`'s way (one nvcc a source, all
started together, then a link), each into a fresh directory.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import tempfile
import time

import torch

GRAPH_CALLS = 20  # calls a CUDA graph holds when device time is taken
STAGE_SHAPE = (117, 48, 156, 256)  # (N, H, W, C) of the three update stages


def call_ms(fn, warmup: int = 10, iters: int = 60) -> float:
    """Median over `iters` calls of CUDA-event time around the Python call,
    after warm-up. The start event runs at once, so this includes the host's
    dispatch of the call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, replays: int = 30) -> float:
    """Device time of one call: GRAPH_CALLS back-to-back calls captured into
    one CUDA graph; the median over `replays` of one replay's CUDA-event time,
    divided by GRAPH_CALLS. No host dispatch is inside the events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    for _ in range(3):
        graph.replay()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / GRAPH_CALLS)
    del graph
    return statistics.median(times)


def kernel_breakdown(fn, calls: int = GRAPH_CALLS) -> dict:
    """Device ms a call of each kernel that `fn` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").split("(")[0][:60]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    return out


def stage_inputs(device, seed: int = 0):
    """Logits (kept 1e-6 away from 0), features and kernels at STAGE_SHAPE."""
    n, h, w, c = STAGE_SHAPE
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((1, n, h, w), generator=gen, device=device)
    logits = torch.where(x >= 0, x.clamp(min=1e-6), x.clamp(max=-1e-6))
    feats = torch.randn((1, h, w, c), generator=gen, device=device)
    kern = torch.randn((1, n, c), generator=gen, device=device) / c ** 0.5
    return logits, feats, kern


def assemble_sweep(device, seed: int = 1) -> list:
    """K2 and torch.matmul device us at N=117 for C in 32..512 (HW=7488)
    and for HW of 1 to 117 blocks of 64 (C=256)."""
    from video_knet_tpu_torch.ops.kernels import mask_ops as mo

    n, h, w, c_stage = STAGE_SHAPE
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = []
    for hw, c in [(h * w, c) for c in (32, 64, 128, 256, 512)] + [
            (hw, c_stage) for hw in (64, 640, 2560)]:
        feats = torch.randn((1, 1, hw, c), generator=gen, device=device)
        kern = torch.randn((1, n, c), generator=gen, device=device) / c ** 0.5
        rec = dict(hw=hw, c=c, blocks=math.ceil(hw / 64),
                   us=device_ms(lambda: mo.fused_assemble(kern, feats)) * 1e3,
                   matmul_us=device_ms(
                       lambda: torch.matmul(kern, feats.reshape(1, hw, c).transpose(1, 2))) * 1e3)
        rows.append(rec)
        print(f"  K2 HW {hw:5d} ({rec['blocks']:3d} blocks) C {c:3d}: {rec['us']:7.2f} us, "
              f"torch.matmul {rec['matmul_us']:7.2f} us", flush=True)
    return rows


def build_seconds() -> dict:
    """Seconds to build the library from scratch: serial, parallel, parallel,
    serial."""
    from video_knet_tpu_torch.ops.kernels import build

    out: dict = {"serial": [], "parallel": []}
    own = build.BUILD_DIR
    try:
        for way in ("serial", "parallel", "parallel", "serial"):
            with tempfile.TemporaryDirectory() as tmp:
                t0 = time.perf_counter()
                if way == "serial":
                    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
                                    os.path.join(tmp, "lib.so"), *build.SOURCES],
                                   check=True, capture_output=True)
                else:
                    build.BUILD_DIR, build._lib = tmp, None
                    build.load_library()
                out[way].append(time.perf_counter() - t0)
    finally:
        build.BUILD_DIR, build._lib = own, None
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--splits", default="", help="comma-separated K1 HW split counts")
    ap.add_argument("--out", help="directory for kernel_timing.json")
    ap.add_argument("--build", action="store_true", help="time the library's build only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_timing: no CUDA device available")
    if args.build:
        from video_knet_tpu_torch.utils.device import card_name_and_power

        print(json.dumps({"build_seconds": build_seconds(), "card": card_name_and_power(),
                          "cpus": os.cpu_count()}))
        return 0
    from video_knet_tpu_torch.ops.kernels import mask_ops as mo
    from video_knet_tpu_torch.ops.kernels.build import load_library
    from video_knet_tpu_torch.utils.device import card_name_and_power, set_fp32_numerics

    set_fp32_numerics()
    device = torch.device("cuda")
    lib = load_library()
    logits, feats, kern = stage_inputs(device)
    report: dict = dict(card=card_name_and_power(), shape=STAGE_SHAPE)
    for name, fn in (("mask_pool", lambda: mo.fused_mask_pool(logits, feats)),
                     ("assemble", lambda: mo.fused_assemble(kern, feats))):
        report[name] = dict(device_ms=device_ms(fn), kernels_ms=kernel_breakdown(fn))
        print(f"{name}: {report[name]['device_ms'] * 1e3:.2f} us device; by kernel (us): "
              + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in report[name]["kernels_ms"].items()),
              flush=True)

    want = mo.mask_pool_plain(logits, feats)
    own = mo.mask_pool_splits
    n, h, w, c = STAGE_SHAPE
    sweep = []
    try:
        for s in [int(v) for v in args.splits.split(",") if v]:
            def forced(b, nn, hw, cc, sm, lib, s=s):
                bk = lib.vk_mask_pool_block_hw()
                chunk = math.ceil(math.ceil(hw / s) / bk) * bk
                return math.ceil(hw / chunk), chunk

            mo.mask_pool_splits = forced
            err = float((mo.fused_mask_pool(logits, feats) - want).abs().max())
            fn = lambda: mo.fused_mask_pool(logits, feats)  # noqa: E731
            rec = dict(splits=forced(1, n, h * w, c, 0, lib)[0], device_ms=device_ms(fn),
                       kernels_ms=kernel_breakdown(fn), max_abs_err=err)
            sweep.append(rec)
    finally:
        mo.mask_pool_splits = own
    if sweep:
        default = own(1, n, h * w, c, mo._max_blocks(device, lib), lib)[0]
        for rec in sweep:
            mark = "*" if rec["splits"] == default else " "
            print(f"  K1 splits {rec['splits']:4d}{mark} {rec['device_ms'] * 1e3:8.2f} us  "
                  f"err {rec['max_abs_err']:.2e}  "
                  + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in rec["kernels_ms"].items()))
        report["mask_pool_splits"] = sweep
    report["assemble_sweep"] = assemble_sweep(device)
    print(report["card"])
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "kernel_timing.json"), "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
