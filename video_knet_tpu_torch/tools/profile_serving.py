"""Where a serving frame's time goes, on one NVIDIA GPU.

    python3 -m video_knet_tpu_torch.tools.profile_serving [--frames 6]
        [--paths device,host,full,streams,mit,swin] [--out DIR]

Serves random frames through one serving path after another (Video K-Net
with `smoke_config()` and the seeded random weights of `smoke_model`, which
chip_smoke.py shares), at 384x1248 but for `swin`:
  device   R-50, VPSInferencePipeline, the tracker on the device (default)
  host     R-50, `quasi_dense_host` (the numpy tracker, compact payload)
  full     R-50, fast_decode=False (decode at 384x1248, host tracker)
  streams  R-50, MultiStreamVPSPipeline with two streams (one step a round)
  mit      MiT-b0 with the default heads, the tracker on the device
  swin     Swin-B VPS on VIP-Seg (`video_knet_vipseg_swin_b`) at 736x1280,
           the tracker on the device
and reports for each:
  - frame wall ms (host clock, the frame ends with its device->host copy; a
    round of two frames for `streams`);
  - from a torch.profiler trace: device busy ms a frame (union of kernel
    intervals), the device's idle share, kernel launches a frame, the top
    kernels by device time, the device ms a frame of the port's two CUDA
    kernels (K1 mask pool, K2 assemble), the host<->device
    synchronisations, and the device ms a frame of the work launched inside
    each of the program's spans (`utils/profiling.py:SPANS`), from the same
    pass.
With --out, also writes the full report as JSON to DIR/profile_serving.json.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import time

import numpy as np
import torch

HW = (384, 1248)
SWIN_HW = (736, 1280)  # VIP-Seg frames
# most seeds' random weights put one stuff segment over the whole 384x1248
# frame; seed 6 keeps and tracks a few things there
WEIGHT_SEED = 6


def smoke_config(base=None):
    """`base` (default: the default VideoKNetConfig) with the score gates at
    zero (as tests/test_serving_golden.py sets them), so random weights keep
    and track things."""
    from video_knet_tpu_torch.config import VideoKNetConfig

    base = VideoKNetConfig() if base is None else base
    return dataclasses.replace(
        base, test=dataclasses.replace(base.test, instance_score_thr=0.0),
        tracker=dataclasses.replace(base.tracker, init_score_thr=0.0, obj_score_thr=0.0,
                                    match_score_thr=0.05))


def smoke_model(cfg, device):
    """Video K-Net with the seeded random weights of the smoke runs."""
    from video_knet_tpu_torch.models.video.knet_vps import VideoKNet

    return VideoKNet(cfg, generator=torch.Generator().manual_seed(WEIGHT_SEED), device=device)


PATHS = ("device", "host", "full", "streams", "mit", "swin")


def _serving_path(path: str):
    """(serve(img, is_first), frames a call, frame size)."""
    from video_knet_tpu_torch.configs import get_config
    from video_knet_tpu_torch.models.video.inference import (
        MultiStreamVPSPipeline,
        VPSInferencePipeline,
    )

    if path == "swin":
        cfg = smoke_config(get_config("video_knet_vipseg_swin_b"))
        model = smoke_model(cfg, "cuda")
        pipe = VPSInferencePipeline(model, cfg, SWIN_HW, thing_ids_in_orig=None,
                                    device="cuda")
        return lambda img, first: pipe.run_frame(img, is_first=first), 1, SWIN_HW
    cfg = smoke_config()
    if path == "mit":
        cfg = dataclasses.replace(cfg, backbone="mit_b0")
    elif path == "full":
        cfg = dataclasses.replace(cfg, test=dataclasses.replace(cfg.test, fast_decode=False))
    model = smoke_model(cfg, "cuda")
    if path == "streams":
        ms = MultiStreamVPSPipeline(model, cfg, HW, 2, device="cuda")
        return lambda img, first: ms.run_frames(img, [first, first]), 2, HW
    tracker = "quasi_dense_host" if path == "host" else "quasi_dense"
    pipe = VPSInferencePipeline(model, cfg, HW, tracker_type=tracker, device="cuda")
    return lambda img, first: pipe.run_frame(img, is_first=first), 1, HW


def _busy_ms(events) -> float:
    """Union of device kernel / copy intervals (ms)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3  # us -> ms


def profile(frames: int, path: str = "device") -> dict:
    """The report of one serving path over `frames` profiled calls (frames,
    or rounds of two frames for `streams`); the numbers a frame are a call's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    serve, per_call, hw = _serving_path(path)
    rng = np.random.RandomState(0)
    imgs = [torch.from_numpy(rng.randn(per_call, *hw, 3).astype(np.float32)).cuda()
            for _ in range(frames + 2)]
    for i in range(2):  # warm-up (first frame carries one-time costs)
        serve(imgs[i], i == 0)
    torch.cuda.synchronize()

    wall = []
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for img in imgs[2:]:
            t0 = time.perf_counter()
            serve(img, False)
            wall.append((time.perf_counter() - t0) * 1e3)
    events = prof.events()
    host = [e for e in events if e.device_type == DeviceType.CPU]
    # a span's device-side annotation carries the span's name and is no work
    names = {e.name for e in host}
    dev = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in names]
    launches = [e for e in events if e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                                "cuLaunchKernel", "cuLaunchKernelEx")]
    syncs = [e for e in events if e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                                             "cudaEventSynchronize")]
    copies = [e for e in events if e.name in ("cudaMemcpyAsync", "cudaMemcpy")]
    busy = _busy_ms(dev) / frames
    by_kernel: dict = {}
    for e in dev:
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]
    # the port's own kernels: K1's three launches overlap (programmatic
    # dependent launch), so a call's device time is the union of their spans
    port = {}
    for name, key in (("mask_pool", "mask_pool_"), ("assemble", "assemble_kernel")):
        evs = [e for e in dev if key in e.name]
        port[name] = dict(device_ms_per_frame=_busy_ms(evs) / frames,
                          kernel_launches_per_frame=len(evs) / frames)

    wall_frame = statistics.median(wall)
    return dict(
        path=path, hw=list(hw), frames=frames, frames_per_call=per_call,
        frame_ms=wall, frame_ms_median=wall_frame,
        device_busy_ms_per_frame=busy,
        device_idle_share=max(0.0, 1 - busy / (sum(wall) / frames)),
        kernel_launches_per_frame=len(launches) / frames,
        syncs_per_frame=len(syncs) / frames,
        memcpy_calls_per_frame=len(copies) / frames,
        top_kernels_ms_per_frame=[(k[:90], v / frames) for k, v in top],
        port_kernels=port,
        span_ms_per_frame=_span_ms(host, dev, frames),
    )


def _span_ms(host, dev, frames: int) -> dict:
    """{span: device ms a frame of the kernels and copies whose runtime call
    was made inside it, on the thread that opened it} for each program span
    in the trace; a call is tied to its device work by the correlation id."""
    from video_knet_tpu_torch.utils.profiling import SPANS

    work: dict = {}
    for e in dev:
        work[e.id] = work.get(e.id, 0.0) + e.time_range.elapsed_us() / 1e3
    calls = [e for e in host if e.id in work and e.name.startswith("cu")]
    out = {}
    for name in SPANS:
        opened = [(e.thread, e.time_range.start, e.time_range.end) for e in host
                  if e.name == name]
        if opened:
            out[name] = sum(work[c.id] for c in calls if any(
                th == c.thread and s <= c.time_range.start <= end
                for th, s, end in opened)) / frames
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--paths", default="device",
                    help=f"comma-separated serving paths, of {','.join(PATHS)}")
    ap.add_argument("--out", help="directory for profile_serving.json")
    args = ap.parse_args()
    from video_knet_tpu_torch.utils.device import card_name_and_power, set_fp32_numerics

    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: no CUDA device available")
    paths = args.paths.split(",")
    unknown = sorted(set(paths) - set(PATHS))
    if unknown:
        raise SystemExit(f"profile_serving: unknown paths {unknown}")
    set_fp32_numerics()
    report = dict(card=card_name_and_power(), torch=torch.__version__, cuda=torch.version.cuda,
                  paths={p: profile(args.frames, p) for p in paths})
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_serving.json"), "w") as f:
            json.dump(report, f, indent=1)
    print(report["card"])
    for rep in report["paths"].values():
        print(json.dumps({k: v for k, v in rep.items() if k != "top_kernels_ms_per_frame"}))
        for name, ms in rep["top_kernels_ms_per_frame"]:
            print(f"  {ms:8.3f} ms  {name}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
