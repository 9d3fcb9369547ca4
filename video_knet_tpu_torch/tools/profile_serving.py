"""Where a serving frame's time goes, on one NVIDIA GPU.

    python3 -m video_knet_tpu_torch.tools.profile_serving [--frames 6] [--out DIR]

Serves random 384x1248 frames through VPSInferencePipeline (Video K-Net R-50,
`smoke_config()` and the seeded random weights of `smoke_model`, which
chip_smoke.py shares) and reports:
  - frame wall ms (host clock, the frame ends with its device->host copy);
  - from a torch.profiler trace: device busy ms a frame (union of kernel
    intervals), the device's idle share, kernel launches a frame, the top
    kernels by device time, the device ms a frame of the port's two CUDA
    kernels (K1 mask pool, K2 assemble), and the host<->device
    synchronisations;
  - per layer, host ms with a synchronize at each layer boundary (a second,
    separate pass; the boundaries serialize the frame, so the layer sum is a
    little above the frame time).
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
# most seeds' random weights put one stuff segment over the whole 384x1248
# frame; seed 6 keeps and tracks a few things there
WEIGHT_SEED = 6


def smoke_config():
    """Default VideoKNetConfig with the score gates at zero (as
    tests/test_serving_golden.py sets them), so random weights keep and
    track things."""
    from video_knet_tpu_torch.config import VideoKNetConfig

    base = VideoKNetConfig()
    return dataclasses.replace(
        base, test=dataclasses.replace(base.test, instance_score_thr=0.0),
        tracker=dataclasses.replace(base.tracker, init_score_thr=0.0, obj_score_thr=0.0,
                                    match_score_thr=0.05))


def smoke_model(cfg, device):
    """Video K-Net with the seeded random weights of the smoke runs."""
    from video_knet_tpu_torch.models.video.knet_vps import VideoKNet

    return VideoKNet(cfg, generator=torch.Generator().manual_seed(WEIGHT_SEED), device=device)


def _pipeline():
    from video_knet_tpu_torch.models.video.inference import VPSInferencePipeline

    cfg = smoke_config()
    model = smoke_model(cfg, "cuda")
    return model, VPSInferencePipeline(model, cfg, HW, device="cuda")


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


def profile(frames: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    model, pipe = _pipeline()
    rng = np.random.RandomState(0)
    imgs = [torch.from_numpy(rng.randn(1, *HW, 3).astype(np.float32)).cuda()
            for _ in range(frames + 2)]
    for i in range(2):  # warm-up (first frame carries one-time costs)
        pipe.run_frame(imgs[i], is_first=(i == 0))
    torch.cuda.synchronize()

    wall = []
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for img in imgs[2:]:
            t0 = time.perf_counter()
            pipe.run_frame(img, is_first=False)
            wall.append((time.perf_counter() - t0) * 1e3)
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
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

    layers = _layer_times(model, pipe, imgs[2:])
    wall_frame = statistics.median(wall)
    return dict(
        hw=list(HW), frames=frames,
        frame_ms=wall, frame_ms_median=wall_frame,
        device_busy_ms_per_frame=busy,
        device_idle_share=max(0.0, 1 - busy / (sum(wall) / frames)),
        kernel_launches_per_frame=len(launches) / frames,
        syncs_per_frame=len(syncs) / frames,
        memcpy_calls_per_frame=len(copies) / frames,
        top_kernels_ms_per_frame=[(k[:90], v / frames) for k, v in top],
        port_kernels=port,
        layer_ms_per_frame=layers,
    )


def _layer_times(model, pipe, imgs) -> dict:
    """Host ms per layer with a synchronize at each boundary."""
    from video_knet_tpu_torch.models.video import device_tracker as dt
    from video_knet_tpu_torch.models.video import inference

    acc: dict = {}

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            acc[name] = acc.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return wrapper

    patched = []
    for name in ("backbone", "neck", "rpn_head", "track_embed",
                 *[f"mask_head_{s}" for s in range(model.num_stages)]):
        m = getattr(model, name)
        patched.append((m, "forward", m.forward))
        m.forward = timed(name, m.forward)
    for mod, attr, label in ((inference, "vps_decode", "decode"),
                             (dt, "thing_detections_from_decode", "boxes"),
                             (dt, "tracker_match", "tracker"),
                             (pipe, "_finish_frame", "host_finish")):
        patched.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, timed(label, getattr(mod, attr)))
    try:
        t0 = time.perf_counter()
        for img in imgs:
            pipe.run_frame(img, is_first=False)
        total = (time.perf_counter() - t0) * 1e3
    finally:
        for obj, attr, orig in patched:
            if attr == "forward":
                del obj.forward  # back to the class method
            else:
                setattr(obj, attr, orig)
    out = {k: v / len(imgs) for k, v in acc.items()}
    out["frame_total"] = total / len(imgs)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--out", help="directory for profile_serving.json")
    args = ap.parse_args()
    from video_knet_tpu_torch.utils.device import card_name_and_power

    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: no CUDA device available")
    report = dict(card=card_name_and_power(), torch=torch.__version__, cuda=torch.version.cuda,
                  **profile(args.frames))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_serving.json"), "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({k: v for k, v in report.items() if k != "top_kernels_ms_per_frame"}))
    for name, ms in report["top_kernels_ms_per_frame"]:
        print(f"  {ms:8.3f} ms  {name}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
