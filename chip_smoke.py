#!/usr/bin/env python3
"""Drive the PyTorch port (`video_knet_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (the process then exits non-zero):
  1. device   the card's name and power limit, torch / CUDA versions
  2. build    nvcc builds the CUDA kernels from ops/kernels/csrc
  3. kernels  each kernel against its plain PyTorch version at the serving
              shapes and at ragged shapes; device time (a CUDA graph of 20
              calls, timed with CUDA events) of the kernel, the plain version
              and one PyTorch library call, and the kernel's host-inclusive
              call time
  4. serve    Video K-Net R-50 (default config, seeded random weights)
              serves 10 frames of 384x1248 through VPSInferencePipeline on
              the card; each kernel must launch 4 times a frame
  5. check    the same weights on a 64x96 sequence, card against CPU
Prints the kernels JSON line, the card line, and as the last line
{"ok": true, "device": {...}}. Exits non-zero without a result when no
CUDA device is available.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak
FP32_FLOP_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
SERVE_HW = (384, 1248)
SERVE_FRAMES = 10
CHECK_HW = (64, 96)
CHECK_FRAMES = 4
SEED = 0  # kernel inputs and frames (weights: profile_serving.WEIGHT_SEED)
# max abs error allowed against the plain version on the same card:
# K1 sums ~HW/2 unit-normal features per output (|out| up to a few hundred)
# in another order; K2 dots C=256 terms scaled to O(1) outputs.
TOL_MASK_POOL = 5e-3
TOL_ASSEMBLE = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_build() -> float:
    from video_knet_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    build.load_library()
    secs = time.perf_counter() - t0
    log(f"[build] kernels built and loaded in {secs:.2f} s (nvcc {build.build_seconds:.2f} s)")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build]   {line.strip()}")
    return secs


def _logits(gen, shape, device):
    """Random logits kept at least 1e-6 away from 0 (strict comparison)."""
    x = torch.randn(shape, generator=gen, device=device)
    return torch.where(x >= 0, x.clamp(min=1e-6), x.clamp(max=-1e-6))


def phase_kernels(device) -> list[dict]:
    from video_knet_tpu_torch.ops.kernels import mask_ops as mo
    from video_knet_tpu_torch.tools.kernel_timing import call_ms, device_ms

    gen = torch.Generator(device=device).manual_seed(SEED)
    h, w = SERVE_HW[0] // 8, SERVE_HW[1] // 8
    # (N, H, W, C): the serving shapes (stages N=117, init head N=100) and
    # ragged ones (HW and C multiples of no tile)
    shapes = [(117, h, w, 256), (100, h, w, 256), (100, 37, 61, 256), (100, 37, 61, 200)]
    err_pool, err_asm = 0.0, 0.0
    for n, hh, ww, c in shapes:
        logits = _logits(gen, (1, n, hh, ww), device)
        feats = torch.randn((1, hh, ww, c), generator=gen, device=device)
        kern = torch.randn((1, n, c), generator=gen, device=device) / c ** 0.5
        e = (mo.fused_mask_pool(logits, feats) - mo.mask_pool_plain(logits, feats)).abs().max()
        err_pool = max(err_pool, float(e))
        for sig in (False, True):
            e = (mo.fused_assemble(kern, feats, sigmoid=sig)
                 - mo.assemble_plain(kern, feats, sigmoid=sig)).abs().max()
            err_asm = max(err_asm, float(e))
        log(f"[kernels] N={n} HW={hh}x{ww} C={c}: mask_pool err {err_pool:.3e}, "
            f"assemble err {err_asm:.3e} (sigmoid off and on)")
    # tie case: a logit of exactly 0 has sigmoid 0.5, which is not > 0.5
    logits = _logits(gen, (1, 100, 37, 61), device)
    logits[:, :10] = 0.0
    logits[:, 10, 5, 7] = 0.0
    feats = torch.randn((1, 37, 61, 256), generator=gen, device=device)
    got = mo.fused_mask_pool(logits, feats)
    ref = mo.mask_pool_plain(logits, feats)
    if bool(got[:, :10].ne(0).any()):
        raise AssertionError("mask_pool pooled pixels whose logit is exactly 0")
    err_pool = max(err_pool, float((got - ref).abs().max()))
    torch.cuda.synchronize()
    log(f"[kernels] mask_pool max abs err {err_pool:.3e} (tol {TOL_MASK_POOL}); "
        f"assemble max abs err {err_asm:.3e} (tol {TOL_ASSEMBLE})")
    if not err_pool <= TOL_MASK_POOL:
        raise AssertionError(f"mask_pool disagrees with its plain version: {err_pool}")
    if not err_asm <= TOL_ASSEMBLE:
        raise AssertionError(f"assemble disagrees with its plain version: {err_asm}")

    # timings at the stage shape (3 of the 4 launches a frame)
    n, c = 117, 256
    logits = _logits(gen, (1, n, h, w), device)
    feats = torch.randn((1, h, w, c), generator=gen, device=device)
    kern = torch.randn((1, n, c), generator=gen, device=device) / c ** 0.5
    hard = (torch.sigmoid(logits) > 0.5).float().reshape(1, n, h * w)
    f2 = feats.reshape(1, h * w, c)
    nnz = int(hard.sum())
    io_bytes = 4 * (n * h * w + h * w * c + n * c)  # both kernels: same sizes
    recs = []
    for name, fn, plain, lib, flops, err, src_line in (
        ("mask_pool", lambda: mo.fused_mask_pool(logits, feats),
         lambda: mo.mask_pool_plain(logits, feats), lambda: torch.matmul(hard, f2),
         2 * nnz * c, err_pool, "video_knet_tpu/ops/pallas/mask_ops.py:110"),
        ("assemble", lambda: mo.fused_assemble(kern, feats),
         lambda: mo.assemble_plain(kern, feats), lambda: torch.matmul(kern, f2.transpose(1, 2)),
         2 * n * h * w * c, err_asm, "video_knet_tpu/ops/pallas/mask_ops.py:168"),
    ):
        t_bytes, t_ops = io_bytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
        ms = device_ms(fn)
        rec = dict(
            name=name, route="cuda",
            source="video_knet_tpu_torch/ops/kernels/csrc/mask_ops.cu",
            replaces=src_line, launches=0, max_abs_err=err,
            ms=ms, call_ms=call_ms(fn), plain_ms=device_ms(plain),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=device_ms(lib),
        )
        if name == "assemble":
            rec["ms_sigmoid"] = device_ms(lambda: mo.fused_assemble(kern, feats, sigmoid=True))
        log(f"[kernels] {name}: device {ms * 1e3:.2f} us (call {rec['call_ms'] * 1e3:.1f} us), "
            f"plain {rec['plain_ms'] * 1e3:.2f} us, library {rec['library_ms'] * 1e3:.2f} us, "
            f"bound {rec['bound_ms'] * 1e3:.2f} us ({rec['bound_by']}; {io_bytes / 1e6:.2f} MB, "
            f"{flops / 1e9:.3f} GFLOP)")
        recs.append(rec)
    return recs


def _frames(hw, count):
    rng = np.random.RandomState(SEED)
    return [rng.randn(1, *hw, 3).astype(np.float32) for _ in range(count)]


def phase_serve(device) -> dict:
    from video_knet_tpu_torch.models.video.inference import VPSInferencePipeline
    from video_knet_tpu_torch.ops.kernels import mask_ops as mo
    from video_knet_tpu_torch.tools.profile_serving import smoke_config, smoke_model

    cfg = smoke_config()
    model = smoke_model(cfg, device)
    pipe = VPSInferencePipeline(model, cfg, SERVE_HW, device=device)
    frames = [torch.from_numpy(f).to(device) for f in _frames(SERVE_HW, SERVE_FRAMES)]
    torch.cuda.synchronize()
    mo.reset_launch_counts()
    results, frame_ms = [], []
    for i, img in enumerate(frames):
        t0 = time.perf_counter()
        results.append(pipe.run_frame(img, is_first=(i == 0)))
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(mo.LAUNCHES)
    for r in results:
        if r.panoptic_seg.shape != SERVE_HW or r.track_map.shape != SERVE_HW \
                or r.semantic_map.shape != SERVE_HW:
            raise AssertionError("output maps have the wrong shape")
        if not all(np.isfinite(s.get("score", 0.0)) for s in r.segments_info):
            raise AssertionError("non-finite segment score")
    if not torch.isfinite(pipe.prev_obj_feats).all() or \
            not torch.isfinite(pipe.track_state.embeds).all():
        raise AssertionError("non-finite carried state")
    if not any((r.track_map > 0).any() for r in results):
        raise AssertionError("no frame has a nonzero track id")
    for name in ("mask_pool", "assemble"):
        if launches[name] != 4 * SERVE_FRAMES:
            raise AssertionError(f"{name} launched {launches[name]} times in "
                                 f"{SERVE_FRAMES} frames, expected 4 a frame")
    med = statistics.median(frame_ms[1:])
    n_things = [sum(s["isthing"] for s in r.segments_info) for r in results]
    n_tracks = [len(np.unique(r.track_map[r.track_map > 0])) for r in results]
    log(f"[serve] {SERVE_FRAMES} frames of {SERVE_HW[0]}x{SERVE_HW[1]}: median frame "
        f"{med:.2f} ms over frames 1..{SERVE_FRAMES - 1} (first {frame_ms[0]:.1f} ms); "
        f"things per frame {n_things}; track ids per frame {n_tracks}; launches {launches}")
    log(f"[serve] frame ms {[round(t, 3) for t in frame_ms]}")
    return dict(launches=launches, frame_ms_median=med)


def phase_check(device) -> None:
    """The port on the card against the port on the CPU (whose agreement with
    the JAX package the CPU tests hold), same weights, 64x96 frames."""
    from video_knet_tpu_torch.models.video.inference import VPSInferencePipeline
    from video_knet_tpu_torch.tools.profile_serving import smoke_config, smoke_model

    cfg = smoke_config()
    runs = {}
    for dev in (device, torch.device("cpu")):
        model = smoke_model(cfg, dev)
        pipe = VPSInferencePipeline(model, cfg, CHECK_HW, device=dev)
        frames = _frames(CHECK_HW, CHECK_FRAMES)
        with torch.inference_mode():
            out = model.test_step(torch.from_numpy(frames[0]).to(dev),
                                  pipe.prev_obj_feats, True)
        last = out["stage_outs"][-1]
        runs[dev.type] = dict(
            cls=last.cls_score.cpu(), masks=last.mask_preds.cpu(),
            res=[pipe.run_frame(f, is_first=(i == 0)) for i, f in enumerate(frames)])
    g, c = runs["cuda"], runs["cpu"]
    for key in ("cls", "masks"):
        rel = float((g[key] - c[key]).abs().max() / c[key].abs().max())
        log(f"[check] last-stage {key}: max abs diff / max abs = {rel:.3e} (limit 1e-3)")
        if not rel <= 1e-3:
            raise AssertionError(f"card and CPU disagree on {key}: {rel}")
    for t, (rg, rc) in enumerate(zip(g["res"], c["res"])):
        agree = {k: float(np.mean(getattr(rg, k) == getattr(rc, k)))
                 for k in ("panoptic_seg", "semantic_map", "track_map")}
        log(f"[check] frame {t}: pixel agreement card vs CPU {agree} (limit 0.98)")
        if min(agree.values()) < 0.98:
            raise AssertionError(f"frame {t}: card and CPU id maps disagree: {agree}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import video_knet_tpu_torch  # noqa: F401  (fails outside a checkout)
    from video_knet_tpu_torch.utils.device import card_name_and_power, set_fp32_numerics

    set_fp32_numerics()
    device = torch.device("cuda")
    card = card_name_and_power()
    log(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    phase_build()
    kernels = phase_kernels(device)
    serve = phase_serve(device)
    for rec in kernels:
        rec["launches"] = serve["launches"][rec["name"]]
    phase_check(device)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
