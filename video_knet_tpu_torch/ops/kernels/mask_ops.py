"""The two mask contractions of the serving path: CUDA kernels, plain versions,
launch counters.

- `fused_mask_pool` replaces `video_knet_tpu/ops/pallas/mask_ops.py:fused_mask_pool`:
  out[b,n,c] = sum_hw [sigmoid(logit[b,n,hw]) > thr] * feat[b,hw,c].
- `fused_assemble` replaces `video_knet_tpu/ops/pallas/mask_ops.py:fused_assemble_sigmoid`:
  out[b,n,hw] = kern[b,n,:] . feat[b,hw,:], with an optional sigmoid epilogue.

Each wrapper takes its plain PyTorch version for tensors on the CPU (the CPU
tests) and, for CUDA tensors, launches its kernel (`csrc/mask_ops.cu`) or
raises: there is no fallback. `LAUNCHES` counts the kernel launches, one per
wrapper call that launched (a K1 call is three chained kernels: binarize,
partial sums on the tensor cores, ordered reduce).
"""

from __future__ import annotations

import math

import torch

LAUNCHES = {"mask_pool": 0, "assemble": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------ plain versions


def mask_pool_plain(mask_logits: torch.Tensor, feats: torch.Tensor,
                    hard_thr: float = 0.5) -> torch.Tensor:
    """[B, N, H, W] logits, [B, H, W, C] feats -> [B, N, C]."""
    hard = (torch.sigmoid(mask_logits.float()) > hard_thr).to(feats.dtype)
    return torch.einsum("bnhw,bhwc->bnc", hard, feats)


def assemble_plain(kernels: torch.Tensor, feats: torch.Tensor,
                   sigmoid: bool = False) -> torch.Tensor:
    """[B, N, C] kernels, [B, H, W, C] feats -> [B, N, H, W]."""
    out = torch.einsum("bnc,bhwc->bnhw", kernels, feats)
    return torch.sigmoid(out) if sigmoid else out


# ------------------------------------------------------------------ wrappers


def _on_cpu(*ts: torch.Tensor) -> bool:
    devices = {t.device.type for t in ts}
    if devices == {"cpu"}:
        return True
    if devices != {"cuda"} or len({t.device for t in ts}) != 1:
        raise ValueError(f"inputs on mixed or unsupported devices: {[t.device for t in ts]}")
    return False


def _check(name: str, t: torch.Tensor, ndim: int) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: float32 required, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {ndim}-D tensor required, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: contiguous tensor required")


def _raise_on(rc: int, fn: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with error {rc}")


_MAX_BLOCKS: dict = {}


def _max_blocks(device: torch.device, lib) -> int:
    """Blocks of K1's partial kernel that fit on the card at once (one wave)."""
    if device not in _MAX_BLOCKS:
        blocks = lib.vk_mask_pool_max_blocks()
        if blocks <= 0:
            raise RuntimeError(f"vk_mask_pool_max_blocks: CUDA error {-blocks}")
        _MAX_BLOCKS[device] = blocks
    return _MAX_BLOCKS[device]


def mask_pool_splits(b: int, n: int, hw: int, c: int, max_blocks: int, lib) -> tuple[int, int]:
    """(splits, chunk): HW split across blocks so the grid is one wave of
    `max_blocks`; each split writes one [B, N, C] partial.

    Deterministic in the shapes and the card, so the split-order reduction
    gives the same bits on every call."""
    bk = lib.vk_mask_pool_block_hw()
    base = b * math.ceil(n / lib.vk_mask_pool_block_rows()) * math.ceil(
        c / lib.vk_mask_pool_block_cols())
    splits = max(1, min(max_blocks // base, math.ceil(hw / bk)))
    chunk = math.ceil(math.ceil(hw / splits) / bk) * bk
    return math.ceil(hw / chunk), chunk


def split_bf16x3(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """fp32 -> (hi, mid, lo) bf16 with hi + mid + lo == x exactly, as K1 splits
    its features for the bf16 tensor cores: 3 x 8 significand bits cover
    fp32's 24, and bf16 has fp32's exponent range."""
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def fused_mask_pool(mask_logits: torch.Tensor, feats: torch.Tensor, *,
                    hard_thr: float = 0.5) -> torch.Tensor:
    """Binarized mask pooling. mask_logits [B, N, H, W]; feats [B, H, W, C]
    -> [B, N, C] float32."""
    if _on_cpu(mask_logits, feats):
        return mask_pool_plain(mask_logits, feats, hard_thr)
    from video_knet_tpu_torch.ops.kernels.build import load_library

    _check("mask_logits", mask_logits, 4)
    _check("feats", feats, 4)
    b, n, h, w = mask_logits.shape
    c = feats.shape[-1]
    if tuple(feats.shape[:3]) != (b, h, w):
        raise ValueError(f"shape mismatch: {tuple(mask_logits.shape)} vs {tuple(feats.shape)}")
    out = torch.empty((b, n, c), dtype=torch.float32, device=feats.device)
    if out.numel() == 0 or h * w == 0:
        return out.zero_()
    lib = load_library()
    with torch.cuda.device(feats.device):
        splits, chunk = mask_pool_splits(b, n, h * w, c, _max_blocks(feats.device, lib), lib)
        rows = lib.vk_mask_pool_block_rows()
        bits = torch.empty((b, math.ceil(h * w / 32), math.ceil(n / rows) * rows),
                           dtype=torch.int32, device=feats.device)
        scratch = torch.empty((splits, b, n, c), dtype=torch.float32,
                              device=feats.device) if splits > 1 else out
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.vk_mask_pool(mask_logits.data_ptr(), feats.data_ptr(), bits.data_ptr(),
                              scratch.data_ptr(), out.data_ptr(), b, n, h * w, c,
                              float(hard_thr), splits, chunk, stream)
    _raise_on(rc, "vk_mask_pool")
    LAUNCHES["mask_pool"] += 1
    return out


def fused_assemble(kernels: torch.Tensor, feats: torch.Tensor, *,
                   sigmoid: bool = False) -> torch.Tensor:
    """K=1 dynamic conv. kernels [B, N, C]; feats [B, H, W, C] -> [B, N, H, W]
    float32 logits, or probabilities with `sigmoid`."""
    if _on_cpu(kernels, feats):
        return assemble_plain(kernels, feats, sigmoid)
    from video_knet_tpu_torch.ops.kernels.build import load_library

    _check("kernels", kernels, 3)
    _check("feats", feats, 4)
    b, n, c = kernels.shape
    h, w = feats.shape[1:3]
    if feats.shape[0] != b or feats.shape[-1] != c:
        raise ValueError(f"shape mismatch: {tuple(kernels.shape)} vs {tuple(feats.shape)}")
    out = torch.empty((b, n, h, w), dtype=torch.float32, device=feats.device)
    if out.numel() == 0:
        return out
    lib = load_library()
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.vk_assemble(kernels.data_ptr(), feats.data_ptr(), out.data_ptr(), b, n,
                             h * w, c, int(sigmoid), stream)
    _raise_on(rc, "vk_assemble")
    LAUNCHES["assemble"] += 1
    return out
