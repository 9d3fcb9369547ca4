"""The two mask contractions of the serving path: CUDA kernels, plain versions,
launch counters.

- `fused_mask_pool` replaces `video_knet_tpu/ops/pallas/mask_ops.py:fused_mask_pool`:
  out[b,n,c] = sum_hw [sigmoid(logit[b,n,hw]) > thr] * feat[b,hw,c].
- `fused_assemble` replaces `video_knet_tpu/ops/pallas/mask_ops.py:fused_assemble_sigmoid`:
  out[b,n,hw] = kern[b,n,:] . feat[b,hw,:], with an optional sigmoid epilogue.

Each wrapper takes its plain PyTorch version for tensors on the CPU (the CPU
tests) and, for CUDA tensors, launches its kernel (`csrc/mask_ops.cu`) or
raises: there is no fallback. On CUDA each wrapper is an
`autograd.Function` whose backward is plain fp32 matmuls (the reference
trains through the einsum route; its Pallas kernels have no VJP).
`LAUNCHES` counts the forward kernel launches, one per wrapper call that
launched (a K1 call is three chained kernels: binarize,
partial sums on the tensor cores, ordered reduce; a K2 call is one kernel,
a 3xTF32 product on the tensor cores). `SHAPES` keeps the (B, N, H, W, C)
of every launch, so that a caller can hold each kernel against its plain
version at every shape it was given, and `FLOPS` adds 2*B*N*H*W*C a launch
(two per multiply-add of the contraction), what `torch.utils.flop_counter`
counts for the plain versions' einsums on the CPU, so that
`tools/get_flops.py` counts the same work on both devices. `BYTES` adds
the bytes a launch must move, each input read once and the output written
once (`tools/profile_train.py` counts them: a dispatch mode cannot see
inside a launch).
"""

from __future__ import annotations

import math

import torch

LAUNCHES = {"mask_pool": 0, "assemble": 0}
SHAPES: dict[str, set[tuple[int, ...]]] = {"mask_pool": set(), "assemble": set()}
FLOPS = {"mask_pool": 0, "assemble": 0}
BYTES = {"mask_pool": 0, "assemble": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        FLOPS[k] = 0
        BYTES[k] = 0


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


def _fp32(*ts: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """bf16 inputs (the bf16 training forward) upcast to fp32 for the
    kernels, which take fp32 only: exact, since a bf16 value is exact in fp32
    and in K2's TF32 big plane, and a product of two bf16 values is exact in
    fp32. The result stays fp32, as a Pallas call's does; the caller casts
    it back where JAX's einsum would give bf16."""
    return tuple(t.float() if t.dtype == torch.bfloat16 else t for t in ts)


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


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to TF32 (10 mantissa bits), to nearest with ties away from
    zero, on the bit pattern: what cvt.rna.tf32.f32 does."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32x2(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 -> (big, small) fp32 with their low 13 mantissa bits zero, as K2
    splits both operands for the TF32 tensor cores: big = tf32(x), small =
    tf32(x - big). big_a*big_b + big_a*small_b + small_a*big_b is a*b within
    ~2^-21 of |a*b|."""
    big = _tf32_rna(x)
    return big, _tf32_rna(x - big)


def fused_mask_pool(mask_logits: torch.Tensor, feats: torch.Tensor, *,
                    hard_thr: float = 0.5) -> torch.Tensor:
    """Binarized mask pooling. mask_logits [B, N, H, W]; feats [B, H, W, C]
    -> [B, N, C] float32 (bf16 inputs are upcast). Differentiable in
    `feats` (the hard threshold passes no gradient to the logits)."""
    mask_logits, feats = _fp32(mask_logits, feats)
    if _on_cpu(mask_logits, feats):
        return mask_pool_plain(mask_logits, feats, hard_thr)
    _check("mask_logits", mask_logits, 4)
    _check("feats", feats, 4)
    b, n, h, w = mask_logits.shape
    if tuple(feats.shape[:3]) != (b, h, w):
        raise ValueError(f"shape mismatch: {tuple(mask_logits.shape)} vs {tuple(feats.shape)}")
    return _MaskPool.apply(mask_logits, feats, float(hard_thr))


def unpack_mask_words(bits: torch.Tensor, n: int, hw: int) -> torch.Tensor:
    """K1's mask words [B, ceil(HW/32), n_pad] -> the 0/1 mask [B, N, HW]
    float32: bit l of word (b, w, n) is the mask at position 32 w + l."""
    b, words = bits.shape[:2]
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    m = (bits[:, :, :n, None] >> shifts) & 1  # [B, words, N, 32]
    return m.permute(0, 2, 1, 3).reshape(b, n, words * 32)[:, :, :hw].float()


class _MaskPool(torch.autograd.Function):
    """K1 forward; backward d feats[b, hw, c] = sum_n hard[b, n, hw] * d out[b, n, c],
    one fp32 matmul on the forward's own mask words (saved, then expanded),
    so the backward's mask is exactly the forward's."""

    @staticmethod
    def forward(ctx, mask_logits, feats, hard_thr):
        from video_knet_tpu_torch.ops.kernels.build import load_library

        b, n, h, w = mask_logits.shape
        c = feats.shape[-1]
        ctx.shape = (b, n, h, w, c)
        out = torch.empty((b, n, c), dtype=torch.float32, device=feats.device)
        if out.numel() == 0 or h * w == 0:
            ctx.save_for_backward(None)
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
        SHAPES["mask_pool"].add((b, n, h, w, c))
        FLOPS["mask_pool"] += 2 * b * n * h * w * c
        BYTES["mask_pool"] += 4 * (b * n * h * w + b * h * w * c + b * n * c)
        ctx.save_for_backward(bits)
        return out

    @staticmethod
    def backward(ctx, d_out):
        b, n, h, w, c = ctx.shape
        (bits,) = ctx.saved_tensors
        if not ctx.needs_input_grad[1]:
            return None, None, None
        if bits is None:
            return None, d_out.new_zeros((b, h, w, c)), None
        hard = unpack_mask_words(bits, n, h * w)
        d_feats = torch.matmul(hard.transpose(1, 2), d_out.float())
        return None, d_feats.reshape(b, h, w, c), None


def _zero_padded(x: torch.Tensor, c: int) -> torch.Tensor:
    out = x.new_zeros((*x.shape[:-1], c))
    out[..., :x.shape[-1]] = x
    return out


def fused_assemble(kernels: torch.Tensor, feats: torch.Tensor, *,
                   sigmoid: bool = False) -> torch.Tensor:
    """K=1 dynamic conv. kernels [B, N, C]; feats [B, H, W, C] -> [B, N, H, W]
    float32 logits, or probabilities with `sigmoid` (bf16 inputs are
    upcast). Differentiable in both inputs."""
    kernels, feats = _fp32(kernels, feats)
    if _on_cpu(kernels, feats):
        return assemble_plain(kernels, feats, sigmoid)
    _check("kernels", kernels, 3)
    _check("feats", feats, 4)
    if feats.shape[0] != kernels.shape[0] or feats.shape[-1] != kernels.shape[-1]:
        raise ValueError(f"shape mismatch: {tuple(kernels.shape)} vs {tuple(feats.shape)}")
    return _Assemble.apply(kernels, feats, bool(sigmoid))


class _Assemble(torch.autograd.Function):
    """K2 forward; backward d kern = g . feat and d feat = g^T . kern, with
    g = d out, times p (1 - p) under the sigmoid: two fp32 matmuls. The zero
    padding of C happens inside, so the gradients have the inputs' shapes."""

    @staticmethod
    def forward(ctx, kernels, feats, sigmoid):
        from video_knet_tpu_torch.ops.kernels.build import load_library

        b, n, c = kernels.shape
        shape_c = c
        h, w = feats.shape[1:3]
        out = torch.empty((b, n, h, w), dtype=torch.float32, device=feats.device)
        ctx.sigmoid = sigmoid
        ctx.save_for_backward(kernels, feats, out if sigmoid else None)
        if out.numel() == 0:
            return out
        if c % 4 or c == 0 or kernels.data_ptr() % 16 or feats.data_ptr() % 16:
            # the kernel's TMA loads need 16-byte rows: zeroed copies with C
            # rounded up to 4 (the added channels add nothing)
            c = max(4, -(-c // 4) * 4)
            kernels = _zero_padded(kernels, c)
            feats = _zero_padded(feats, c)
        lib = load_library()
        with torch.cuda.device(feats.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.vk_assemble(kernels.data_ptr(), feats.data_ptr(), out.data_ptr(), b, n,
                                 h * w, c, int(sigmoid), stream)
        _raise_on(rc, "vk_assemble")
        LAUNCHES["assemble"] += 1
        SHAPES["assemble"].add((b, n, h, w, shape_c))
        FLOPS["assemble"] += 2 * b * n * h * w * shape_c
        BYTES["assemble"] += 4 * (b * n * shape_c + b * h * w * shape_c + b * n * h * w)
        return out

    @staticmethod
    def backward(ctx, d_out):
        kernels, feats, probs = ctx.saved_tensors
        b, n, c = kernels.shape
        g = d_out.float()
        if ctx.sigmoid:
            g = g * probs * (1.0 - probs)
        g = g.reshape(b, n, -1)
        f = feats.reshape(b, -1, c)
        d_kern = torch.matmul(g, f) if ctx.needs_input_grad[0] else None
        d_feat = (torch.matmul(g.transpose(1, 2), kernels).reshape(feats.shape)
                  if ctx.needs_input_grad[1] else None)
        return d_kern, d_feat, None
