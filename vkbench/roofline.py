"""The yardstick of the roofline and MFU metrics: published H100 peaks and
the work of the port's two mask kernels, counted from their launch shapes.

Peaks: NVIDIA's H100 SXM data sheet, dense rates (989 TFLOP/s bf16 on the
tensor cores, 67 TFLOP/s float32 outside them, 3.35 TB/s of HBM3). The
configurations run float32 with TF32 off, so a whole step's MFU is held
against 67 TFLOP/s. A kernel's bound is the larger of its bytes over the
HBM rate and its operations over the bf16 tensor-core peak, the most
generous rate the card has, so that no implementation of the same work
reads above 100% however it computes.

K1 (`vk_mask_pool`): out[b, n, c] = sum over hw of [sigmoid(logit) > thr]
* feat[b, hw, c]; it reads B*N*H*W logits and B*H*W*C features and writes
B*N*C sums, all float32. K2 (`vk_assemble`): out[b, n, hw] = kern[b, n, :]
. feat[b, hw, :]; it reads B*N*C kernels and B*H*W*C features and writes
B*N*H*W logits. Either does 2*B*N*H*W*C operations (a multiply and an
add per term).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
F32 = 4


def k1_work(b, n, h, w, c):
    """(operations, bytes) of one K1 launch."""
    return 2 * b * n * h * w * c, F32 * (b * n * h * w + b * h * w * c + b * n * c)


def k2_work(b, n, h, w, c):
    """(operations, bytes) of one K2 launch."""
    return 2 * b * n * h * w * c, F32 * (b * n * c + b * h * w * c + b * n * h * w)


WORK = {"k1": k1_work, "k2": k2_work}


def bound_seconds(kernel: str, shape) -> float:
    """The least time the card could take for one launch of `kernel`."""
    flops, nbytes = WORK[kernel](*shape)
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)


def roofline_share(kernel: str, shape_counts: dict, device_seconds: float):
    """% of the roofline: the launches' least time over their device time,
    or None when nothing was launched or timed."""
    if not shape_counts or device_seconds <= 0:
        return None
    least = sum(bound_seconds(kernel, s) * n for s, n in shape_counts.items())
    return 100.0 * least / device_seconds


def mfu(flops: float, seconds: float, peak: float = FP32_FLOPS):
    """% of the peak: `flops` done in `seconds` of wall time."""
    if flops <= 0 or seconds <= 0:
        return None
    return 100.0 * flops / seconds / peak
