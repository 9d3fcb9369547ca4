"""PyTorch + CUDA port of video_knet_tpu for NVIDIA Hopper (H100).

Slice A: online VPS serving of Video K-Net R-50 with the on-device
quasi-dense tracker (`models/video/inference.py:VPSInferencePipeline`).
The two mask contractions of that path run as hand-written CUDA kernels
(`ops/kernels/csrc/mask_ops.cu`). Module names mirror the JAX package;
public functions keep its layouts (images and features NHWC, masks
[B, N, H, W], kernels [B, N, K*K, C]).

This package imports torch and numpy only, never jax and nothing of
`video_knet_tpu`.
"""
