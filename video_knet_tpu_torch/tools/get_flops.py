"""Model FLOPs and parameters.

Counterpart of the reference package's `tools/get_flops.py` (the same
arguments and printed lines, plus `--device`; the reference counts with
mmcv's get_model_complexity_info over forward_dummy): the parameter count
is the sum of `numel` over the model's parameters, equal to the JAX
package's count of its params tree. GFLOPs is `torch.utils.flop_counter.
FlopCounterMode` around the forward the JAX tool lowers (`test_step` with
`is_first=False` for vps, the forward for image and vis), on seeded random
weights: two FLOPs per multiply-add of the convolutions, matmuls and
einsums, plus the same 2*B*N*H*W*C a call of the two mask kernels, which
the counter cannot see inside a CUDA launch (`ops/kernels/mask_ops.py:
FLOPS`; on the CPU it counts their plain einsums, the same number), so the
card and the CPU print the same count. Elementwise work is not counted.
This is not XLA's HLO count (`cost_analysis`), which counts elementwise
ops too and a loop body once: the two differ by a few percent (PERF.md).

Usage:
  python -m video_knet_tpu_torch.tools.get_flops [--model vps|image|vis] \\
      [--shape 384 1248] [--backbone resnet50] [--device cpu]
"""

from __future__ import annotations

import dataclasses

import torch

from video_knet_tpu_torch.tools import _cli


COUNTING = ("GFLOPs counts two FLOPs per multiply-add of the convolutions, matmuls and "
            "einsums (torch.utils.flop_counter) and of the two mask kernels (2*B*N*H*W*C a "
            "call), the same on the GPU and the CPU; elementwise work is not counted. It is "
            "not XLA's HLO count (cost_analysis), which the JAX package prints.")


def parse_args(argv=None):
    p = _cli.parser(f"Model FLOPs and parameters. {COUNTING}")
    p.add_argument("--model", default="vps", choices=["vps", "image", "vis"])
    p.add_argument("--shape", type=int, nargs=2, default=[384, 1248])
    p.add_argument("--backbone", default="resnet50")
    return p.parse_args(argv)


def count(model_name: str, h: int, w: int, backbone: str, device) -> tuple[int, int]:
    """(FLOPs of one forward as `main` counts them, parameters)."""
    from torch.utils.flop_counter import FlopCounterMode

    from video_knet_tpu_torch.ops.kernels import mask_ops

    gen = torch.Generator().manual_seed(_cli.INIT_SEED)
    if model_name == "image":
        from video_knet_tpu_torch.config import KNetConfig
        from video_knet_tpu_torch.models.knet import KNet

        model = KNet(dataclasses.replace(KNetConfig(), backbone=backbone), generator=gen,
                     device=device)
        x = torch.zeros((1, h, w, 3), device=device)
        fn = lambda: model(x)  # noqa: E731
    elif model_name == "vps":
        from video_knet_tpu_torch.config import kitti_step_video_config
        from video_knet_tpu_torch.models.video.knet_vps import VideoKNet

        cfg = dataclasses.replace(kitti_step_video_config(), backbone=backbone)
        model = VideoKNet(cfg, generator=gen, device=device)
        x = torch.zeros((1, h, w, 3), device=device)
        prev = torch.zeros((1, cfg.num_proposals + cfg.num_stuff_classes, 1,
                            cfg.head.in_channels), device=device)
        fn = lambda: model.test_step(x, prev, False)  # noqa: E731
    else:
        from video_knet_tpu_torch.config_vis import youtube_vis_2019_config
        from video_knet_tpu_torch.models.vis.knet_vis import KNetVIS

        model = KNetVIS(youtube_vis_2019_config(), generator=gen, device=device)
        x = torch.zeros((1, 5, h, w, 3), device=device)
        fn = lambda: model(x)  # noqa: E731
    mask_ops.reset_launch_counts()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn()
    flops = counter.get_total_flops() + sum(mask_ops.FLOPS.values())
    return flops, sum(p.numel() for p in model.parameters())


def main(argv=None):
    args = parse_args(argv)
    device = _cli.setup_device(args.device)
    h, w = args.shape
    flops, n_params = count(args.model, h, w, args.backbone, device)
    print(f"model={args.model} input={h}x{w}")
    print(f"GFLOPs: {flops / 1e9:.2f}")
    print(f"params: {n_params / 1e6:.2f} M")


if __name__ == "__main__":
    main()
