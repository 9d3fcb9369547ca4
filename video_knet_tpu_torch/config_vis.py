"""Config of the VIS (YouTube-VIS) model family.

Own copy of `video_knet_tpu/config_vis.py` (same field names and defaults),
built from the port's `config.py` dataclasses: 40 classes (all things, no
stuff), 100 proposals, a per-frame K-Net of 3 stages, then the clip tracker
head of 3 stages (`tracker_assign_stages=2`, `query_merge_method='mean'`),
`mask_assign_stride=4`, `max_per_img=10`; clips of 5 frames.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from video_knet_tpu_torch.config import (
    AssignerConfig,
    ConvKernelHeadConfig,
    KernelUpdateHeadConfig,
    TestCfg,
)


@dataclass(frozen=True)
class VISConfig:
    backbone: str = "resnet50"
    backbone_drop_path_rate: float = 0.0  # 0.3 in the Swin-B VIS config
    neck_type: str = "fpn"  # 'fpn' | 'msdeform_pixel_decoder'
    frozen_stages: int = 1
    norm_eval: bool = True
    bf16_train: bool = False
    num_classes: int = 40
    num_proposals: int = 100
    num_frames: int = 5  # clip length at train (whole video at test)
    mask_assign_stride: int = 4
    max_insts: int = 16  # static tube slots
    # 'frame': per-frame K-Net, then the clip fusion (the release pipeline);
    # 'volume': tube kernels from the volume init head, clip stages only
    kernel_head_mode: str = "frame"
    # per-frame K-Net
    num_stages: int = 3
    assign_stages: int = 3
    stage_loss_weights: tuple = (1.0, 1.0, 1.0)
    # clip tracker head
    tracker_num_stages: int = 3
    tracker_assign_stages: int = 2
    tracker_stage_loss_weights: tuple = (1.0, 1.0, 1.0)
    query_merge_method: str = "mean"  # 'mean' | 'attention' | 'attention_pos'
    direct_tracker: bool = False  # seed the clip kernels from the raw init kernels
    with_mask_init: bool = False  # fc_mask_init dynamic-conv mask re-initialization
    rpn: ConvKernelHeadConfig = field(
        default_factory=lambda: ConvKernelHeadConfig(
            num_classes=40,
            num_thing_classes=40,
            num_stuff_classes=0,
            cat_stuff_mask=False,
            feat_downsample_stride=2,
            loss_rank_weight=0.1,
            seg_use_sigmoid=True,
        )
    )
    head: KernelUpdateHeadConfig = field(
        default_factory=lambda: KernelUpdateHeadConfig(
            num_classes=40,
            num_thing_classes=40,
            num_stuff_classes=0,
            mask_upsample_stride=2,
        )
    )
    assigner: AssignerConfig = field(default_factory=AssignerConfig)
    test: TestCfg = field(default_factory=lambda: TestCfg(max_per_img=10))

    @property
    def num_thing_classes(self) -> int:
        return self.num_classes

    @property
    def num_stuff_classes(self) -> int:
        return 0


def youtube_vis_2019_config() -> VISConfig:
    return VISConfig()
