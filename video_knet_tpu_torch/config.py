"""Config dataclasses of the VPS serving path.

Own copy of `video_knet_tpu/config.py:16-221` (same field names and
defaults), so the port imports nothing of the JAX package. Fields the
serving path does not read (losses, assignment) stay so that a config built
for one package reads the same in the other.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence


@dataclass(frozen=True)
class AssignerConfig:
    cls_weight: float = 2.0
    dice_weight: float = 4.0
    mask_weight: float = 1.0
    coarse_costs: bool = False


@dataclass(frozen=True)
class KernelUpdatorConfig:
    in_channels: int = 256
    feat_channels: int = 256
    out_channels: int = 256


@dataclass(frozen=True)
class KernelUpdateHeadConfig:
    num_classes: int = 19
    num_thing_classes: int = 2
    num_stuff_classes: int = 17
    num_ffn_fcs: int = 2
    num_heads: int = 8
    num_cls_fcs: int = 1
    num_mask_fcs: int = 1
    feedforward_channels: int = 2048
    in_channels: int = 256
    out_channels: int = 256
    conv_kernel_size: int = 1
    mask_upsample_stride: int = 2  # 4 for the video KITTI-STEP config
    hard_mask_thr: float = 0.5
    feat_transform: bool = True  # 1x1 conv, no norm/act
    with_ffn: bool = True
    loss_mask_weight: float = 1.0
    loss_dice_weight: float = 4.0
    loss_cls_weight: float = 2.0
    loss_rank_weight: float = 0.0
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    updator: KernelUpdatorConfig = field(default_factory=KernelUpdatorConfig)


@dataclass(frozen=True)
class ConvKernelHeadConfig:
    num_proposals: int = 100
    num_classes: int = 19
    num_thing_classes: int = 2
    num_stuff_classes: int = 17
    in_channels: int = 256
    out_channels: int = 256
    conv_kernel_size: int = 1
    feat_downsample_stride: int = 2  # 4 for video config
    feat_refine: bool = False
    use_binary: bool = True
    num_loc_convs: int = 1
    num_seg_convs: int = 1
    proposal_feats_with_obj: bool = True
    cat_stuff_mask: bool = True
    kernel_init_std: float = 1.0
    fpn_type: str = "semantic_fpn"
    fpn_feat_channels: int = 256
    fpn_upsample_times: int = 2
    fpn_positional_encoding: bool = True
    fpn_num_aux_convs: int = 1
    loss_mask_weight: float = 1.0
    loss_dice_weight: float = 4.0
    loss_rank_weight: float = 0.1
    loss_seg_weight: float = 1.0
    seg_use_sigmoid: bool = True


@dataclass(frozen=True)
class TrackHeadConfig:
    num_fcs: int = 2
    in_channels: int = 256
    fc_out_channels: int = 256
    embed_channels: int = 256
    loss_track_weight: float = 0.25
    loss_track_aux_weight: float = 1.0
    aux_neg_pos_ub: int = 3
    aux_neg_margin: float = 0.1
    query_fc_out_channels: int = 1024
    match_loss_weight: float = 1.0


@dataclass(frozen=True)
class TrackerConfig:
    """QuasiDenseEmbedTracker thresholds."""

    init_score_thr: float = 0.35
    obj_score_thr: float = 0.3
    match_score_thr: float = 0.5
    memo_tracklet_frames: int = 5
    memo_momentum: float = 0.8
    nms_conf_thr: float = 0.5
    nms_backdrop_iou_thr: float = 0.3
    nms_class_iou_thr: float = 0.7
    with_cats: bool = True
    match_metric: str = "bisoftmax"
    memo_capacity: int = 128  # static slots for tracklet memory


@dataclass(frozen=True)
class TestCfg:
    max_per_img: int = 100
    mask_thr: float = 0.5
    merge_joint: bool = True
    instance_score_thr: float = 0.25
    overlap_thr: float = 0.6
    iou_thr: float = 0.5
    stuff_max_area: int = 4096
    # merge at mask resolution, then nearest-upsample the label map
    fast_decode: bool = True


@dataclass(frozen=True)
class KNetConfig:
    """Image K-Net; also the base of the video models."""

    backbone: str = "resnet50"
    backbone_drop_path_rate: float = 0.0
    neck_type: str = "fpn"
    frozen_stages: int = 1
    norm_eval: bool = True
    bf16_train: bool = False
    num_stages: int = 3
    assign_stages: int = 3
    stage_loss_weights: Sequence[float] = (1.0, 1.0, 1.0)
    num_proposals: int = 100
    num_thing_classes: int = 2
    num_stuff_classes: int = 17
    mask_assign_stride: int = 4
    ignore_label: int = 255
    max_insts: int = 32
    rpn: ConvKernelHeadConfig = field(default_factory=ConvKernelHeadConfig)
    head: KernelUpdateHeadConfig = field(
        default_factory=lambda: KernelUpdateHeadConfig(loss_rank_weight=0.1)
    )
    assigner: AssignerConfig = field(default_factory=AssignerConfig)
    test: TestCfg = field(default_factory=TestCfg)

    @property
    def num_classes(self) -> int:
        return self.num_thing_classes + self.num_stuff_classes


@dataclass(frozen=True)
class VideoKNetConfig(KNetConfig):
    """VideoKNetQuansiEmbedFCJointTrain (joint_train config)."""

    mask_assign_stride: int = 2
    link_previous: bool = True
    previous_type: str = "ffn"  # 'ffn' | 'update' | 'update_obj'
    previous_link: str | None = None  # None | 'link_atten' | 'update_dynamic_cov'
    track_head_type: str = "kernel_embed"
    ref_seq_index: Sequence[int] = (-2, -1, 1, 2)
    track: TrackHeadConfig = field(default_factory=TrackHeadConfig)
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    rpn: ConvKernelHeadConfig = field(
        default_factory=lambda: ConvKernelHeadConfig(
            feat_downsample_stride=4, seg_use_sigmoid=False, loss_rank_weight=0.1
        )
    )
    head: KernelUpdateHeadConfig = field(
        default_factory=lambda: KernelUpdateHeadConfig(mask_upsample_stride=4)
    )

