"""Named config registry: the release presets of Video K-Net.

Own copy of `video_knet_tpu/configs.py`: the same names (the short ones and
the reference's config file stems) and the same configs. `get_config(name)`
returns the config. The image presets (`KNetConfig`) build
`models/knet.py:KNet`, the VPS presets `models/video/knet_vps.py:VideoKNet`
(every track head: `kernel_embed`, the fuse-track preset's `query_fuse`, the
RoI GT-box preset's `roi_gt_box`) and the VIS presets
`models/vis/knet_vis.py:KNetVIS`, the deformable ones with the MSDeformAttn
pixel decoder as their neck. The UniTrack preset serves with
`tracker_type='unitrack'` (`models/video/inference.py`). The two RFP /
DetectoRS image presets build `KNet` over `models/rfp.py:RFP`, with no
neck.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from video_knet_tpu_torch.config import (
    KNetConfig,
    VideoKNetConfig,
    kitti_step_image_config,
    kitti_step_video_config,
    vipseg_video_config,
)
from video_knet_tpu_torch.config_vis import VISConfig, youtube_vis_2019_config


def knet_s3_r50_fpn_cityscapes_step() -> KNetConfig:
    return kitti_step_image_config()


def knet_s3_swin_b_fpn_cityscapes_step() -> KNetConfig:
    return dataclasses.replace(kitti_step_image_config(), backbone="swin_base",
                               backbone_drop_path_rate=0.3)


def knet_s3_swin_l_fpn_cityscapes_step() -> KNetConfig:
    return dataclasses.replace(kitti_step_image_config(), backbone="swin_large",
                               backbone_drop_path_rate=0.2)


def knet_s3_r50_fpn_coco_panoptic() -> KNetConfig:
    """COCO panoptic: 133 classes (80 thing, 53 stuff)."""
    base = kitti_step_image_config()
    return dataclasses.replace(
        base, num_thing_classes=80, num_stuff_classes=53,
        rpn=dataclasses.replace(base.rpn, num_classes=133, num_thing_classes=80,
                                num_stuff_classes=53),
        head=dataclasses.replace(base.head, num_classes=133, num_thing_classes=80,
                                 num_stuff_classes=53),
    )


def knet_s3_r50_fpn_coco_instance() -> KNetConfig:
    """COCO instance segmentation: 80 thing classes, no stuff."""
    base = kitti_step_image_config()
    return dataclasses.replace(
        base, num_thing_classes=80, num_stuff_classes=0,
        rpn=dataclasses.replace(base.rpn, num_classes=80, num_thing_classes=80,
                                num_stuff_classes=0, cat_stuff_mask=False, seg_use_sigmoid=True),
        head=dataclasses.replace(base.head, num_classes=80, num_thing_classes=80,
                                 num_stuff_classes=0),
    )


def knet_s3_r50_deformable_fpn_coco_instance() -> KNetConfig:
    return dataclasses.replace(knet_s3_r50_fpn_coco_instance(),
                               neck_type="msdeform_pixel_decoder")


def knet_s3_swin_b_deformable_fpn_coco_instance() -> KNetConfig:
    return dataclasses.replace(knet_s3_r50_deformable_fpn_coco_instance(),
                               backbone="swin_base", backbone_drop_path_rate=0.3)


def video_knet_s3_r50_kitti_step_joint_train() -> VideoKNetConfig:
    """The flagship VPS model: R-50, KITTI-STEP."""
    return kitti_step_video_config()


def video_knet_s3_swin_b_kitti_step_joint_update() -> VideoKNetConfig:
    """Swin-B, previous_link='update_dynamic_cov', previous_type='update'."""
    return dataclasses.replace(
        kitti_step_video_config(), backbone="swin_base", backbone_drop_path_rate=0.3,
        previous_link="update_dynamic_cov", previous_type="update",
    )


def video_knet_s3_swin_l_kitti_step_joint_update() -> VideoKNetConfig:
    return dataclasses.replace(video_knet_s3_swin_b_kitti_step_joint_update(),
                               backbone="swin_large", backbone_drop_path_rate=0.2)


def video_knet_s3_swin_l_kitti_step_short_track_fc() -> VideoKNetConfig:
    """Swin-L, previous_link='update_dynamic_cov', previous_type='ffn', a
    one-layer track-head MLP."""
    base = kitti_step_video_config()
    return dataclasses.replace(
        base, backbone="swin_large", backbone_drop_path_rate=0.2,
        previous_link="update_dynamic_cov", previous_type="ffn",
        track=dataclasses.replace(base.track, num_fcs=1),
    )


def video_knet_fuse_track_kitti_step() -> VideoKNetConfig:
    return dataclasses.replace(kitti_step_video_config(), track_head_type="query_fuse")


def video_knet_roi_gt_box_kitti_step() -> VideoKNetConfig:
    return dataclasses.replace(kitti_step_video_config(), track_head_type="roi_gt_box")


def video_knet_toy_kitti_step() -> VideoKNetConfig:
    """Per-frame kernels, no cross-frame linking."""
    return dataclasses.replace(kitti_step_video_config(), link_previous=False)


def video_knet_unitrack_kitti_step() -> VideoKNetConfig:
    """Per-frame K-Net detections for the UniTrack tracker (no linking)."""
    return dataclasses.replace(kitti_step_video_config(), link_previous=False)


def video_knet_s3_r50_vipseg() -> VideoKNetConfig:
    return vipseg_video_config()


def video_knet_s3_swin_b_vipseg() -> VideoKNetConfig:
    """Swin-B VPS on VIP-Seg: 124 classes, previous_type='ffn', drop path 0.3."""
    return dataclasses.replace(vipseg_video_config(), backbone="swin_base",
                               backbone_drop_path_rate=0.3)


def video_knet_vis_r50_ytvis2019() -> VISConfig:
    """YouTube-VIS 2019 (40 classes), R-50."""
    return youtube_vis_2019_config()


def video_knet_vis_swin_b_ytvis2019() -> VISConfig:
    return dataclasses.replace(youtube_vis_2019_config(), backbone="swin_base",
                               backbone_drop_path_rate=0.3)


def video_knet_vis_volume_r50_ytvis2019() -> VISConfig:
    """The volume (tube-kernel) ablation: volume init head, clip stages only."""
    return dataclasses.replace(youtube_vis_2019_config(), kernel_head_mode="volume")


def video_knet_vis_r50_deformable_ytvis2019() -> VISConfig:
    """The MSDeformAttn pixel decoder as the neck instead of the FPN."""
    return dataclasses.replace(youtube_vis_2019_config(), neck_type="msdeform_pixel_decoder")


def video_knet_vis_swin_b_deformable_ytvis2019() -> VISConfig:
    return dataclasses.replace(video_knet_vis_swin_b_ytvis2019(),
                               neck_type="msdeform_pixel_decoder")


def knet_s3_detectors_r50_cityscapes_step() -> KNetConfig:
    return dataclasses.replace(kitti_step_image_config(), backbone="detectors_r50")


def knet_s3_swin_b_rfp_cityscapes_step() -> KNetConfig:
    return dataclasses.replace(kitti_step_image_config(), backbone="swin_b_rfp")


DEFORMABLE_VIS_CONFIGS = (
    "video_knet_vis_r50_deformable_ytvis2019", "video_knet_vis_swin_b_deformable_ytvis2019",
    "knet_track_r50_deformable_fpn_1x_youtubevis", "knet_track_swinb_deformable_1x_youtubevis",
)
VIS_CONFIGS = ("video_knet_vis_r50_ytvis2019", "video_knet_vis_swin_b_ytvis2019",
               "video_knet_vis_volume_r50_ytvis2019", *DEFORMABLE_VIS_CONFIGS)

CONFIGS: dict[str, Callable] = {
    "knet_s3_r50_fpn_cityscapes_step": knet_s3_r50_fpn_cityscapes_step,
    "knet_s3_swin_b_fpn_cityscapes_step": knet_s3_swin_b_fpn_cityscapes_step,
    "knet_s3_swin_l_fpn_cityscapes_step": knet_s3_swin_l_fpn_cityscapes_step,
    "knet_s3_r50_fpn_ms-3x_coco-panoptic": knet_s3_r50_fpn_coco_panoptic,
    "knet_s3_r50_fpn_ms-3x_coco": knet_s3_r50_fpn_coco_instance,
    "knet_s3_r50_deformable_fpn_ms-3x_coco": knet_s3_r50_deformable_fpn_coco_instance,
    "knet_s3_swin-b_deformable_fpn_ms-3x_coco": knet_s3_swin_b_deformable_fpn_coco_instance,
    "video_knet_s3_r50_rpn_1x_kitti_step_sigmoid_stride2_mask_embed_link_ffn_joint_train": (
        video_knet_s3_r50_kitti_step_joint_train
    ),
    "video_knet_s3_r50_rpn_1x_kitti_step_sigmoid_stride2_mask_embed_link_ffn_joint_train_8e": (
        video_knet_s3_r50_kitti_step_joint_train  # 8-epoch schedule, same model
    ),
    "video_knet_s3_swinb_rpn_1x_kitti_step_sigmoid_stride2_mask_embed_link_ffn_joint_update": (
        video_knet_s3_swin_b_kitti_step_joint_update
    ),
    "video_knet_s3_swinl_rpn_1x_kitti_step_sigmoid_stride2_mask_embed_link_ffn_joint_update": (
        video_knet_s3_swin_l_kitti_step_joint_update
    ),
    "video_knet_s3_swinl_rpn_1x_kitti_step_sigmoid_stride2_mask_embed_link_ffn_update_conv_short_track_fc": (  # noqa: E501
        video_knet_s3_swin_l_kitti_step_short_track_fc
    ),
    "video_knet_kitti_step_r50": video_knet_s3_r50_kitti_step_joint_train,
    "video_knet_kitti_step_swin_b": video_knet_s3_swin_b_kitti_step_joint_update,
    "video_knet_kitti_step_swin_l": video_knet_s3_swin_l_kitti_step_joint_update,
    "video_knet_kitti_step_toy": video_knet_toy_kitti_step,
    "video_knet_kitti_step_unitrack": video_knet_unitrack_kitti_step,
    "video_knet_kitti_step_fuse_track": video_knet_fuse_track_kitti_step,
    "video_knet_kitti_step_roi_gt_box": video_knet_roi_gt_box_kitti_step,
    "video_knet_vipseg_r50": video_knet_s3_r50_vipseg,
    "video_knet_vipseg_swin_b": video_knet_s3_swin_b_vipseg,
    "video_knet_s3_swin_b_rpn_vipseg_mask_embed_link_ffn_joint_train_8e": (
        video_knet_s3_swin_b_vipseg
    ),
    "video_knet_vis_r50_ytvis2019": video_knet_vis_r50_ytvis2019,
    "video_knet_vis_swin_b_ytvis2019": video_knet_vis_swin_b_ytvis2019,
    "video_knet_vis_volume_r50_ytvis2019": video_knet_vis_volume_r50_ytvis2019,
    "video_knet_vis_r50_deformable_ytvis2019": video_knet_vis_r50_deformable_ytvis2019,
    "video_knet_vis_swin_b_deformable_ytvis2019": video_knet_vis_swin_b_deformable_ytvis2019,
    "knet_track_r50_deformable_fpn_1x_youtubevis": video_knet_vis_r50_deformable_ytvis2019,
    "knet_track_swinb_deformable_1x_youtubevis": video_knet_vis_swin_b_deformable_ytvis2019,
    "knet_s3_detectors_r50_cityscapes_step": knet_s3_detectors_r50_cityscapes_step,
    "knet_s3_swin_b_rfp_cityscapes_step": knet_s3_swin_b_rfp_cityscapes_step,
}


def get_config(name: str):
    if name not in CONFIGS:
        raise KeyError(f"unknown config '{name}'; known: {sorted(CONFIGS)}")
    return CONFIGS[name]()
