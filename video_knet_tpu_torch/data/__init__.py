from video_knet_tpu_torch.data.panoptic_png import (
    decode_kitti_panoptic,
    decode_divisor_panoptic,
    encode_two_channel_vps,
)
from video_knet_tpu_torch.data.datasets import (
    DVPSSample,
    KittiStepDVPS,
    VIPSegDVPS,
    CityscapesSTEPImages,
)
from video_knet_tpu_torch.data.transforms import (
    SeqTransformParams,
    sample_transform_params,
    apply_image_transform,
    apply_mask_transform,
    pack_panoptic_gt,
)
from video_knet_tpu_torch.data.loader import VPSTrainLoader
