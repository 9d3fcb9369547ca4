from video_knet_tpu_torch.eval.miou import ConfusionMeter
from video_knet_tpu_torch.eval.stq import DSTQuality, STQuality
from video_knet_tpu_torch.eval.vpq import VPQStats, vpq_from_stats, vpq_stats
