#!/usr/bin/env python3
"""Drive the PyTorch port (`video_knet_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (the process then exits non-zero):
  1. device    the card's name and power limit, torch / CUDA versions
  2. build     nvcc builds the CUDA kernels from ops/kernels/csrc
  3. kernels   each kernel against its plain PyTorch version at the shapes
               the serving paths give it (R-50 stages and init head at B=1
               and B=2, the trained tiny config's N=20/37, 8x12, C=64,
               Swin-B VIP-Seg's N=166 and N=100 at 92x160, VIS's B*T=5,
               `test_whole_video`'s B*T=8 and `vis-data-train`'s B*T=10 at
               45x80, the tiny VIS config's 8 x 8 proposals at 23x40, C=64)
               and at ragged
               shapes (and the live-BN train step's init head at B=4); at the
               R-50 and the VIP-Seg stage shapes, device time
               (a CUDA graph of 20 calls, timed with CUDA events) of the
               kernel, the plain version and one PyTorch library call, the
               kernel's host-inclusive call time, and forward + backward
               beside the plain autograd, the library calls and the bound;
               at VIS's stage shape (B*T=5, N=100, 45x80, C=256),
               `test_whole_video`'s (B*T=8), `vis-data-train`'s (B*T=10)
               and `vis-cli-tiny`'s (B*T=8, N=8, 23x40, C=64), at COCO
               panoptic's (N=153, 100x168), at the image train step's (B=8,
               N=117, 64x128), at the live-BN train step's (B=2, N=117 and
               B=4, N=100, 48x156), at the band split's (phases 54-55) and
               at the frame split's (a VIS rank's B*T_r = 3 and 2 frames,
               N=100, 45x80: `vis_frames_3`, `vis_frames_2`) the same
  4. serve     Video K-Net R-50 (default config, seeded random weights)
               serves 8 frames of 384x1248 through VPSInferencePipeline with
               the tracker on the device
  5. host      the same frames through `quasi_dense_host`: id and semantic
               maps equal phase 4's, track maps agree on >= 0.98 of pixels
  6. full      3 frames with fast_decode=False (decode at 384x1248, the
               host tracker by fallback)
  7. sequence  run_sequence(window=4) over phase 4's frames with a sequence
               boundary, both tracker paths, bit-equal to run_frame
  8. streams   MultiStreamVPSPipeline, B=2, 6 rounds, stream 1 restarting at
               round 3, both tracker paths: >= 0.95 pixel agreement with
               single-stream serving, run_batched_sequence bit-equal to
               run_frames
  9. mit       Video K-Net MiT-b0 (default heads, seeded random weights)
               serves 6 frames of 384x1248
 10. trained   the trained tiny model (committed checkpoint) on the golden's
               12 frames, both tracker paths, against
               tests/golden/serving_trained_tiny_64x96.npz: >= 0.98 pixel
               agreement a frame on all three maps
 11. check     the R-50 weights on a 64x96 sequence, card against CPU
 12. train     VPS training, default config (R-50, 100 + 17 kernels, 3
               stages, max_insts 32, frozen stem + layer1, fp32, TF32 off),
               seeded random weights, 3 steps of `train_step` on
               `make_synthetic_batch` at 384x1248, B=1: finite losses with
               the reference's keys, 7 launches of each mask kernel and 1 of
               the Hungarian kernel a step, a finite nonzero gradient on
               every trainable parameter, none on the frozen ones (which do
               not move); step ms, peak memory, host syncs a step, and the
               Hungarian kernel's device time at the step's costs
 13. train-check  R-50, max_insts 4, 64x96: one train step's assignments,
               losses and gradients on the card against the CPU (weights
               whose hard-threshold inputs keep a 1e-4 margin; the CPU
               replaying the card's ReLU decisions); the
               Hungarian kernel against its numpy copy on 256 seeded
               tie-heavy problems; K1's and K2's gradients against the plain
               versions' autograd at the stage shape and a ragged C
 14. swin-vipseg  Swin-B VPS on VIP-Seg (`get_config("video_knet_vipseg_
               swin_b")`: 100 + 66 kernels, C=256, 3 stages), seeded random
               weights, score gates at zero: 8 frames of 736x1280 with the
               device tracker, then with `quasi_dense_host` (id and semantic
               maps equal); finite carried state
 15. swin-kitti   Swin-B KITTI-STEP (`previous_link='update_dynamic_cov'`,
               `previous_type='update'`): 6 frames of 384x1248 with a
               sequence boundary, device tracker; run_sequence(window=4)
               bit-equal to run_frame
 16. swin-check   Swin-tiny under the trained tiny 64-channel heads, VIP-Seg's
               class split and the link variant, card against CPU at 64x96
               (margin seed): last-stage cls and masks within 1e-3 relative,
               >= 0.98 pixel agreement a frame
 17. train-swin   3 train steps of phase 14's model at 736x1280, B=1 key +
               ref, max_insts 32, drop path 0.3 from a seeded generator:
               finite losses with the reference's keys, 7 launches of each
               mask kernel and 1 Hungarian launch a step, a finite nonzero
               gradient on every parameter but the patch embed and stage 0's
               patch merging, which take none (the reference's
               stop_gradient) and are moved by AdamW's weight decay; step
               ms, peak memory, host syncs a step
 18. vis      Video K-Net VIS R-50 on YouTube-VIS 2019
               (`get_config("video_knet_vis_r50_ytvis2019")`: 40 classes, 100
               proposals, 3 per-frame and 3 clip stages), seeded random
               weights: 3 clips of 5 frames of 360x640, the clip forward and
               `vis_decode` at 360x640: shapes, finite values, labels in
               [0, 40), track ids 0..9, 7 launches of each mask kernel a
               clip; clip ms, peak memory
 19. vis-volume  the volume preset (tube init head, clip stages only), one
               clip: 4 launches of each mask kernel
 20. vis-check  the tiny VIS config (`train_check.vis_check_cfg`: MiT-b0,
               64-channel heads, T=2, 64x96), weights from
               `train_check.vis_margin_seed`, card against CPU: every forward
               output within 1e-4 relative, the decode's labels, mask indices
               and track ids equal; one train step's assignments equal,
               losses within 1e-4, gradients within 1e-3 of each leaf's scale,
               the CPU's step replaying the card's ReLU decisions
               (`train_check.relu_pattern`)
 21. vis-train  3 train steps of phase 18's preset at B=1, T=5, 360x640,
               max_insts 16: finite losses with the reference's keys, 7
               launches of each mask kernel and 1 Hungarian launch a step
               (all 22 assignment problems in one solve), a finite nonzero
               gradient on every trainable parameter, none on the frozen
               ones; step ms, peak memory, host syncs a step
 22. image-pan  image K-Net R-50, COCO panoptic preset (`get_config("knet_s3_r50_
               fpn_ms-3x_coco-panoptic")`: 80 thing + 53 stuff classes, 153
               kernels), seeded random weights, score gate at zero: 5 images of
               800x1344 through the forward, `panoptic_decode` and
               `segments_to_host`: 4 launches of each mask kernel an image;
               image ms, peak memory
 23. image-inst-deform  the deformable COCO instance preset (R-50, the 6-layer
               MSDeformAttn pixel decoder, 80 classes, no stuff rows): 5 images
               of 800x1344, forward and `instance_decode` (100 slots): 4 / 4
               launches an image; the encoder layers' share of the forward and
               `ms_deform_attn_core` alone at this shape (device time beside
               `F.grid_sample` and the bound)
 24. image-train  3 steps of `train/image.py:train_step` on the Cityscapes-STEP
               R-50 preset, B=8 crops of 512x1024, 32 GT slots: finite losses
               with the reference's keys, 4 / 4 / 1 launches a step, 0 host
               syncs after the first, a finite nonzero gradient on every
               trainable parameter, none on the frozen ones
 25. image-check  the tiny image config (`train_check.image_check_cfg`: MiT-b0,
               64-channel heads, the MSDeformAttn neck at one encoder layer),
               panoptic and instance, card against CPU: forward outputs within
               1e-4 relative, decode integers equal; one panoptic train step's
               assignments, losses (1e-4) and gradients (1e-3 a leaf), the CPU
               replaying the card's ReLU decisions; `ms_deform_attn_core` at the
               COCO shape, card fp32 against CPU fp32 (1e-6) and fp64 (1e-4)
 26. vis-deform  the deformable R-50 YouTube-VIS 2019 preset: 3 clips of
               1x5x360x640 served as in `vis`, then 3 train steps as in
               `vis-train` (`vis-deform-train`)
 27. trackers  the R-50 preset (score gates at zero, seeded random weights) on
               the TAO, simple and overlap host trackers, 8 frames of 384x1248
               each; then the trained tiny model's 12 frames on the four host
               trackers (unitrack fed the same numpy features on both
               devices), card against CPU: integer maps and segments equal
 28. unitrack  `video_knet_kitti_step_unitrack` on the unitrack tracker, 6
               frames of 384x1248 with each appearance encoder (ResNet-18,
               ResNet-50, HRNet-w18 at return stage 2, random): frame ms, the
               encoder's ms, the `app_feat` bytes a frame and its copy alone
 29. fuse-track  `video_knet_kitti_step_fuse_track` served 6 frames on the
               device tracker (1024-wide state) and on the host tracker (id
               and semantic maps equal); 3 train steps at 384x1248 (7 / 7 / 1
               launches, step ms, peak memory, 0 syncs after the first)
 30. roi-gt-box  `video_knet_kitti_step_roi_gt_box`, as phase 29, plus
               `roi_align` at the served shape (the frame's features, its 100
               predicted masks' boxes), card against CPU (forward and
               gradient within 1e-5 relative) and its device time; the last
               stage's link takes no gradient in its steps, as in the
               reference
 31. track-check  the tiny check config (`train_check.track_check_cfg`) with
               each head, card against CPU: the test step's outputs within
               1e-4 relative; one train step's assignments equal, losses
               within 1e-4, gradients within 1e-3 of each leaf's scale, the
               CPU replaying the card's ReLU decisions
 32. import-ref  a seeded synthetic joint-train Video K-Net R-50 checkpoint
               under the reference's key names at the release widths (100 +
               17 kernels, C=256, 3 stages with link layers, embed_fcs,
               fc_embed, track_head; `tools/reference_sd.py`) imported with
               `import_torch_knet(strict=True)` into the default VideoKNet on
               the card, each tensor equal to some source tensor after a
               layout rule (the key-by-key name map is held against JAX's
               importer on the CPU, `tests/test_torch_port_checkpoint.py`); 8
               frames of 384x1248 on the device tracker; import ms and frame
               ms
 33. score     import-ref's frames, and a perturbed copy of the GT, against a
               seeded synthetic GT sequence (`tools/eval_check.py`: things
               with persistent track ids, stuff, void) with window VPQ at k =
               1 and 2, STQ, mIoU and video consistency, the host ms a frame
               of each; the trained
               tiny model's 12 golden frames served on the card and on the
               CPU: every metric equal; the `vis` decodes through
               `segm2result` and `instances_to_coco_json`, every RLE decoding
               to its mask bit for bit
 34. ckpt      phase 12's setup for 2 steps, `save_checkpoint`, then
               `restore_checkpoint` into a model and optimizer built from
               another seed: parameters, AdamW moments, step and each group's
               lr bit-equal; one step from each state under
               `torch.use_deterministic_algorithms` (the default backward's
               atomic scatters are not repeatable, PERF.md section 6): losses
               equal, parameters within 1e-6 of each leaf's scale; save and
               restore ms, the file's bytes
 35. data      the VPS data path: a seeded KITTI-STEP tree (2 sequences x 6
               frames of 375x1242, 12 stuff classes in bands, 15 person / car
               boxes a sequence; `tools/data_check.py`) written with the port's
               own PNG writer into a temp directory, every file read back
               bit-equal by `load_png` (decode ms of a frame and of its
               panoptic PNG); `VPSTrainLoader` alone on the
               `video_knet_kitti_step_r50` preset at crop 384x1248, B=1 (host
               ms a batch at 1 and 4 threads), its CUDA batches equal to a
               `device="cpu"` loader's in every field; then `data-train`: 4
               train steps on loader-fed batches (7 / 7 / 1 launches a step,
               finite losses with the reference's keys, the wait on the
               loader a step), and the same batches again with no loader
               running (`data-train-alone`)
 36. eval-hook  `evaluate_vps` with the trained tiny model over its sequence
               written as a KITTI-STEP tree, card and CPU: every metric equal,
               PQ and STQ above 0; with the R-50 device tracker over phase
               35's tree at 384x1248, 8 frames: frame ms and the loop's host
               ms a frame by part; `evaluate_image_panoptic` with the
               Cityscapes-STEP R-50 image K-Net over 4 frames: ms an image,
               `format_pq_table`'s first and last lines
 37. cli-step  `tools/test_step` in process: R-50 over phase 35's tree at
               384x1248, then `eval_dvpq` / `eval_stq` over its output; the
               trained tiny model's maps equal on the card and the CPU
 38. tta       `test_step` with 3 scales and flip (28 launches of each mask
               kernel a frame); the trained tiny model's fused maps equal on
               the card and the CPU but at near-ties
 39. cli-eval  `test_vss`, `test_dvps` + `eval_dstq`, `test_image` and
               `test_coco_instance` once each
 40. vis-data  a seeded YouTube-VIS 2019-style train tree (8 videos x 8
               frames of 720x1280, 1-3 instances a video as RLEs and
               polygons; `tools/data_check.py`) converted by the
               `youtubevis2coco` CLI and read by `YouTubeVISDataset`: decode
               ms a frame, `clip_gt_arrays` ms a clip; `VISTrainLoader` alone
               (host ms a batch of 2 clips x 5 frames on a 360x640 canvas at 1
               and 4 threads; the CUDA batches equal the CPU loader's); 4
               loader-fed steps of the R-50 YouTube-VIS 2019 preset at B=2
               (7 / 7 / 1 launches a step, 0 host syncs after the first, the
               wait on the loader), then the same batches with no loader
               running (`vis-data-train-alone`); the Hungarian kernel at
               the step's 44 problems
 41. vis-cli   `tools/test_whole_video` at its defaults (clips of 8 at
               360x640) with the R-50 preset over a 2-video x 12-frame
               720x1280 val tree: 7 / 7 launches a clip, ms a clip and a
               frame, both videos in results.json, every RLE 360x640, the
               zip's member equal to it; the tiny VIS config (weights from
               `vis_margin_seed`) on the card and the CPU at 180x320:
               tracks, categories and non-empty frames equal, scores within
               1e-5, mask logits within 1e-4 of their scale, mask pixels
               equal but where the CPU's logit lies within twice the
               measured card-vs-CPU difference of 0; then the card test's
               clips at 64x96, each clip's difference and the hard decisions
               inside its forward taken otherwise (a clip past 1e-4 must show
               one)
 42. coco-data  host only: a seeded COCO panoptic tree (4 images of 480x640,
               ~20 segments) and a Cityscapes-VPS tree (2 clips x 3 frames
               of 1024x2048): `load_sem_inst` ms, the `get_pair` sequence,
               `load_instance_annotations` and `pad_to` on a 1024x2048
               instance map
 43. train-cli  `tools/train_vps` in process on phase 35's tree (and a 2-frame
               val split): the R-50 default config at 384x1248, B=1, one
               epoch with a record a step and eval of 2 frames; `--resume-from`
               for a second epoch (the step count carries on); a SIGTERM after
               the first step (the checkpoint at step 1, then `--resume-from`
               it); `--freeze-detector` at B=6 (the detector bit-equal, every
               track / link parameter moved); `--bf16` at B=1 (the first
               step's total within 5% of the fp32 run's on the same batch,
               fp32 masters and gradients): 7 / 7 / 1 launches a step, 0 host
               syncs after the first; loader-fed step ms, eval ms a frame,
               peak memory
 44. train-vis-cli  `tools/train_vis` on phase 40's tree: the R-50 YouTube-VIS
               2019 preset, 360x640, T=5, B=2, one epoch; then a `bf16_train`
               step of `train/vis.py` on the loader's first batch (within 5%
               of the fp32 loss)
 45. train-image-cli  `tools/train_image --dataset cityscapes_step` on a seeded
               Cityscapes-STEP tree (1024x2048, crop 512x1024, B=2, 2 steps,
               eval of 2 val images), then `--dataset coco` on a COCO
               panoptic tree with 80 + 53 categories, one step
 46. flops     `tools/get_flops` for vps, image and vis at their defaults on
               the card and on the CPU: equal lines; `utils/profiling`:
               `benchmark` of an R-50 serving frame, a `trace` of one naming
               K1's and K2's CUDA kernels, `device_memory_stats`
 47. train-live-bn  the R-50 default config with `norm_eval=False` (live
               BatchNorm: batch statistics over the 2B images of [ref; key],
               running averages updated once a step) at 384x1248, B=2, 4
               steps: 7 / 7 / 1 launches a step, 0 host syncs after the
               first, step ms beside phase 12's frozen-BN step; the stem's
               and layer1's statistics unchanged, every other BatchNorm's
               moved; then 2 steps at 64x96, B=2, on the card and the CPU
               (the CPU replaying the card's ReLU decisions): losses, the
               first step's gradient and the statistics (TOL_LIVE_BN)
 48. train-dp  the same config, DP_STEPS steps, against the one-process
               B=2 step on the card (`tools/dp_check.py`, ranks in
               processes of their own): 1 NCCL rank alone on the card
               (DDP_VARIANTS, DDP_ROUNDS runs each, interleaved: the step
               without a mesh, over the mesh without DDP, with DDP, with
               DDP looking for unused parameters; their step ms), then 2
               gloo ranks sharing it at B=1 each; the first LOSS_STEPS
               steps' losses and the final statistics within TOL_LIVE_BN,
               and at 64x96 (phase 47's check, the ranks replaying its
               ReLU decisions on their rows) every step's losses and the
               first step's gradient summed over the ranks too; the ranks'
               states bit-equal; 7 / 7 / 1 launches a step on each rank
               (the gloo ranks share the card: not a scaling figure)
 49. train-cli-dp  `torchrun --standalone --nproc_per_node=2` of
               `tools/train_vps` over gloo (`--dist-backend gloo`, both
               ranks on the card) on phase 35's tree, B=4 (2 a rank), one
               epoch, then `--resume-from` its checkpoint for a second;
               against the one-process CLI at B=4 for two epochs: the same
               records (the first step's every loss, later the total
               loss, within TOL_CLI_DP_LOSS beside the decisions each
               step's batch splits take apart at the one-process run's
               weights, printed), the final statistics; one log and one
               checkpoint a epoch, rank 1 printing nothing of the run; each
               rank's launches 7 / 7 / 1 a step
 50. rfp-detectors  the image K-Net preset `knet_s3_detectors_r50_cityscapes_
               step` (the DetectoRS ResNet-50 under the recursive feature
               pyramid, no neck), seeded random weights with every `rfp_conv`
               and SAC's `weight_diff` drawn nonzero and the fusion convs
               scaled to unit spread (else their sigmoids saturate on the
               random levels and pass no gradient), score gate at zero: 5
               images of 384x1248 through the forward and `panoptic_decode` (4
               / 4 launches an image; ms an image, peak memory); 3 train steps
               at B=2 (`rfp-detectors-train`: 4 / 4 / 1 launches, 0 host syncs
               after the first, finite losses, a nonzero gradient on every
               parameter but the DetectoRS stem and layer1, which take none
               and move by weight decay alone)
 51. rfp-swin  the same for `knet_s3_swin_b_rfp_cityscapes_step` (Swin-B under
               the RFP; every parameter takes a gradient)
 52. upernet-align  Video K-Net R-50 with `rpn.fpn_type='upernet_align'` (the
               SFNet aligned head with its DCN output conv), DCN's offsets
               drawn nonzero: 6 frames of 384x1248 on the device tracker (4 /
               4 a frame); 3 `train_step`s at B=1 (`upernet-align-train`: 7 /
               7 / 1, the aligned head, `dcn_out` and the aux convs with
               nonzero gradients, the head's BatchNorm statistics unchanged);
               `DeformConv2d` alone at 48x156x256: device time of the forward
               and of its sampling beside the bound and one `F.grid_sample`
               over the same taps (the `[dcn]` line)
 53. models-check  card against CPU at 64x96: the image K-Net's check heads
               over `detectors_r50` (forward, decode, one train step with the
               CPU replaying the card's ReLU decisions, under deterministic
               algorithms) and `swin_t_rfp`
               (forward, decode); `UperNetAlignHead` v1 and v2 and STDCNet-813
               at 384x1248, `KernelUpdateHead` at K=3 at the R-50 stage shape
               (1e-4 of each output's scale)
 54. train-model-axis  the mesh's `model` axis (`parallel/model_axis.py`)
               on a 1x2 mesh of gloo ranks sharing the card, against the
               one-process step on the card: `video_knet_kitti_step_r50` at
               384x1248, global B=1, each rank's backbone and FPN on a band
               of 192 rows (halo rows from the other band), and
               `video_knet_vis_r50_ytvis2019` on 1x5x360x640 clips, the
               frames split 3 + 2 from the backbone to the losses (the
               heads on each rank's frames, the merge's per-frame kernels
               gathered); 3 steps of each, then a live-BN step of each, and
               one step of `video_knet_vis_volume_r50_ytvis2019` on the
               same clips: every step's losses within 1e-4 (1e-2 at a step
               whose hard decisions the split takes apart, printed; every
               step's ReLU decisions and mask-pool binarizations replayed on
               each rank's share), the presets' first step's gradient
               within 1e-3 (the live step's printed), the
               live statistics within 1e-5, each rank's
               backbone input its share, 7 / 7 / 1 launches a step on each
               rank (4 / 4 / 1 in volume mode); per rank: step ms, peak
               memory beside the one-process run's (each VPS and VIS rank
               below `MODEL_AXIS_PEAK_SHARE`), the bytes a step it hands to
               the collectives (the VIS ranks' gather below 1% of the
               pyramid gather the frame split made before its heads ran on
               frames) (ranks on one card: not a scaling figure); also
               R-50 KITTI-STEP with the MSDeformAttn decoder at 376x1248
               (vps-deform-376: each encoder layer gathers the whole value
               maps, bytes as `dp_check.decoder_gather_bytes` reckons),
               the deformable VIS preset (vis-deform) and R-50 KITTI-STEP
               with the DetectoRS R-50 backbone at 376x1248 (vps-rfp-376:
               no gather; its SACs' global-context all-reduces printed), a
               step each
 55. train-model-axis-swin  the band split of Swin and MiT on the same
               mesh, held as phase 54 holds its presets: Swin-B VIP-Seg
               (`video_knet_vipseg_swin_b`) at 736x1280, B=1, drop path 0.3,
               bands of 384 + 352 rows (12 + 11 stride-32 rows; each block
               takes the rows of the windows that meet its band, the shifted
               windows' ring across the map's bottom edge), 2 steps; MiT-b0
               under the default VPS config at 384x1248 in bands of 192
               rows (the reduced keys and values all-gathered each block),
               1 step; the KITTI-STEP R-50 preset with the Swin-B RFP
               backbone at 376x1248 (swin-b-rfp-376), 1 step; per rank: step
               ms, peak memory beside the one-process run's, the halo, ring
               and gather bytes a step
 56. profile-train  `tools/profile_train.py:profile` at its default
               configuration (R-50, KITTI-STEP heads, max_insts 8), 384x1248,
               B=1, fp32 then bf16: the step's time split into full, forward,
               backbone + neck, loss block and the heads' estimate (median and
               spread of PROFILE_ITERS calls a part), each part's FLOPs, bytes
               and ideal times; every time finite and positive, a full step
               7 / 7 / 1 launches; both reports printed
 57. kitti-prepare  a raw KITTI-STEP tree (train sequences 0 and 1, val
               sequence 2, 2 frames of 376x1248 each) through
               `tools/kitti_step_prepare`, then 2 `tools/train_vps` steps of
               B=2 on the prepared tree (R-50, 384x1248): 7 / 7 / 1 launches a
               step, finite losses
 58. kernel-shapes  K1 and K2 against their plain versions at every shape a
               path launched them (`mask_ops.SHAPES`) that phase 3 did not
               hold
Every VPS serving phase resets the launch counts just before it drives its
path and requires 4 launches of each kernel a frame (a round for B=2); the
VIS phases require their own counts a clip, the image phases 4 an image.
Prints the kernels JSON line (launches per path), the card line, and as the
last line {"ok": true, "device": {...}}. Exits non-zero without a result
when no CUDA device is available.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak
# H100 SXM peaks for the operations bound, each product counted at the
# arithmetic that computes it exactly or at fp32 accuracy: K1's 0/1 mask
# times fp32 features (forward and backward) as three bf16 tensor-core
# products (each fp32 value splits exactly into three bf16 planes, as
# mask_ops.cu does); K2's fp32-accurate product as three TF32 products
# (3xTF32); the Hungarian solve's scalar work as fp32 on the CUDA cores
OPS_PEAK = {"fp32": (1, 67e12), "3xbf16": (3, 989e12),
            "3xtf32": (3, 495e12)}  # (products, FLOP/s)
SERVE_HW = (384, 1248)
SERVE_FRAMES = 8
FULL_FRAMES = 3
BOUNDARY = 5  # run_sequence: a sequence restarts at this frame
STREAM_ROUNDS = 6
STREAM_RESET = 3  # stream 1 restarts at this round
MIT_FRAMES = 6
CHECK_HW = (64, 96)
CHECK_FRAMES = 4
SEED = 0  # kernel inputs and frames (weights: profile_serving.WEIGHT_SEED)
# max abs error allowed against the plain version on the same card:
# K1 sums ~HW/2 unit-normal features per output (|out| up to a few hundred)
# in another order; K2 dots C=256 terms scaled to O(1) outputs.
TOL_MASK_POOL = 5e-3
TOL_ASSEMBLE = 1e-4
KERNELS = ("mask_pool", "assemble")
# Swin-B VPS on VIP-Seg at its frame size (`video_knet_tpu/models/swin.py:68`)
SWIN_VIPSEG_HW = (736, 1280)
SWIN_VIPSEG_KERNELS = 166  # 100 proposals + 66 stuff classes
SWIN_VIPSEG_FRAMES = 8
SWIN_KITTI_FRAMES = 6
SWIN_TRAIN_STEPS = 3
SWIN_DROP_PATH_SEED = 0
# zero gradient at frozen_stages=1, where the reference's stop_gradient cuts
SWIN_CUT = ("backbone.patch_embed.", "backbone.patch_norm.", "backbone.downsample0.")
TRAIN_HW = (384, 1248)
TRAIN_STEPS = 3
TRAIN_CHECK_HW = (64, 96)
TRAIN_SEED = 0  # train weights; train-check takes tools/train_check.py:margin_seed
# the reference's loss keys at the default config (video_knet_tpu's
# video_knet_loss; the stages' rank loss is off in the video head config)
TRAIN_LOSS_KEYS = {
    "loss_rpn_mask", "loss_rpn_dice", "loss_rpn_rank", "loss_rpn_seg",
    "loss_rpn_mask_ref_rpn", "loss_rpn_dice_ref_rpn", "loss_rpn_rank_ref_rpn",
    "loss_rpn_seg_ref_rpn",
    *(f"s{s}_loss_{k}{ref}" for s in range(3) for k in ("cls", "mask", "dice")
      for ref in ("", "_ref")),
    "loss_track", "loss_track_aux",
}
# launches a train step: the joint init head over [ref; key] (B=2) and 3
# stages a branch; every assignment problem of the step in one solve
TRAIN_LAUNCHES = {"mask_pool": 7, "assemble": 7, "hungarian": 1}
FROZEN = ("backbone.conv1.", "backbone.bn1.", "backbone.layer1_")
VIS_HW = (360, 640)  # the reference's VIS crop and clip length (bench.py, tools/train_vis.py)
VIS_FRAMES = 5
VIS_CLIPS = 3
VIS_SEED = 0  # VIS weights; vis-check takes tools/train_check.py:vis_margin_seed
# per clip: the init head and 3 per-frame stages over B*T, 3 clip stages;
# the volume preset: the volume head and the 3 clip stages
VIS_LAUNCHES = {"mask_pool": 7, "assemble": 7}
VIS_VOLUME_LAUNCHES = {"mask_pool": 4, "assemble": 4}
VIS_TRAIN_LAUNCHES = {**VIS_LAUNCHES, "hungarian": 1}
VIS_VOLUME_TRAIN_LAUNCHES = {**VIS_VOLUME_LAUNCHES, "hungarian": 1}
VIS_TRAIN_STEPS = 3
TOL_VIS_CHECK = 1e-4  # card vs CPU, relative to each output's scale
# the image slice: the JAX tools' COCO test size (tools/test_coco_instance.py:30)
IMAGE_HW = (800, 1344)
IMAGE_COUNT = 5
IMAGE_SEED = 0
IMAGE_LAUNCHES = {"mask_pool": 4, "assemble": 4}  # the init head and 3 stages
COCO_PAN_KERNELS = 153  # 100 proposals + 53 stuff classes
# image training: tools/train_image.py's defaults (Cityscapes-STEP, B=8 crops
# of 512x1024, 32 GT slots)
IMAGE_TRAIN_HW = (512, 1024)
IMAGE_TRAIN_B = 8
IMAGE_TRAIN_STEPS = 3
IMAGE_TRAIN_LAUNCHES = {**IMAGE_LAUNCHES, "hungarian": 1}
IMAGE_LOSS_KEYS = {"loss_rpn_mask", "loss_rpn_dice", "loss_rpn_rank", "loss_rpn_seg",
                   *(f"s{s}_loss_{k}" for s in range(3)
                     for k in ("cls", "mask", "dice", "rank"))}
TOL_IMAGE_CHECK = 1e-4  # card vs CPU, relative to each output's scale
# ms_deform_attn_core at the COCO shape, relative to the output's scale: card
# fp32 against CPU fp32 (the same arithmetic; the sums over points in
# another order), and against CPU fp64, where the fp32 rounding of the pixel
# coordinates (x * 168 - 0.5 carries ~1.5e-5 px) moves the bilinear weights
TOL_SAMPLING = {"fp32": 1e-6, "fp64": 1e-4}
# the trackers and track heads slice
TRACKER_FRAMES = 8
HOST_TRACKERS = ("tao", "simple", "overlap", "unitrack")
UNITRACK_FRAMES = 6
UNITRACK_ENCODERS = (("resnet18", {}), ("resnet50", {}), ("hrnet_w18", {"return_stage": 2}),
                     ("random", {}))
HEAD_FRAMES = 6
HEAD_LOSS_KEYS = {"query_fuse": {"loss_match"},
                  "roi_gt_box": {"loss_track_roi", "loss_track_roi_aux"}}
TOL_ROI_ALIGN = 1e-5  # card vs CPU, relative (the gradient's atomics sum in another order)
TOL_TRACK_CHECK = 1e-4  # card vs CPU, relative to each output's scale
IMPORT_SEED = 0  # the synthetic reference checkpoint's values
SCORE_SEED = 0  # the synthetic GT sequences scored in `score`
VIS_CAT_IDS = list(range(1, 41))  # YouTube-VIS 2019's category ids
TOL_CKPT_STEP = 1e-6  # a step from the restored state, relative to each leaf's scale
DATA_HW = (375, 1242)  # the raw KITTI-STEP frame size
DATA_SEQS = 2
DATA_FRAMES = 6
DATA_THINGS = 15  # person / car boxes a sequence
DATA_SEED = 0  # the tree, the loaders and the data-train weights
DATA_REF = (-2, -1, 1, 2)  # video_knet_kitti_step_r50's reference offsets
DATA_TRAIN_STEPS = 4
DATA_DECODE_READS = 5
EVAL_FRAMES = 8
EVAL_IMAGES = 4
TTA_ARGS = ["--tta-scales", "0.75", "1.0", "1.25", "--tta-flip"]
# a TTA frame: the pipeline's step and one test_step for each of 6 variants
TTA_LAUNCHES = {"mask_pool": 28, "assemble": 28}
CLI_IMAGES = 6  # test_image over the first frames of `data`'s tree
DVPS_FRAMES = 4
COCO_IMAGES = 2
COCO_HW = (480, 640)  # COCO-sized images, served at the CLI's 800x1344 default
VIS_DATA_HW = (720, 1280)  # YouTube-VIS 2019's common frame size
VIS_DATA_VIDEOS = 8
VIS_DATA_FRAMES = 8
VIS_DATA_B = 2
VIS_DATA_STEPS = 4
VIS_DATA_INSTS = 3  # instances a video, at most
VIS_CLI_VIDEOS = 2
VIS_CLI_FRAMES = 12  # two clips of test_whole_video's default 8 frames, the second padded
VIS_CLI_CLIP = 8
VIS_CLI_TINY_HW = (180, 320)  # the tiny model's card-vs-CPU run (its CPU side is the cost)
COCO_DATA_IMAGES = 4
CITYSCAPES_HW = (1024, 2048)
CITYSCAPES_CLIPS = 2
CITYSCAPES_FRAMES = 3
TRAIN_CLI_VAL_FRAMES = 2  # a val split beside `data`'s tree, for train_vps's eval
TRAIN_CLI_EVAL_FRAMES = 2
TRAIN_CLI_B = 6  # the --freeze-detector run: 2 steps over the 12 frames
BF16_REL = 0.05  # bf16 against fp32 on the same batch (tests/test_train_extras.py's band)
IMAGE_CLI_IMAGES = 4  # Cityscapes-STEP train images: 2 steps of B=2
IMAGE_CLI_EVAL_IMAGES = 2
IMAGE_CLI_B = 2
# COCO panoptic's 80 thing and 53 stuff categories (any ids: the reader maps
# them things-first onto the preset's 133 classes)
COCO_THING_IDS = tuple(range(1, 81))
COCO_STUFF_IDS = tuple(range(92, 145))
FLOPS_BENCH_ITERS = 10
LIVE_BN_B = 2
LIVE_BN_STEPS = 4
LIVE_BN_CHECK_STEPS = 2
# card vs CPU (train-live-bn at 64x96) and ranks vs one process (train-dp):
# live statistics at 64x96 come from few values a channel, and each live
# BatchNorm divides the forward's rounding by the batch's own spread
# (tests/test_torch_port_parallel.py: port vs JAX 1.1e-4 in the losses,
# 3.8e-5 in the statistics); the first step's gradient, each parameter
# within 1e-3 of its largest magnitude (`_grad_scale`), the CPU or the
# ranks replaying the reference's ReLU decisions. Parameters are not held: under the warmup
# (lr(0) = 1e-7) an AdamW step moves an element by about lr whatever its
# gradient, so two runs' parameters cannot tell a right gradient from a
# wrong one.
TOL_LIVE_BN = {"loss": 1e-3, "stats": 1e-4, "grads": 1e-3}
DP_STEPS = 6  # two batches, three times: steps 2.. time the step
LOSS_STEPS = 2  # train-dp at 384x1248 holds these steps' losses
# train-dp's one NCCL rank, alone on the card: the one-process step in the
# rank's own process ("plain"), the step over the mesh without DDP (its
# collectives only: "none"), the DDP step the port builds ("ddp") and DDP
# walking the autograd graph for unused parameters ("find_unused"); each
# run twice, the rounds interleaved, so that a drift of the card's or the
# host's pace over the phase falls on every variant alike
DDP_VARIANTS = ("plain", "none", "ddp", "find_unused")
DDP_ROUNDS = 2
CLI_DP_B = 4  # 2 images a rank
# train-cli-dp, each step's record against the one-process CLI's (random
# weights, loader-fed, no ReLU replay). At the first step both runs hold
# the same weights and rows, and only the batch split differs (B=4 in one
# process, B=2 a rank): every loss within the first limit, unless the two
# splits of that batch decide apart somewhere (`train_check.vps_decisions`:
# a hard mask-pool input on the other side of its threshold, or another
# Hungarian assignment), which moves a loss by a discrete amount; then
# within the second (an H100 reads loss_track 2.4e-3 there, beside 25
# decisions apart). From the second step the weights differ by rounding
# too (the gradient summed in another order, which AdamW's normalization
# carries to ~lr an element), and a near-tie can go either way where no
# split of one run's weights shows it: a loss of a few proposals moves by
# up to ~1% (an H100 read 8.4e-3); the total loss, summed over every
# proposal, is held to the first limit.
TOL_CLI_DP_LOSS = (1e-3, 1e-2)
# train-model-axis: the mesh's `model` axis over gloo ranks sharing the card
MODEL_AXIS_N = 2  # a 1x2 mesh: 384 rows in 2 bands of 192 (6 x 32); 5 frames as 3 + 2
MODEL_AXIS_STEPS = 3
MODEL_AXIS_SWIN_STEPS = 1  # train-model-axis-swin: Swin-B VIP-Seg steps at 736x1280
MODEL_AXIS_SWIN_BANDS = (384, 352)  # 736 rows: 23 at stride 32, split 12 + 11
# heights that are not a multiple of 32: every band but the last ends on a
# whole stride-32 row, the last holds the partial one. KITTI-STEP's 375x1242
# frames at width 1248, their ratio kept (R-50 in train-model-axis, MiT-b0
# in -swin): 12 stride-32 rows, the last partial, 6 + 6; VIP-Seg's native
# 720p (Swin-B in -swin): 23, the last half, 12 + 11
MODEL_AXIS_KITTI_HW, MODEL_AXIS_KITTI_BANDS = (376, 1248), (192, 184)
# the MSDeformAttn decoder on the bands (vps-deform-376) and on each VIS
# rank's frames (vis-deform): its sampling offsets drawn to spread this many
# pixels (at their init every query samples its own pixel and no band would
# read another's rows)
MODEL_AXIS_DEFORM_REACH = 2.0
MODEL_AXIS_VIPSEG_HW, MODEL_AXIS_VIPSEG_BANDS = (720, 1280), (384, 336)
MODEL_AXIS_SEED = 0
# each rank against the one-process step on the card: every step's losses,
# relative; the presets' first step's gradient, each parameter against
# `_grad_scale`. At every step the ranks replay the one-process run's ReLU
# decisions and K1 binarizations on their band or frames: an H100 took 9
# pixels of a VIS step's pools apart under the frame split, and one moved
# a clip stage's gradient by 1.3e-3 of its scale; with the first step alone
# replayed, an H100 read the VPS preset's loss_track 2.3e-2 apart at its
# second step (its GT slots' embeddings follow the Hungarian assignment,
# which a cascade like the one below can move). The live-BN step's
# statistics, each leaf against
# its largest magnitude. The live-BN step's gradient is printed, not held:
# its one-pass variance, E[x^2] - mean^2 summed band by band, moves the
# forward ~30x more than the frozen step's rounding does (772 ReLU inputs
# on the other side of 0 against 24, an H100's first run), enough to move
# hard decisions that are not replayed (K1's binarization, the Hungarian
# assignment); that run read 1.7e-3 across the backbone's leaves
# A step whose forward the split takes hard decisions apart in (K1's
# binarization, a Hungarian assignment: `dp_check.step_decisions`, the
# ranks' rounding differing from the whole convolutions') holds its losses
# to the looser limit, printed beside the count: one pixel binarized
# otherwise in an early stage moves the kernels of the next and cascades
# (an H100 read 432 elements apart and 2.2e-4 of s1_loss_mask at a VIS
# preset's third step, the weights random)
TOL_MODEL_AXIS = {"loss": 1e-4, "grads": 1e-3, "stats": 1e-5}
TOL_MODEL_AXIS_LIVE = {"loss": 1e-4, "stats": 1e-5}
TOL_MODEL_AXIS_SPLIT_LOSS = 1e-2
# a rank's peak memory over the one-process step's, at most: the lowest
# shares a rank reached on an H100 while the heads ran whole on it behind
# the pyramid's gather (VPS R-50 81.1-94.5%, Swin-B VIP-Seg 72.7-74.9%,
# VIS R-50 81.9-90.0% and 80.9-94.2% live; PERF.md); the heads and the
# loss block on the band or on the rank's frames take them lower; the
# heights that are not a multiple of 32 had no split before, so their
# bounds are the highest share a rank read over two H100 runs plus one
# point (R-50 at 376x1248 68.7% / 68.8%, Swin-B at 720x1280 59.2% / 59.1%,
# MiT-b0 at 376x1248 58.2% / 58.2%; PERF.md), and so are the decoder's
# (R-50 + the MSDeformAttn decoder at 376x1248 56.3% / 56.3%, the deformable
# VIS preset 65.7% / 65.7%) and the RFP backbones' (DetectoRS R-50 at
# 376x1248 64.6% / 65.0%, Swin-B RFP 57.9% / 57.9%)
MODEL_AXIS_PEAK_SHARE = {"vps": 0.811, "vps-live": 0.811, "swin-b": 0.727,
                         "vis": 0.819, "vis-live": 0.809, "vps-376": 0.698,
                         "swin-b-720": 0.602, "mit-b0-376": 0.592,
                         "vps-deform-376": 0.573, "vis-deform": 0.667,
                         "vps-rfp-376": 0.660, "swin-b-rfp-376": 0.589}
# a VIS rank's gather a step, below this share of the pyramid gather the
# frame split made while the heads ran whole (156,958,720 bytes a rank a
# step at 1x5x360x640: its 3 frames' levels forward, the clip's 5 back)
MODEL_AXIS_VIS_GATHER_SHARE = 0.01
# the CUDA kernels of K1 (binarize, partial sums) and K2 that a profiler trace must name
RFP_HW = (384, 1248)
RFP_IMAGES = 5
RFP_TRAIN_B = 2
RFP_TRAIN_STEPS = 3
RFP_SEED = 0
RFP_PRESETS = (("knet_s3_detectors_r50_cityscapes_step", "rfp-detectors"),
               ("knet_s3_swin_b_rfp_cityscapes_step", "rfp-swin"))
# the DetectoRS stem and layer1: cut by the reference's stop_gradient
RFP_CUT = ("backbone.bb.conv1.", "backbone.bb.bn1.", "backbone.bb.layer1_")
RFP_LEAVES = ("rfp_conv", "fusion_weight", "weight_diff", "pre_context", "post_context",
              "switch")
ALIGN_FRAMES = 6
ALIGN_TRAIN_STEPS = 3
ALIGN_SEED = 0
DCN_SHAPE = (1, 48, 156, 256)  # the aligned head's stride-8 map at 384x1248
TRACE_KERNELS = ("mask_pool_binarize_kernel", "mask_pool_partial_kernel", "assemble_kernel")
PROFILE_ITERS = 10  # tools/profile_train.py's timed calls a part (its default)
KITTI_RAW_HW = (376, 1248)
KITTI_RAW_SEQS = (0, 1, 2)  # STEP's train sequences 0 and 1, val sequence 2
KITTI_RAW_FRAMES = 2  # a frame's one reference: 4 train pairs
KITTI_PREPARE_B = 2  # 2 train_vps steps over the 4 pairs


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_build() -> float:
    from video_knet_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    build.load_library()
    secs = time.perf_counter() - t0
    log(f"[build] kernels built and loaded in {secs:.2f} s (nvcc {build.build_seconds:.2f} s)")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build]   {line.strip()}")
    return secs


def _logits(gen, shape, device):
    """Random logits kept at least 1e-6 away from 0 (strict comparison)."""
    x = torch.randn(shape, generator=gen, device=device)
    return torch.where(x >= 0, x.clamp(min=1e-6), x.clamp(max=-1e-6))


def _fwd_bwd(op, feats, kern, wrt_kern: bool):
    """op(feats, kern) -> out, then the gradient of out . 1 with respect to
    the features (and the kernels for K2)."""
    f = feats.clone().requires_grad_()
    k = kern.clone().requires_grad_()

    def run():
        out = op(f, k)
        return torch.autograd.grad(out, (f, k) if wrt_kern else (f,), torch.ones_like(out))

    return run


def _hold_kernels(gen, device, shapes) -> tuple[float, float]:
    """K1 and K2 (sigmoid off and on) against their plain versions on
    random inputs at each (B, N, H, W, C) of `shapes`; their largest
    absolute differences (mask_pool, assemble), each shape's logged."""
    from video_knet_tpu_torch.ops.kernels import mask_ops as mo

    err_pool, err_asm = 0.0, 0.0
    for b, n, hh, ww, c in shapes:
        logits = _logits(gen, (b, n, hh, ww), device)
        feats = torch.randn((b, hh, ww, c), generator=gen, device=device)
        kern = torch.randn((b, n, c), generator=gen, device=device) / c ** 0.5
        e = (mo.fused_mask_pool(logits, feats) - mo.mask_pool_plain(logits, feats)).abs().max()
        err_pool = max(err_pool, float(e))
        for sig in (False, True):
            e = (mo.fused_assemble(kern, feats, sigmoid=sig)
                 - mo.assemble_plain(kern, feats, sigmoid=sig)).abs().max()
            err_asm = max(err_asm, float(e))
        log(f"[kernels] B={b} N={n} HW={hh}x{ww} C={c}: mask_pool err {err_pool:.3e}, "
            f"assemble err {err_asm:.3e} (sigmoid off and on)")
    return err_pool, err_asm


def _launched_shapes() -> set:
    """Every (B, N, H, W, C) at which a mask kernel was launched so far."""
    from video_knet_tpu_torch.ops.kernels import mask_ops as mo

    return set().union(*mo.SHAPES.values())


def phase_kernel_shapes(device, kernels: list[dict], held: set) -> None:
    """K1 and K2 against their plain versions at every shape the paths gave
    them (`mask_ops.SHAPES`) that `phase_kernels` did not hold; each
    kernel's `max_abs_err` takes these in. Run after the paths' counts are
    read."""
    shapes = sorted(_launched_shapes() - held)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    err_pool, err_asm = _hold_kernels(gen, device, shapes)
    torch.cuda.synchronize()
    log(f"[kernel-shapes] the paths launched the mask kernels at {len(_launched_shapes())} "
        f"shapes; the {len(shapes)} that the kernels phase did not hold: mask_pool max abs err "
        f"{err_pool:.3e} (tol {TOL_MASK_POOL}), assemble {err_asm:.3e} (tol {TOL_ASSEMBLE})")
    if not (err_pool <= TOL_MASK_POOL and err_asm <= TOL_ASSEMBLE):
        raise AssertionError(f"[kernel-shapes] a kernel disagrees with its plain version at a "
                             f"path's shape: {err_pool}, {err_asm}")
    for rec in kernels:
        if rec["name"] in KERNELS:
            err = err_pool if rec["name"] == "mask_pool" else err_asm
            rec["max_abs_err"] = max(rec["max_abs_err"], err)


def phase_kernels(device) -> list[dict]:
    from video_knet_tpu_torch.ops.kernels import mask_ops as mo
    from video_knet_tpu_torch.tools.kernel_timing import call_ms, device_ms

    gen = torch.Generator(device=device).manual_seed(SEED)
    h, w = SERVE_HW[0] // 8, SERVE_HW[1] // 8
    # (B, N, H, W, C): the serving shapes (stages N=117, init head N=100; B=2
    # for two streams; the trained tiny config's N=37 / 20 at 8x12, C=64),
    # Swin-B VIP-Seg's, and ragged ones (HW and C multiples of no tile;
    # C=37: K1's 4-byte copies, K2's zero-padded C)
    # Swin-B VIP-Seg: stages N=166, init head N=100 at B=1 (serving) and B=2
    # (the train step's joint pass), 92x160
    vh, vw = SWIN_VIPSEG_HW[0] // 8, SWIN_VIPSEG_HW[1] // 8
    shapes = [(1, 117, h, w, 256), (1, 100, h, w, 256), (2, 117, h, w, 256),
              (2, 100, h, w, 256), (1, 37, 8, 12, 64), (1, 20, 8, 12, 64),
              (1, SWIN_VIPSEG_KERNELS, vh, vw, 256), (1, 100, vh, vw, 256),
              (2, 100, vh, vw, 256), (VIS_FRAMES, 100, VIS_HW[0] // 8, VIS_HW[1] // 8, 256),
              (VIS_CLI_CLIP, 100, VIS_HW[0] // 8, VIS_HW[1] // 8, 256),
              (1, COCO_PAN_KERNELS, IMAGE_HW[0] // 8, IMAGE_HW[1] // 8, 256),
              (1, 100, IMAGE_HW[0] // 8, IMAGE_HW[1] // 8, 256),
              (IMAGE_TRAIN_B, 117, IMAGE_TRAIN_HW[0] // 8, IMAGE_TRAIN_HW[1] // 8, 256),
              (1, 100, 37, 61, 256), (1, 100, 37, 61, 200), (1, 100, 37, 61, 37)]
    # the paths' VIS shapes: vis-data-train's B*T = 2 x 5, and the tiny VIS
    # config's clips of 8 at 180x320 in vis-cli-tiny (8 proposals over 23x40,
    # C=64); phase_kernel_shapes holds the kernels at any other shape a path
    # gives them
    shapes += [(VIS_DATA_B * VIS_FRAMES, 100, VIS_HW[0] // 8, VIS_HW[1] // 8, 256),
               (VIS_CLI_CLIP, 8, 23, 40, 64), (2 * LIVE_BN_B, 100, h, w, 256)]
    # the band split's shapes (train-model-axis, -swin): each rank's band of
    # the stride-8 map, the stages at B=1 and the init head over [ref; key]
    shapes += [(b, k, rows, ww, 256) for _, rows, ww, n in _band_maps()
               for b, k in ((1, n), (2, 100))]
    # the frame split's shapes (train-model-axis): each VIS rank's B*T_r
    # frames of the 1x5 clip, 3 and 2, 100 proposals over 45x80
    shapes += [(b, 100, VIS_HW[0] // 8, VIS_HW[1] // 8, 256) for b in _rank_frames()]
    err_pool, err_asm = _hold_kernels(gen, device, shapes)
    # tie case: a logit of exactly 0 has sigmoid 0.5, which is not > 0.5
    logits = _logits(gen, (1, 100, 37, 61), device)
    logits[:, :10] = 0.0
    logits[:, 10, 5, 7] = 0.0
    feats = torch.randn((1, 37, 61, 256), generator=gen, device=device)
    got = mo.fused_mask_pool(logits, feats)
    ref = mo.mask_pool_plain(logits, feats)
    if bool(got[:, :10].ne(0).any()):
        raise AssertionError("mask_pool pooled pixels whose logit is exactly 0")
    err_pool = max(err_pool, float((got - ref).abs().max()))
    torch.cuda.synchronize()
    log(f"[kernels] mask_pool max abs err {err_pool:.3e} (tol {TOL_MASK_POOL}); "
        f"assemble max abs err {err_asm:.3e} (tol {TOL_ASSEMBLE})")
    if not err_pool <= TOL_MASK_POOL:
        raise AssertionError(f"mask_pool disagrees with its plain version: {err_pool}")
    if not err_asm <= TOL_ASSEMBLE:
        raise AssertionError(f"assemble disagrees with its plain version: {err_asm}")

    recs = _time_kernels(gen, device, 117, h, w, 256, err_pool, err_asm)
    # the Swin-B VIP-Seg stage shape: 100 + 66 kernels over a 92x160 map
    # (736x1280 frames at stride 8)
    for rec, vip in zip(recs, _time_kernels(gen, device, SWIN_VIPSEG_KERNELS, vh, vw, 256,
                                            err_pool, err_asm)):
        rec["vipseg"] = {k: vip[k] for k in TIMED_KEYS}
    # the VIS stage shape: the 5 frames of a clip folded into the batch,
    # 100 proposals over a 45x80 map (360x640 at stride 8)
    for rec, vis in zip(recs, _time_kernels(gen, device, 100, VIS_HW[0] // 8, VIS_HW[1] // 8,
                                            256, err_pool, err_asm, b=VIS_FRAMES)):
        rec["vis"] = {k: vis[k] for k in TIMED_KEYS}
    # test_whole_video's stage shape: its default 8-frame clips at 360x640
    for rec, whole in zip(recs, _time_kernels(gen, device, 100, VIS_HW[0] // 8, VIS_HW[1] // 8,
                                              256, err_pool, err_asm, b=VIS_CLI_CLIP)):
        rec["vis_whole_video"] = {k: whole[k] for k in TIMED_KEYS}
    # vis-data-train's stage shape: B=2 clips of 5 frames folded into the
    # batch; vis-cli-tiny's: the tiny VIS config's 8 proposals, C=64, over
    # 23x40 (180x320 at stride 8) in clips of 8
    for rec, vd in zip(recs, _time_kernels(gen, device, 100, VIS_HW[0] // 8, VIS_HW[1] // 8,
                                           256, err_pool, err_asm,
                                           b=VIS_DATA_B * VIS_FRAMES)):
        rec["vis_data_train"] = {k: vd[k] for k in TIMED_KEYS}
    for rec, tiny in zip(recs, _time_kernels(gen, device, 8, 23, 40, 64, err_pool, err_asm,
                                             b=VIS_CLI_CLIP)):
        rec["vis_cli_tiny"] = {k: tiny[k] for k in TIMED_KEYS}
    # the image slice's stage shapes: COCO panoptic (100 + 53 kernels over
    # 800x1344 at stride 8) and the image train step's (B=8, 100 + 17 over
    # 512x1024 at stride 8)
    for rec, coco in zip(recs, _time_kernels(gen, device, COCO_PAN_KERNELS, IMAGE_HW[0] // 8,
                                             IMAGE_HW[1] // 8, 256, err_pool, err_asm)):
        rec["coco_pan"] = {k: coco[k] for k in TIMED_KEYS}
    for rec, tr in zip(recs, _time_kernels(gen, device, 117, IMAGE_TRAIN_HW[0] // 8,
                                           IMAGE_TRAIN_HW[1] // 8, 256, err_pool, err_asm,
                                           b=IMAGE_TRAIN_B)):
        rec["image_train"] = {k: tr[k] for k in TIMED_KEYS}
    # the band split's stage shapes, each distinct band of the stride-8 map:
    # R-50 KITTI-STEP's 24 of 48 rows (384x1248 over 2) and 24 + 23 of 47
    # (376x1248), Swin-B VIP-Seg's 48 + 44 of 92 (736x1280) and 48 + 42 of
    # 90 (720x1280)
    for key, rows, ww, n in _band_maps():
        for rec, bd in zip(recs, _time_kernels(gen, device, n, rows, ww, 256, err_pool,
                                               err_asm)):
            rec[key] = {k: bd[k] for k in TIMED_KEYS}
    # the frame split's stage shapes: each VIS rank's 3 and 2 frames of the
    # 1x5 clip (train-model-axis), 100 proposals over 45x80
    for b in _rank_frames():
        for rec, fr in zip(recs, _time_kernels(gen, device, 100, VIS_HW[0] // 8,
                                               VIS_HW[1] // 8, 256, err_pool, err_asm, b=b)):
            rec[f"vis_frames_{b}"] = {k: fr[k] for k in TIMED_KEYS}
    # the live-BN train step's shapes at B=2 (train-live-bn): the stages'
    # 100 + 17 kernels at B=2, the init head's 100 over [ref; key] at B=4
    for key, b, n in (("train_b2_stage", LIVE_BN_B, 117), ("train_b2_init", 2 * LIVE_BN_B, 100)):
        for rec, tb in zip(recs, _time_kernels(gen, device, n, h, w, 256, err_pool, err_asm,
                                               b=b)):
            rec[key] = {k: tb[k] for k in TIMED_KEYS}
    return recs


def _rank_frames() -> list[int]:
    """B*T_r, each VIS rank's frames of a 1 x VIS_FRAMES clip under the
    frame split over MODEL_AXIS_N ranks (3 and 2), each once."""
    from video_knet_tpu_torch.parallel.model_axis import frame_counts

    return sorted(set(frame_counts(VIS_FRAMES, MODEL_AXIS_N)), reverse=True)


def _band_maps() -> list[tuple[str, int, int, int]]:
    """(key, rows, columns, stage kernels N) of each distinct band of the
    stride-8 map that the band split's train steps give K1 and K2, rank by
    rank, from the split's own geometry (`model_axis.map_bands`): R-50
    KITTI-STEP at TRAIN_HW and MODEL_AXIS_KITTI_HW (MiT-b0's bands there
    are R-50's), Swin-B VIP-Seg at SWIN_VIPSEG_HW and MODEL_AXIS_VIPSEG_HW."""
    from video_knet_tpu_torch.parallel.model_axis import Split, band_units, map_bands

    out, seen = [], set()
    for name, (h, w), n in (("r50", TRAIN_HW, 117), ("r50_376", MODEL_AXIS_KITTI_HW, 117),
                            ("swin_b", SWIN_VIPSEG_HW, SWIN_VIPSEG_KERNELS),
                            ("swin_b_720", MODEL_AXIS_VIPSEG_HW, SWIN_VIPSEG_KERNELS)):
        band = Split("rows", None, 0, MODEL_AXIS_N, tuple(band_units(h, MODEL_AXIS_N)), (h, w))
        cols = -(-w // 8)
        for m, (a, b) in enumerate(map_bands(band, cols)):
            if (b - a, cols, n) not in seen:
                seen.add((b - a, cols, n))
                out.append((f"band_{name}_{m}", b - a, cols, n))
    return out


TIMED_KEYS = ("shape", "ms", "call_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
              "fwd_bwd_ms", "plain_fwd_bwd_ms", "fwd_bwd_library_ms", "fwd_bwd_bound_ms",
              "bwd_bound_ms", "bwd_library_ms")


def _time_kernels(gen, device, n, h, w, c, err_pool, err_asm, b: int = 1) -> list[dict]:
    """Device time of each kernel at one stage shape (B=1 unless given),
    beside its plain version, one library call and its bound; forward +
    backward beside the plain autograd, the library calls of both
    directions, and both bounds."""
    from video_knet_tpu_torch.ops.kernels import mask_ops as mo
    from video_knet_tpu_torch.tools.kernel_timing import call_ms, device_ms

    hw = h * w
    logits = _logits(gen, (b, n, h, w), device)
    feats = torch.randn((b, h, w, c), generator=gen, device=device)
    kern = torch.randn((b, n, c), generator=gen, device=device) / c ** 0.5
    hard = (torch.sigmoid(logits) > 0.5).float().reshape(b, n, hw)
    f2 = feats.reshape(b, hw, c)
    d_pool = torch.randn((b, n, c), generator=gen, device=device)
    d_asm = torch.randn((b, n, hw), generator=gen, device=device)
    nnz = int(hard.sum())
    io_bytes = 4 * b * (n * hw + hw * c + n * c)  # both kernels: same sizes
    # backward bytes: K1 reads its saved mask words (one bit a pixel) and
    # d out, writes d feats; K2 reads d out, kern and feats, writes d kern
    # and d feats
    bwd_bytes = {"mask_pool": b * (n * -(-hw // 32) * 4 + 4 * (n * c + hw * c)),
                 "assemble": 4 * b * (n * hw + 2 * n * c + 2 * hw * c)}
    grad_ops = {  # (kernel, plain version) on (feats, kern), and whether d kern is taken
        "mask_pool": ((lambda f, k: mo.fused_mask_pool(logits, f),
                       lambda f, k: mo.mask_pool_plain(logits, f)), False),
        "assemble": ((lambda f, k: mo.fused_assemble(k, f),
                      lambda f, k: mo.assemble_plain(k, f)), True),
    }
    # the backward's products as torch calls (what each autograd Function runs)
    bwd_lib = {"mask_pool": lambda: torch.matmul(hard.transpose(1, 2), d_pool),
               "assemble": lambda: (torch.matmul(d_asm, f2),
                                    torch.matmul(d_asm.transpose(1, 2), kern))}
    bwd_flops = {"mask_pool": 2 * nnz * c, "assemble": 4 * b * n * hw * c}

    def bound(nbytes, flops, precision):
        products, peak = OPS_PEAK[precision]
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, products * flops / peak * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    recs = []
    for name, fn, plain, lib, flops, precision, err, src_line in (
        ("mask_pool", lambda: mo.fused_mask_pool(logits, feats),
         lambda: mo.mask_pool_plain(logits, feats), lambda: torch.matmul(hard, f2),
         2 * nnz * c, "3xbf16", err_pool, "video_knet_tpu/ops/pallas/mask_ops.py:110"),
        ("assemble", lambda: mo.fused_assemble(kern, feats),
         lambda: mo.assemble_plain(kern, feats), lambda: torch.matmul(kern, f2.transpose(1, 2)),
         2 * b * n * hw * c, "3xtf32", err_asm, "video_knet_tpu/ops/pallas/mask_ops.py:168"),
    ):
        ms = device_ms(fn)
        bound_ms, bound_by = bound(io_bytes, flops, precision)
        # the backward's least time at fp32 accuracy, counted as the forward's
        bwd_bound_ms, _ = bound(bwd_bytes[name], bwd_flops[name], precision)
        rec = dict(
            name=name, route="cuda",
            source="video_knet_tpu_torch/ops/kernels/csrc/mask_ops.cu",
            replaces=src_line, launches=0, max_abs_err=err,
            ms=ms, call_ms=call_ms(fn), plain_ms=device_ms(plain),
            bound_ms=bound_ms, bound_by=bound_by,
            ops_precision=precision, library_ms=device_ms(lib), shape=[b, n, h, w, c],
            bwd_bound_ms=bwd_bound_ms, bwd_library_ms=device_ms(bwd_lib[name]),
        )
        rec["fwd_bwd_bound_ms"] = bound_ms + bwd_bound_ms
        rec["fwd_bwd_library_ms"] = rec["library_ms"] + rec["bwd_library_ms"]
        if name == "assemble":
            rec["ms_sigmoid"] = device_ms(lambda: mo.fused_assemble(kern, feats, sigmoid=True))
        # forward + backward (the autograd Function; d feats, and d kern for
        # K2), against the plain version's autograd on the same card
        ops, wrt_kern = grad_ops[name]
        rec["fwd_bwd_ms"], rec["plain_fwd_bwd_ms"] = (
            device_ms(_fwd_bwd(op, feats, kern, wrt_kern)) for op in ops)
        log(f"[kernels] {name} at B={b} N={n} HW={h}x{w} C={c}: device {ms * 1e3:.2f} us (call "
            f"{rec['call_ms'] * 1e3:.1f} us), plain {rec['plain_ms'] * 1e3:.2f} us, library "
            f"{rec['library_ms'] * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us ({bound_by}; "
            f"{io_bytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP at {precision}); forward + "
            f"backward {rec['fwd_bwd_ms'] * 1e3:.2f} us, plain autograd "
            f"{rec['plain_fwd_bwd_ms'] * 1e3:.2f} us, library "
            f"{rec['fwd_bwd_library_ms'] * 1e3:.2f} us, bound "
            f"{rec['fwd_bwd_bound_ms'] * 1e3:.2f} us")
        recs.append(rec)
    return recs


def _frames(hw, count, batch: int = 1):
    rng = np.random.RandomState(SEED)
    return [rng.randn(batch, *hw, 3).astype(np.float32) for _ in range(count)]


class Paths:
    """Launch counts and frame times of every serving path driven."""

    def __init__(self):
        self.launches: dict = {}
        self.frame_ms: dict = {}

    def _counted(self, path: str, n_items: int, body, per_item: dict | None = None) -> list:
        """Run `body() -> (results, ms per item)` with the launch counts set
        to 0 just before and read just after; requires `per_item` launches
        of each kernel an item (default 4 each: a frame, or a round)."""
        from video_knet_tpu_torch.ops.kernels import mask_ops as mo

        torch.cuda.synchronize()
        mo.reset_launch_counts()
        out, ms = body()
        launches = dict(mo.LAUNCHES)
        self.launches[path] = launches
        self.frame_ms[path] = ms
        if len(out) != n_items:
            raise AssertionError(f"[{path}] {len(out)} results for {n_items} items")
        per_item = per_item or {name: 4 for name in KERNELS}
        for name in KERNELS:
            if launches[name] != per_item[name] * n_items:
                raise AssertionError(f"[{path}] {name} launched {launches[name]} times in "
                                     f"{n_items} items, expected {per_item[name]} each")
        return out

    def drive(self, path: str, fn, items, frames_per_item: int = 1,
              per_item: dict | None = None) -> list:
        """`fn(item)` for each item (a frame, a round or a clip), timed one by
        one."""
        def body():
            out, ms = [], []
            for it in items:
                t0 = time.perf_counter()
                out.append(fn(it))
                ms.append((time.perf_counter() - t0) * 1e3)
            return out, ms

        out = self._counted(path, len(items), body, per_item)
        ms = self.frame_ms[path]
        med = statistics.median(ms[1:]) if len(ms) > 1 else ms[0]
        log(f"[{path}] {len(items)} x {frames_per_item} frames: median {med:.2f} ms over "
            f"items 1..{len(items) - 1} (first {ms[0]:.1f} ms); launches {self.launches[path]}")
        log(f"[{path}] ms {[round(t, 3) for t in ms]}")
        return out

    def drive_all(self, path: str, gen, n_items: int, frames_per_item: int = 1) -> list:
        """A generator `gen()` that yields one result an item, timed as a
        whole (each item is credited the mean)."""
        def body():
            t0 = time.perf_counter()
            out = list(gen())
            return out, [(time.perf_counter() - t0) * 1e3 / n_items] * n_items

        out = self._counted(path, n_items, body)
        each = self.frame_ms[path][0]
        log(f"[{path}] {n_items} x {frames_per_item} frames in {each * n_items:.1f} ms "
            f"({each:.2f} ms each, first included); launches {self.launches[path]}")
        return out


def _check_maps(path: str, results, hw) -> None:
    for r in results:
        for key in ("panoptic_seg", "semantic_map", "track_map"):
            if getattr(r, key).shape != tuple(hw):
                raise AssertionError(f"[{path}] {key} has shape {getattr(r, key).shape}")
        if not all(np.isfinite(s.get("score", 0.0)) for s in r.segments_info):
            raise AssertionError(f"[{path}] non-finite segment score")


def _agreement(a, b) -> dict:
    return {k: float(np.mean(getattr(a, k) == getattr(b, k)))
            for k in ("panoptic_seg", "semantic_map", "track_map")}


def _assert_bit_equal(path: str, got, want) -> None:
    if len(got) != len(want):
        raise AssertionError(f"[{path}] {len(got)} results for {len(want)} frames")
    for i, (a, b) in enumerate(zip(got, want)):
        for key in ("panoptic_seg", "semantic_map", "track_map"):
            if not np.array_equal(getattr(a, key), getattr(b, key)):
                raise AssertionError(f"[{path}] frame {i}: {key} differs")
        if a.segments_info != b.segments_info:
            raise AssertionError(f"[{path}] frame {i}: segments_info differs")


def phase_serve(device, paths: Paths) -> dict:
    """Phases 4-8 on the R-50 model: device and host trackers, the full
    decode, windows, two streams."""
    from video_knet_tpu_torch.models.video.inference import (
        MultiStreamVPSPipeline,
        VPSInferencePipeline,
    )
    from video_knet_tpu_torch.tools.profile_serving import smoke_config, smoke_model

    cfg = smoke_config()
    model = smoke_model(cfg, device)
    frames = [torch.from_numpy(f).to(device) for f in _frames(SERVE_HW, SERVE_FRAMES)]
    idx = list(range(SERVE_FRAMES))

    # 4. the main path: the tracker on the device
    pipe = VPSInferencePipeline(model, cfg, SERVE_HW, device=device)
    dev = paths.drive("serve", lambda i: pipe.run_frame(frames[i], is_first=(i == 0)), idx)
    _check_maps("serve", dev, SERVE_HW)
    if not torch.isfinite(pipe.prev_obj_feats).all() or \
            not torch.isfinite(pipe.track_state.embeds).all():
        raise AssertionError("non-finite carried state")
    if not any((r.track_map > 0).any() for r in dev):
        raise AssertionError("no frame has a nonzero track id")
    n_things = [sum(s["isthing"] for s in r.segments_info) for r in dev]
    n_tracks = [len(np.unique(r.track_map[r.track_map > 0])) for r in dev]
    log(f"[serve] things per frame {n_things}; track ids per frame {n_tracks}")

    # 5. the host tracker on the same frames
    hpipe = VPSInferencePipeline(model, cfg, SERVE_HW, tracker_type="quasi_dense_host",
                                 device=device)
    host = paths.drive("host", lambda i: hpipe.run_frame(frames[i], is_first=(i == 0)), idx)
    _check_maps("host", host, SERVE_HW)
    for i, (a, b) in enumerate(zip(host, dev)):
        agree = _agreement(a, b)
        log(f"[host] frame {i}: agreement with the device tracker {agree}")
        if agree["panoptic_seg"] != 1.0 or agree["semantic_map"] != 1.0 \
                or agree["track_map"] < 0.98:
            raise AssertionError(f"[host] frame {i} disagrees with the device tracker: {agree}")

    # 6. fast_decode=False: decode at 384x1248, host tracker by fallback
    full_cfg = dataclasses.replace(cfg, test=dataclasses.replace(cfg.test, fast_decode=False))
    fpipe = VPSInferencePipeline(model, full_cfg, SERVE_HW, device=device)
    if fpipe.device_tracker:
        raise AssertionError("fast_decode=False must fall back to the host tracker")
    full = paths.drive("full", lambda i: fpipe.run_frame(frames[i], is_first=(i == 0)),
                       idx[:FULL_FRAMES])
    _check_maps("full", full, SERVE_HW)
    for i, (a, b) in enumerate(zip(full, dev)):
        log(f"[full] frame {i}: agreement with the fast decode {_agreement(a, b)}")

    # 7. windows with a sequence boundary, both trackers, against run_frame
    flags = [i in (0, BOUNDARY) for i in idx]
    for tracker_type in ("quasi_dense", "quasi_dense_host"):
        p = VPSInferencePipeline(model, cfg, SERVE_HW, tracker_type=tracker_type, device=device)
        want = [p.run_frame(frames[i], flags[i]) for i in idx]
        stats: list = []
        path = f"sequence_{tracker_type}"
        got = paths.drive_all(path, lambda: p.run_sequence(frames, flags, window=4, depth=2,
                                                           stats=stats), SERVE_FRAMES)
        _assert_bit_equal(path, got, want)
        log(f"[{path}] bit-equal to run_frame; windows {stats}")

    # 8. two streams, stream 1 restarting at round STREAM_RESET
    a = _frames(SERVE_HW, STREAM_ROUNDS)
    b = [f[:, ::-1].copy() for f in _frames(SERVE_HW, STREAM_ROUNDS)[::-1]]
    rounds = [torch.from_numpy(np.concatenate([x, y])).to(device) for x, y in zip(a, b)]
    rflags = [[r == 0, r in (0, STREAM_RESET)] for r in range(STREAM_ROUNDS)]
    for tracker_type, tag in (("quasi_dense", ""), ("quasi_dense_host", "_host")):
        path = f"streams{tag}"
        ms = MultiStreamVPSPipeline(model, cfg, SERVE_HW, 2, tracker_type=tracker_type,
                                    device=device)
        multi = paths.drive(path, lambda r: ms.run_frames(rounds[r], rflags[r]),
                            list(range(STREAM_ROUNDS)), frames_per_item=2)
        for s in range(2):
            single = VPSInferencePipeline(model, cfg, SERVE_HW, tracker_type=tracker_type,
                                          device=device)
            for r in range(STREAM_ROUNDS):
                one = single.run_frame(rounds[r][s:s + 1], rflags[r][s])
                agree = _agreement(multi[r][s], one)
                log(f"[{path}] stream {s} round {r}: agreement with one stream {agree}")
                if min(agree.values()) < 0.95:
                    raise AssertionError(f"[{path}] stream {s} round {r}: {agree}")
        ms2 = MultiStreamVPSPipeline(model, cfg, SERVE_HW, 2, tracker_type=tracker_type,
                                     device=device)
        stats = []
        seq = paths.drive_all(f"{path}_sequence", lambda: ms2.run_batched_sequence(
            rounds, rflags, depth=2, stats=stats, window=4), STREAM_ROUNDS, frames_per_item=2)
        for s in range(2):
            _assert_bit_equal(f"{path}_sequence stream {s}", [x[s] for x in seq],
                              [x[s] for x in multi])
        log(f"[{path}_sequence] bit-equal to run_frames; windows {stats}")
    return dict(launches=paths.launches["serve"])


def phase_mit(device, paths: Paths) -> None:
    """MiT-b0 with the default heads, seeded random weights, 384x1248."""
    from video_knet_tpu_torch.models.video.inference import VPSInferencePipeline
    from video_knet_tpu_torch.tools.profile_serving import smoke_config, smoke_model

    cfg = dataclasses.replace(smoke_config(), backbone="mit_b0")
    model = smoke_model(cfg, device)
    pipe = VPSInferencePipeline(model, cfg, SERVE_HW, device=device)
    frames = [torch.from_numpy(f).to(device) for f in _frames(SERVE_HW, MIT_FRAMES)]
    res = paths.drive("mit", lambda i: pipe.run_frame(frames[i], is_first=(i == 0)),
                      list(range(MIT_FRAMES)))
    _check_maps("mit", res, SERVE_HW)
    if not torch.isfinite(pipe.prev_obj_feats).all():
        raise AssertionError("[mit] non-finite carried kernels")
    log(f"[mit] segments per frame {[len(r.segments_info) for r in res]}; track ids per "
        f"frame {[len(np.unique(r.track_map[r.track_map > 0])) for r in res]}")


def phase_trained(device, paths: Paths) -> None:
    """The trained tiny model on the card against the committed golden."""
    from video_knet_tpu_torch.models.video.inference import VPSInferencePipeline
    from video_knet_tpu_torch.tools import trained_golden as tg

    model = tg.tiny_model(device)
    frames = [torch.from_numpy(f).to(device) for f in tg.eval_frames()]
    gold = np.load(tg.GOLDEN)
    for tracker_type in ("quasi_dense", "quasi_dense_host"):
        pipe = VPSInferencePipeline(model, tg.tiny_cfg(), tg.HW, tracker_type=tracker_type,
                                    device=device)
        path = f"trained_{tracker_type}"
        res = paths.drive(path, lambda i: pipe.run_frame(frames[i], is_first=(i == 0)),
                          list(range(tg.N_FRAMES)))
        arrs = tg.flatten_results(res)
        worst = 1.0
        for i in range(tg.N_FRAMES):
            for key in ("pan", "sem", "trk"):
                agree = float(np.mean(arrs[f"{key}_{i}"] == gold[f"{key}_{i}"]))
                worst = min(worst, agree)
                if agree < 0.98:
                    raise AssertionError(f"[{path}] frame {i} {key}: agreement {agree}")
        exact = all(np.array_equal(arrs[k], gold[k]) for k in gold.files
                    if not k.startswith("seg_score_"))
        log(f"[{path}] worst per-frame agreement with the golden {worst:.6f} (limit 0.98); "
            f"all integer fields bit-equal: {exact}; track-id spans {tg.track_id_spans(arrs)} "
            f"(golden {tg.track_id_spans(dict(gold.items()))})")


def phase_check(device) -> None:
    """The port on the card against the port on the CPU (whose agreement with
    the JAX package the CPU tests hold), same weights, 64x96 frames."""
    from video_knet_tpu_torch.models.video.inference import VPSInferencePipeline
    from video_knet_tpu_torch.tools.profile_serving import smoke_config, smoke_model

    cfg = smoke_config()
    runs = {}
    for dev in (device, torch.device("cpu")):
        model = smoke_model(cfg, dev)
        pipe = VPSInferencePipeline(model, cfg, CHECK_HW, device=dev)
        frames = _frames(CHECK_HW, CHECK_FRAMES)
        with torch.inference_mode():
            out = model.test_step(torch.from_numpy(frames[0]).to(dev),
                                  pipe.prev_obj_feats, True)
        last = out["stage_outs"][-1]
        runs[dev.type] = dict(
            cls=last.cls_score.cpu(), masks=last.mask_preds.cpu(),
            res=[pipe.run_frame(f, is_first=(i == 0)) for i, f in enumerate(frames)])
    g, c = runs["cuda"], runs["cpu"]
    for key in ("cls", "masks"):
        rel = float((g[key] - c[key]).abs().max() / c[key].abs().max())
        log(f"[check] last-stage {key}: max abs diff / max abs = {rel:.3e} (limit 1e-3)")
        if not rel <= 1e-3:
            raise AssertionError(f"card and CPU disagree on {key}: {rel}")
    for t, (rg, rc) in enumerate(zip(g["res"], c["res"])):
        agree = _agreement(rg, rc)
        log(f"[check] frame {t}: pixel agreement card vs CPU {agree} (limit 0.98)")
        if min(agree.values()) < 0.98:
            raise AssertionError(f"frame {t}: card and CPU id maps disagree: {agree}")


def _reset_counts() -> None:
    from video_knet_tpu_torch.ops.kernels import hungarian, mask_ops

    mask_ops.reset_launch_counts()
    hungarian.reset_launch_counts()


def _counts() -> dict:
    from video_knet_tpu_torch.ops.kernels import hungarian, mask_ops

    return {**mask_ops.LAUNCHES, **hungarian.LAUNCHES}


def _train_model(cfg, device, seed: int = TRAIN_SEED):
    from video_knet_tpu_torch.models.video.knet_vps import VideoKNet
    from video_knet_tpu_torch.train.optim import make_optimizer
    from video_knet_tpu_torch.train.train_state import create_train_state

    model = VideoKNet(cfg, generator=torch.Generator().manual_seed(seed), device=device)
    return create_train_state(model, make_optimizer(model, steps_per_epoch=1000))


def _step_costs(model, batch):
    """The [L, G, N] problems the step's one solve takes."""
    from video_knet_tpu_torch.models.video.knet_vps import video_knet_costs
    from video_knet_tpu_torch.ops.hungarian import gt_rows

    with torch.no_grad():
        key, ref, _, _ = model.forward_train(batch.img, batch.ref_img)
        costs, valids = video_knet_costs(key, ref, batch.gt, batch.ref_gt, model.cfg)
    return gt_rows(torch.cat(costs), torch.cat(valids))


def _timed_steps(path: str, step, batches, expected: dict, check_keys, after=None) -> dict:
    """`step(batch) -> loss dict` for each batch, each timed on the host clock
    with a synchronize: the launch counts reset before each step and held
    to `expected`, host syncs counted (`set_sync_debug_mode("warn")`),
    finite losses whose keys pass `check_keys`; `after()` (if given) runs
    after each step, outside the timing; peak memory over the steps."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, syncs, launches = [], [], []
    for i, batch in enumerate(batches):
        _reset_counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                losses = step(batch)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        syncs.append(sum("synchroniz" in str(w.message) for w in caught))
        launches.append(_counts())
        vals = {k: float(v) for k, v in losses.items()}
        if not check_keys(set(vals)):
            raise AssertionError(f"[{path}] loss keys {sorted(vals)}")
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"[{path}] step {i}: non-finite losses {vals}")
        if launches[-1] != expected:
            raise AssertionError(f"[{path}] step {i}: launches {launches[-1]}, expected "
                                 f"{expected}")
        log(f"[{path}] step {i}: total_loss {vals['total_loss']:.4f}, {ms[-1]:.1f} ms, "
            f"{syncs[-1]} host syncs, launches {launches[-1]}")
        if after is not None:
            after()
    peak = torch.cuda.max_memory_allocated()
    if any(syncs[1:]):
        raise AssertionError(f"[{path}] host syncs after the first step: {syncs}")
    med = statistics.median(ms[1:])
    log(f"[{path}] median step {med:.2f} ms over steps 1..{len(ms) - 1} (first {ms[0]:.1f} "
        f"ms); peak memory {peak / 2**30:.3f} GiB ({peak} bytes); host syncs a step {syncs}")
    return dict(step_ms=ms, median_ms=med, peak_bytes=peak, syncs=syncs,
                launches={k: sum(c[k] for c in launches) for k in expected})


def _check_trained(path: str, model, frozen: dict, trainable: list,
                   need_nonzero: str = "") -> None:
    """A finite gradient on every trainable parameter, nonzero on those whose
    name starts with `need_nonzero` (all by default; the others' zero
    gradients are logged); none on the frozen ones, which did not move."""
    bad = [n for n, p in trainable if p.grad is None or not bool(torch.isfinite(p.grad).all())
           or (float(p.grad.norm()) == 0.0 and n.startswith(need_nonzero))]
    if bad:
        raise AssertionError(f"[{path}] {len(bad)} trainable parameters without a finite "
                             f"nonzero gradient: {bad[:8]}")
    zero = [n for n, p in trainable if float(p.grad.norm()) == 0.0]
    if zero:
        log(f"[{path}] zero gradient (allowed outside {need_nonzero!r}): {zero}")
    moved = [n for n, p in model.named_parameters()
             if n in frozen and (p.grad is not None or not torch.equal(p, frozen[n]))]
    if moved:
        raise AssertionError(f"[{path}] frozen parameters moved or got gradients: {moved[:8]}")


def _cut_and_decayed(path: str, model, step, batches, expected, keys, cut_prefixes) -> dict:
    """`_timed_steps` of `step` over `batches`, then: a finite gradient on
    every parameter in every step and a nonzero one in some step, but on the
    parameters under `cut_prefixes` (the reference's stop_gradient), which
    take a zero gradient and move by AdamW's weight decay alone (the
    nonzero ones)."""
    cut = {n: p.detach().clone() for n, p in model.named_parameters()
           if n.startswith(cut_prefixes)}
    params = dict(model.named_parameters())
    reached, non_finite, cut_grads = set(), set(), set()

    def record_grads():
        for n, p in params.items():
            if p.grad is None:
                continue
            if not bool(torch.isfinite(p.grad).all()):
                non_finite.add(n)
            elif bool(p.grad.any()):
                (cut_grads if n in cut else reached).add(n)

    out = _timed_steps(path, step, batches, expected, keys, record_grads)
    bad = sorted(non_finite | (set(params) - set(cut) - reached))
    if bad:
        raise AssertionError(f"[{path}] {len(bad)} parameters outside the cut without a finite "
                             f"gradient in every step and a nonzero one in some step: {bad[:8]}")
    stuck = sorted(cut_grads | {n for n, before in cut.items()
                                if bool(before.any()) and torch.equal(params[n], before)})
    if stuck:
        raise AssertionError(f"[{path}] cut parameters with a gradient, or not moved by weight "
                             f"decay: {stuck[:8]}")
    log(f"[{path}] {len(reached)} parameters with a nonzero gradient; {len(cut)} cut "
        f"parameters: zero gradient, the nonzero ones moved by weight decay")
    return out


def _frozen_split(path: str, model) -> tuple[dict, list]:
    """(copies of R-50's frozen stem and layer1, the other parameters)."""
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if n.startswith(FROZEN)}
    trainable = [(n, p) for n, p in model.named_parameters() if not n.startswith(FROZEN)]
    if not frozen or any(p.requires_grad for n, p in model.named_parameters()
                         if n.startswith(FROZEN)):
        raise AssertionError(f"[{path}] the stem and layer1 are not frozen")
    return frozen, trainable


def phase_train(device, paths: Paths) -> dict:
    """VPS training at the default config, 384x1248: 3 steps."""
    from video_knet_tpu_torch.config import VideoKNetConfig
    from video_knet_tpu_torch.train.vps import make_synthetic_batch, train_step

    cfg = VideoKNetConfig()
    state = _train_model(cfg, device)
    model = state.model
    batches = [make_synthetic_batch(cfg, 1, TRAIN_HW, seed=i, device=device)
               for i in range(TRAIN_STEPS)]
    frozen, trainable = _frozen_split("train", model)

    def step(batch):
        nonlocal state
        state, losses = train_step(state, batch)
        return losses

    out = _timed_steps("train", step, batches, TRAIN_LAUNCHES,
                       lambda keys: keys == TRAIN_LOSS_KEYS | {"total_loss"})
    _check_trained("train", model, frozen, trainable)
    paths.launches["train"] = out["launches"]
    paths.frame_ms["train"] = out["step_ms"]

    # the Hungarian kernel on the last step's own costs (10 problems at B=1)
    rec = _hungarian_record("train", _step_costs(model, batches[-1]))
    rec.update(name="hungarian", route="cuda",
               source="video_knet_tpu_torch/ops/kernels/csrc/hungarian.cu",
               replaces="video_knet_tpu/ops/hungarian.py:28",
               launches=paths.launches["train"]["hungarian"], library_ms=None)
    out["record"] = rec
    return out


def _hungarian_record(path: str, cost) -> dict:
    """The Hungarian kernel on one step's [L, G, N] problems: equal to its
    numpy copy; device time beside the copy's host time and the bound."""
    from video_knet_tpu_torch.ops.kernels.hungarian import hungarian_plain, solve
    from video_knet_tpu_torch.tools.kernel_timing import device_ms

    rounds = [0]
    t0 = time.perf_counter()
    want = hungarian_plain(cost.cpu().numpy(), rounds)
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(solve(cost).cpu().numpy(), want):
        raise AssertionError(f"[{path}] the Hungarian kernel disagrees with its numpy copy")
    lanes, r, c = cost.shape
    io_bytes = 4 * lanes * r * c + 4 * lanes * r
    # each round: a subtract pair, a compare and a potential update per column
    ops = 4 * (c + 1) * rounds[0]
    t_bytes, t_ops = io_bytes / HBM_BYTES_PER_S * 1e3, ops / OPS_PEAK["fp32"][1] * 1e3
    hms = device_ms(lambda: solve(cost))
    log(f"[{path}] Hungarian kernel {hms * 1e3:.1f} us device for {lanes} problems of "
        f"{r}x{c} ({rounds[0]} rounds; numpy copy {plain_ms:.2f} ms on the host)")
    return dict(max_abs_err=0.0, ms=hms, plain_ms=plain_ms, plain_on="host (numpy)",
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                problems=[lanes, r, c], rounds=rounds[0])


def _grads(model) -> dict:
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu()
            for n, p in model.named_parameters()}


def phase_train_check(device) -> None:
    """One train step on the card against the same step on the CPU; the
    Hungarian kernel on 256 problems; the mask kernels' gradients."""
    import dataclasses as dc

    from video_knet_tpu_torch.config import VideoKNetConfig
    from video_knet_tpu_torch.models.knet import solve_lanes
    from video_knet_tpu_torch.models.video.knet_vps import video_knet_costs, video_knet_loss
    from video_knet_tpu_torch.ops.kernels import mask_ops as mo
    from video_knet_tpu_torch.ops.kernels.hungarian import (
        hungarian_plain,
        solve,
        tie_heavy_problems,
    )
    from video_knet_tpu_torch.tools import train_check
    from video_knet_tpu_torch.train.vps import make_synthetic_batch

    cfg = VideoKNetConfig(max_insts=4)
    seed, margin = train_check.margin_seed(cfg, TRAIN_CHECK_HW)
    log(f"[train-check] weight seed {seed}: mask-pool inputs at least {margin:.2e} from the "
        f"threshold (limit {train_check.MARGIN})")
    runs, pattern = {}, []
    for dev in (device, torch.device("cpu")):
        model = _train_model(cfg, dev, seed).model
        batch = make_synthetic_batch(cfg, 1, TRAIN_CHECK_HW, seed=0, device=dev)
        # the CPU's step follows the card's ReLU decisions (train_check.relu_pattern)
        with train_check.relu_pattern(pattern, replay=bool(runs)) as relus:
            key, ref, ke, re = model.forward_train(batch.img, batch.ref_img)
        losses = video_knet_loss((key, ref), (ke, re), batch.gt, batch.ref_gt, cfg)
        sum(losses.values()).backward()
        g2p, p2g = solve_lanes(*video_knet_costs(key, ref, batch.gt, batch.ref_gt, cfg))
        runs[dev.type] = dict(losses={k: float(v) for k, v in losses.items()},
                              g2p=torch.cat(g2p).cpu(), p2g=torch.cat(p2g).cpu(),
                              grads=_grads(model))
    g, c = runs["cuda"], runs["cpu"]
    if not (torch.equal(g["g2p"], c["g2p"]) and torch.equal(g["p2g"], c["p2g"])):
        raise AssertionError("[train-check] card and CPU assignments differ")
    worst = max(abs(g["losses"][k] - v) / max(abs(v), 1e-6) for k, v in c["losses"].items())
    if set(g["losses"]) != set(c["losses"]) or not worst <= 1e-4:
        raise AssertionError(f"[train-check] losses differ: worst relative {worst}")
    gworst = 0.0
    for k, want in c["grads"].items():
        scale = float(want.abs().max())
        if k.endswith("key.bias"):  # zero up to rounding: softmax ignores it
            scale = float(c["grads"][k[:-len("bias")] + "weight"].abs().max())
        err = float((g["grads"][k] - want).abs().max())
        gworst = max(gworst, err / max(scale, 1e-12))
        if not err <= 1e-3 * max(scale, 1e-12):
            raise AssertionError(f"[train-check] gradient of {k}: {err} vs scale {scale}")
    log(f"[train-check] assignments equal; losses within {worst:.2e} relative (limit 1e-4); "
        f"gradients within {gworst:.2e} of each leaf's scale (limit 1e-3), the CPU step on the "
        f"card's decisions at {relus['calls']} ReLUs ({relus['differ']} elements decided "
        f"otherwise by the CPU)")

    problems = tie_heavy_problems(seed=1, shapes=((96, 32, 100), (96, 4, 100), (64, 7, 13)))
    count = 0
    for costs, _ in problems:
        got = solve(torch.from_numpy(costs).to(device)).cpu().numpy()
        if not np.array_equal(got, hungarian_plain(costs)):
            raise AssertionError(f"[train-check] Hungarian kernel != numpy on {costs.shape}")
        count += len(costs)
    log(f"[train-check] Hungarian kernel equals its numpy copy on {count} problems")

    gen = torch.Generator(device=device).manual_seed(SEED)
    h, w = SERVE_HW[0] // 8, SERVE_HW[1] // 8
    worst = {"mask_pool": 0.0, "assemble": 0.0}
    for b, n, hh, ww, cc in ((1, 117, h, w, 256), (1, 100, h, w, 256), (2, 37, 8, 12, 37)):
        logits = _logits(gen, (b, n, hh, ww), device)
        feats = torch.randn((b, hh, ww, cc), generator=gen, device=device)
        kern = torch.randn((b, n, cc), generator=gen, device=device) / cc ** 0.5
        d_pool = torch.randn((b, n, cc), generator=gen, device=device)
        d_asm = torch.randn((b, n, hh, ww), generator=gen, device=device)
        before = dict(mo.LAUNCHES)
        f1, f2 = feats.clone().requires_grad_(), feats.clone().requires_grad_()
        (mo.fused_mask_pool(logits, f1) * d_pool).sum().backward()
        (mo.mask_pool_plain(logits, f2) * d_pool).sum().backward()
        worst["mask_pool"] = max(worst["mask_pool"], float(
            (f1.grad - f2.grad).abs().max() / f2.grad.abs().max()))
        for sig in (False, True):
            k1, k2 = kern.clone().requires_grad_(), kern.clone().requires_grad_()
            f1, f2 = feats.clone().requires_grad_(), feats.clone().requires_grad_()
            (mo.fused_assemble(k1, f1, sigmoid=sig) * d_asm).sum().backward()
            (mo.assemble_plain(k2, f2, sigmoid=sig) * d_asm).sum().backward()
            for a, b_ in ((k1.grad, k2.grad), (f1.grad, f2.grad)):
                worst["assemble"] = max(worst["assemble"],
                                        float((a - b_).abs().max() / b_.abs().max()))
        if {k: mo.LAUNCHES[k] - before[k] for k in before} != {"mask_pool": 1, "assemble": 2}:
            raise AssertionError("[train-check] a backward launched a forward kernel")
    log(f"[train-check] kernel gradients vs the plain versions' autograd, max abs err / "
        f"scale: {worst} (limit 1e-5)")
    if not max(worst.values()) <= 1e-5:
        raise AssertionError(f"[train-check] kernel gradients disagree: {worst}")


def phase_swin_vipseg(device, paths: Paths):
    """Swin-B VPS on VIP-Seg (`get_config("video_knet_vipseg_swin_b")`: 100 +
    66 kernels, 3 stages, C=256), seeded random weights, score gates at
    zero, 736x1280: the device tracker, then the host tracker on the same
    frames. Returns (model, cfg) for the train phase."""
    from video_knet_tpu_torch.configs import get_config
    from video_knet_tpu_torch.models.video.inference import VPSInferencePipeline
    from video_knet_tpu_torch.tools.profile_serving import smoke_config, smoke_model

    cfg = smoke_config(get_config("video_knet_vipseg_swin_b"))
    if cfg.num_proposals + cfg.num_stuff_classes != SWIN_VIPSEG_KERNELS:
        raise AssertionError("[swin-vipseg] the preset lost its class split")
    t0 = time.perf_counter()
    model = smoke_model(cfg, device)
    log(f"[swin-vipseg] Swin-B model built in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.parameters())} parameters)")
    frames = [torch.from_numpy(f).to(device)
              for f in _frames(SWIN_VIPSEG_HW, SWIN_VIPSEG_FRAMES)]
    idx = list(range(SWIN_VIPSEG_FRAMES))
    results = {}
    for tracker_type, path in (("quasi_dense", "swin-vipseg"),
                               ("quasi_dense_host", "swin-vipseg-host")):
        # VIP-Seg's labels are things-first: no KITTI-STEP thing-id table
        pipe = VPSInferencePipeline(model, cfg, SWIN_VIPSEG_HW, thing_ids_in_orig=None,
                                    tracker_type=tracker_type, device=device)
        res = paths.drive(path, lambda i: pipe.run_frame(frames[i], is_first=(i == 0)), idx)
        _check_maps(path, res, SWIN_VIPSEG_HW)
        if not torch.isfinite(pipe.prev_obj_feats).all() or (
                pipe.device_tracker and not torch.isfinite(pipe.track_state.embeds).all()):
            raise AssertionError(f"[{path}] non-finite carried state")
        log(f"[{path}] segments per frame {[len(r.segments_info) for r in res]}; track ids "
            f"per frame {[len(np.unique(r.track_map[r.track_map > 0])) for r in res]}")
        results[path] = res
    for i, (a, b) in enumerate(zip(results["swin-vipseg-host"], results["swin-vipseg"])):
        agree = _agreement(a, b)
        if agree["panoptic_seg"] != 1.0 or agree["semantic_map"] != 1.0:
            raise AssertionError(f"[swin-vipseg-host] frame {i} disagrees with the device "
                                 f"tracker: {agree}")
    log("[swin-vipseg-host] id and semantic maps equal the device tracker's on every frame")
    return model, cfg


def phase_swin_kitti(device, paths: Paths) -> None:
    """Swin-B on KITTI-STEP (`get_config("video_knet_kitti_step_swin_b")`:
    previous_link='update_dynamic_cov', previous_type='update'), 384x1248:
    the device tracker with a sequence boundary, and run_sequence(window=4)
    bit-equal to it."""
    from video_knet_tpu_torch.configs import get_config
    from video_knet_tpu_torch.models.video.inference import VPSInferencePipeline
    from video_knet_tpu_torch.tools.profile_serving import smoke_config, smoke_model

    cfg = smoke_config(get_config("video_knet_kitti_step_swin_b"))
    if (cfg.previous_link, cfg.previous_type) != ("update_dynamic_cov", "update"):
        raise AssertionError("[swin-kitti] the preset lost its link variant")
    model = smoke_model(cfg, device)
    if not hasattr(model.heads[-1], "link_update_conv"):
        raise AssertionError("[swin-kitti] the last stage has no link update")
    frames = [torch.from_numpy(f).to(device) for f in _frames(SERVE_HW, SWIN_KITTI_FRAMES)]
    idx = list(range(SWIN_KITTI_FRAMES))
    flags = [i in (0, BOUNDARY) for i in idx]
    pipe = VPSInferencePipeline(model, cfg, SERVE_HW, device=device)
    dev = paths.drive("swin-kitti", lambda i: pipe.run_frame(frames[i], flags[i]), idx)
    _check_maps("swin-kitti", dev, SERVE_HW)
    if not torch.isfinite(pipe.prev_obj_feats).all():
        raise AssertionError("[swin-kitti] non-finite carried kernels")
    log(f"[swin-kitti] segments per frame {[len(r.segments_info) for r in dev]}; track ids "
        f"per frame {[len(np.unique(r.track_map[r.track_map > 0])) for r in dev]}")
    seq_pipe = VPSInferencePipeline(model, cfg, SERVE_HW, device=device)
    stats: list = []
    got = paths.drive_all("swin-kitti-sequence", lambda: seq_pipe.run_sequence(
        frames, flags, window=4, depth=2, stats=stats), SWIN_KITTI_FRAMES)
    _assert_bit_equal("swin-kitti-sequence", got, dev)
    log(f"[swin-kitti-sequence] bit-equal to run_frame; windows {stats}")


def phase_swin_check(device) -> None:
    """Swin-tiny under the trained tiny config's 64-channel heads, VIP-Seg's
    class split and the Swin KITTI-STEP link (`train_check.swin_check_cfg`),
    card against CPU at 64x96: the joint forward on the margin seed's train
    batch (last-stage cls and masks of both branches within 1e-3 relative),
    then 4 served frames (pixel agreement >= 0.98 a frame)."""
    from video_knet_tpu_torch.models.video.inference import VPSInferencePipeline
    from video_knet_tpu_torch.models.video.knet_vps import VideoKNet
    from video_knet_tpu_torch.tools import train_check
    from video_knet_tpu_torch.tools import trained_golden as tg
    from video_knet_tpu_torch.train.vps import make_synthetic_batch

    cfg = train_check.swin_check_cfg(tg.tiny_cfg())
    seed, margin = train_check.margin_seed(cfg, CHECK_HW)
    log(f"[swin-check] weight seed {seed}: mask-pool inputs at least {margin:.2e} from the "
        f"threshold (limit {train_check.MARGIN})")
    frames = _frames(CHECK_HW, CHECK_FRAMES)
    runs = {}
    for dev in (device, torch.device("cpu")):
        model = VideoKNet(cfg, generator=torch.Generator().manual_seed(seed), device=dev)
        batch = make_synthetic_batch(cfg, 1, CHECK_HW, seed=0, device=dev)
        with torch.no_grad():
            key, ref, _, _ = model.forward_train(batch.img, batch.ref_img)
        pipe = VPSInferencePipeline(model, cfg, CHECK_HW, thing_ids_in_orig=None, device=dev)
        runs[dev.type] = dict(
            cls=torch.cat([b.stage_outs[-1].cls_score for b in (key, ref)]).cpu(),
            masks=torch.cat([b.stage_outs[-1].mask_preds for b in (key, ref)]).cpu(),
            res=[pipe.run_frame(f, is_first=(i == 0)) for i, f in enumerate(frames)])
    g, c = runs["cuda"], runs["cpu"]
    for key in ("cls", "masks"):
        rel = float((g[key] - c[key]).abs().max() / c[key].abs().max())
        log(f"[swin-check] last-stage {key}: max abs diff / max abs = {rel:.3e} (limit 1e-3)")
        if not rel <= 1e-3:
            raise AssertionError(f"[swin-check] card and CPU disagree on {key}: {rel}")
    for i, (rg, rc) in enumerate(zip(g["res"], c["res"])):
        agree = _agreement(rg, rc)
        log(f"[swin-check] frame {i}: pixel agreement card vs CPU {agree} (limit 0.98)")
        if min(agree.values()) < 0.98:
            raise AssertionError(f"[swin-check] frame {i}: card and CPU maps disagree: {agree}")


def phase_train_swin(device, paths: Paths, model, cfg) -> dict:
    """VPS training of Swin-B on VIP-Seg at 736x1280 (phase swin-vipseg's
    model), B=1 key + ref, max_insts 32, drop path 0.3 drawn from a seeded
    generator on the card: 3 steps. The patch embed and stage 0's patch
    merging take no gradient (the reference's stop_gradient at
    frozen_stages=1) but stay in AdamW, whose weight decay moves them (warmup
    off, so that the first steps' decay shows in fp32)."""
    from video_knet_tpu_torch.train.optim import make_optimizer
    from video_knet_tpu_torch.train.train_state import create_train_state
    from video_knet_tpu_torch.train.vps import make_synthetic_batch, train_step

    if cfg.backbone_drop_path_rate != 0.3 or cfg.max_insts != 32:
        raise AssertionError("[train-swin] not the preset's drop path and GT slots")
    state = create_train_state(model, make_optimizer(model, steps_per_epoch=1000,
                                                     warmup_iters=0))
    batches = [make_synthetic_batch(cfg, 1, SWIN_VIPSEG_HW, seed=i, device=device)
               for i in range(SWIN_TRAIN_STEPS)]
    if not any(n.startswith(SWIN_CUT) for n, _ in model.named_parameters()) or \
            not all(p.requires_grad for p in model.parameters()):
        raise AssertionError("[train-swin] every Swin parameter must stay trainable")
    gen = torch.Generator(device=device).manual_seed(SWIN_DROP_PATH_SEED)

    def step(batch):
        nonlocal state
        state, losses = train_step(state, batch, gen)
        return losses

    # a block whose branch drop path removes from both samples takes no
    # gradient in that step: every parameter must be reached in some step
    out = _cut_and_decayed("train-swin", model, step, batches, TRAIN_LAUNCHES,
                           lambda keys: keys == TRAIN_LOSS_KEYS | {"total_loss"}, SWIN_CUT)
    paths.launches["train-swin"] = out["launches"]
    paths.frame_ms["train-swin"] = out["step_ms"]
    return out


def _vis_clips(count: int):
    rng = np.random.RandomState(SEED)
    return [rng.randn(1, VIS_FRAMES, *VIS_HW, 3).astype(np.float32) for _ in range(count)]


def _check_vis_prediction(path: str, pred, cfg) -> None:
    k = cfg.test.max_per_img
    if tuple(pred.masks.shape) != (VIS_FRAMES, k, *VIS_HW):
        raise AssertionError(f"[{path}] decoded masks of shape {tuple(pred.masks.shape)}")
    if not (bool(torch.isfinite(pred.masks).all()) and bool(torch.isfinite(pred.scores).all())):
        raise AssertionError(f"[{path}] non-finite decode")
    labels = pred.labels.cpu()
    if not bool(((labels >= 0) & (labels < cfg.num_classes)).all()):
        raise AssertionError(f"[{path}] labels {labels.tolist()} outside [0, {cfg.num_classes})")
    if pred.track_ids.cpu().tolist() != list(range(k)):
        raise AssertionError(f"[{path}] track ids {pred.track_ids.tolist()}")


def _serve_vis(path: str, cfg, device, paths: Paths, clips: int, per_clip: dict) -> dict:
    """`clips` clips of 5 frames through KNetVIS and `vis_decode` at 360x640,
    each timed on the host clock with a synchronize; launches a clip,
    finite outputs, the decode's fields, peak memory."""
    from video_knet_tpu_torch.models.vis.knet_vis import KNetVIS, vis_decode

    model = KNetVIS(cfg, generator=torch.Generator().manual_seed(VIS_SEED), device=device)
    clip_t = [torch.from_numpy(c).to(device) for c in _vis_clips(clips)]
    outs = {}

    def run(i):
        with torch.no_grad():
            o = model(clip_t[i])
            pred = vis_decode(o, cfg, out_hw=VIS_HW)
        torch.cuda.synchronize()
        outs[i] = o
        return pred

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    preds = paths.drive(path, run, list(range(clips)), frames_per_item=VIS_FRAMES,
                        per_item=per_clip)
    peak = torch.cuda.max_memory_allocated()
    for i, pred in enumerate(preds):
        _check_vis_prediction(path, pred, cfg)
        bad = [j for j, s in enumerate(outs[i].clip_stage_outs)
               if not bool(torch.isfinite(s.mask_preds).all())]
        if bad:
            raise AssertionError(f"[{path}] clip {i}: non-finite masks at clip stages {bad}")
    ms = paths.frame_ms[path]
    med = statistics.median(ms[1:]) if len(ms) > 1 else ms[0]
    log(f"[{path}] labels {preds[0].labels.tolist()}, scores "
        f"{[round(float(x), 4) for x in preds[0].scores]}; median clip {med:.2f} ms over "
        f"clips 1..{clips - 1}; peak memory {peak / 2**30:.3f} GiB ({peak} bytes)")
    del model
    return dict(median_ms=med, clip_ms=ms, peak_bytes=peak,
                preds=[p._replace(**{f: getattr(p, f).cpu() for f in p._fields})
                       for p in preds])


def phase_vis(device, paths: Paths) -> dict:
    """Video K-Net VIS R-50, YouTube-VIS 2019 preset, 3 clips of 1x5x360x640."""
    from video_knet_tpu_torch.configs import get_config

    cfg = get_config("video_knet_vis_r50_ytvis2019")
    if (cfg.num_classes, cfg.num_proposals, cfg.test.max_per_img, cfg.num_frames) != (
            40, 100, 10, VIS_FRAMES):
        raise AssertionError("[vis] not the YouTube-VIS 2019 release config")
    return _serve_vis("vis", cfg, device, paths, VIS_CLIPS, VIS_LAUNCHES)


def phase_vis_volume(device, paths: Paths) -> dict:
    """The volume preset: the tube init head and the clip stages, one clip."""
    from video_knet_tpu_torch.configs import get_config

    cfg = get_config("video_knet_vis_volume_r50_ytvis2019")
    return _serve_vis("vis-volume", cfg, device, paths, 1, VIS_VOLUME_LAUNCHES)


def _leaf_tensors(outs) -> dict:
    """Every tensor of a VISOutputs, by path."""
    flat = {}

    def walk(prefix, x):
        if isinstance(x, (tuple, list)):
            names = getattr(x, "_fields", None) or range(len(x))
            for name, v in zip(names, x):
                walk(f"{prefix}/{name}", v)
        elif x is not None:
            flat[prefix] = x.detach().cpu()

    walk("", outs)
    return flat


def phase_vis_check(device, paths: Paths) -> None:
    """The tiny VIS config, card against CPU (whose agreement with the JAX
    package the CPU tests hold), weights from the margin seed: the forward
    and decode, then one train step."""
    from video_knet_tpu_torch.config_vis import VISConfig
    from video_knet_tpu_torch.models.knet import solve_lanes
    from video_knet_tpu_torch.models.vis.knet_vis import (
        KNetVIS,
        knet_vis_costs,
        knet_vis_loss,
        vis_decode,
    )
    from video_knet_tpu_torch.tools import train_check
    from video_knet_tpu_torch.train.vis import make_synthetic_batch

    cfg = train_check.vis_check_cfg(VISConfig())
    seed, margin = train_check.vis_margin_seed(cfg, CHECK_HW)
    log(f"[vis-check] weight seed {seed}: mask-pool inputs and the decode's top-k logits at "
        f"least {margin:.2e} of their tensors' scale from their boundaries (limit "
        f"{train_check.VIS_MARGIN})")
    runs, pattern = {}, []
    for dev in (device, torch.device("cpu")):
        model = KNetVIS(cfg, generator=torch.Generator().manual_seed(seed), device=dev)
        batch = make_synthetic_batch(cfg, 1, CHECK_HW, seed=0, device=dev)
        _reset_counts()
        with torch.no_grad():
            outs = model(batch.clip)
            pred = vis_decode(outs, cfg, out_hw=CHECK_HW)
        fwd_launches = _counts()
        _reset_counts()
        # the CPU's step follows the card's ReLU decisions (train_check.relu_pattern)
        with train_check.relu_pattern(pattern, replay=dev.type == "cpu") as relus:
            outs_t = model(batch.clip)
        losses = knet_vis_loss(outs_t, batch.gt, cfg)
        sum(losses.values()).backward()
        train_launches = _counts()
        g2p, _ = solve_lanes(*knet_vis_costs(outs_t, batch.gt, cfg))
        runs[dev.type] = dict(outs=_leaf_tensors(outs), pred=pred._replace(
            masks=pred.masks.cpu(), labels=pred.labels.cpu(), scores=pred.scores.cpu(),
            track_ids=pred.track_ids.cpu()),
            losses={k: float(v.detach()) for k, v in losses.items()},
            g2p=[a.cpu() for a in g2p], grads=_grads(model), fwd=fwd_launches,
            train=train_launches)
    g, c = runs["cuda"], runs["cpu"]
    if {k: g["fwd"][k] for k in KERNELS} != VIS_LAUNCHES or g["train"] != VIS_TRAIN_LAUNCHES:
        raise AssertionError(f"[vis-check] card launches: forward {g['fwd']}, train step "
                             f"{g['train']}")
    paths.launches["vis-check"] = {k: g["fwd"][k] + g["train"][k] for k in g["train"]}
    worst = max(float((g["outs"][k] - w).abs().max() / max(float(w.abs().max()), 1e-6))
                for k, w in c["outs"].items())
    log(f"[vis-check] {len(c['outs'])} forward outputs: worst max abs diff / scale "
        f"{worst:.3e} (limit {TOL_VIS_CHECK})")
    if set(g["outs"]) != set(c["outs"]) or not worst <= TOL_VIS_CHECK:
        raise AssertionError(f"[vis-check] card and CPU forward outputs differ: {worst}")
    for f in ("labels", "track_ids"):
        if not torch.equal(getattr(g["pred"], f), getattr(c["pred"], f)):
            raise AssertionError(f"[vis-check] decoded {f} differ: {getattr(g['pred'], f)} vs "
                                 f"{getattr(c['pred'], f)}")
    mrel = float((g["pred"].masks - c["pred"].masks).abs().max() / c["pred"].masks.abs().max())
    srel = float((g["pred"].scores - c["pred"].scores).abs().max() / c["pred"].scores.max())
    if not (mrel <= TOL_VIS_CHECK and srel <= TOL_VIS_CHECK):
        raise AssertionError(f"[vis-check] decoded masks / scores differ: {mrel}, {srel}")
    if not all(torch.equal(a, b) for a, b in zip(g["g2p"], c["g2p"])):
        raise AssertionError("[vis-check] card and CPU assignments differ")
    lworst = max(abs(g["losses"][k] - v) / max(abs(v), 1e-6) for k, v in c["losses"].items())
    if set(g["losses"]) != set(c["losses"]) or not lworst <= 1e-4:
        raise AssertionError(f"[vis-check] losses differ: worst relative {lworst}")
    gworst = 0.0
    for k, want in c["grads"].items():
        scale = float(want.abs().max())
        if k.endswith("key.bias"):  # zero up to rounding: softmax ignores it
            scale = float(c["grads"][k[:-len("bias")] + "weight"].abs().max())
        err = float((g["grads"][k] - want).abs().max())
        gworst = max(gworst, err / max(scale, 1e-12))
        if not err <= 1e-3 * max(scale, 1e-12):
            raise AssertionError(f"[vis-check] gradient of {k}: {err} vs scale {scale}")
    log(f"[vis-check] decode: labels {c['pred'].labels.tolist()} and track ids equal, masks "
        f"within {mrel:.2e}, scores within {srel:.2e}; {len(c['g2p'])} assignment sets equal; "
        f"losses within {lworst:.2e} relative (limit 1e-4); gradients within {gworst:.2e} of "
        f"each leaf's scale (limit 1e-3), the CPU step on the card's decisions at "
        f"{relus['calls']} ReLUs ({relus['differ']} elements decided otherwise by the CPU); "
        f"card launches forward {g['fwd']}, step {g['train']}")


def phase_vis_train(device, paths: Paths, name: str = "video_knet_vis_r50_ytvis2019",
                    path: str = "vis-train", need_nonzero: str = "") -> dict:
    """VIS training of an R-50 YouTube-VIS 2019 preset at B=1, T=5, 360x640,
    16 tube slots: 3 steps. `need_nonzero`: see `_check_trained`."""
    from video_knet_tpu_torch.configs import get_config
    from video_knet_tpu_torch.models.vis.knet_vis import KNetVIS, knet_vis_costs
    from video_knet_tpu_torch.ops.hungarian import gt_rows
    from video_knet_tpu_torch.train.optim import make_optimizer
    from video_knet_tpu_torch.train.train_state import create_train_state
    from video_knet_tpu_torch.train.vis import make_synthetic_batch, train_step

    cfg = get_config(name)
    if cfg.max_insts != 16 or cfg.num_frames != VIS_FRAMES:
        raise AssertionError(f"[{path}] not the preset's tube slots and clip length")
    model = KNetVIS(cfg, generator=torch.Generator().manual_seed(VIS_SEED), device=device)
    state = create_train_state(model, make_optimizer(model, steps_per_epoch=1000))
    batches = [make_synthetic_batch(cfg, 1, VIS_HW, seed=i, device=device)
               for i in range(VIS_TRAIN_STEPS)]
    frozen, trainable = _frozen_split(path, model)
    keys = []

    def step(batch):
        nonlocal state
        state, losses = train_step(state, batch)
        return losses

    def check_keys(got: set) -> bool:
        keys.append(got)
        return got == keys[0] and {"loss_rpn_seg", "s2_loss_dice", "tracker_s1_loss_cls",
                                   "tracker_s2_loss_dice", "total_loss"} <= got

    out = _timed_steps(path, step, batches, VIS_TRAIN_LAUNCHES, check_keys)
    _check_trained(path, model, frozen, trainable, need_nonzero)
    paths.launches[path] = out["launches"]
    paths.frame_ms[path] = out["step_ms"]
    # the step's 22 problems (4 per-frame sets of B*T = 5, 2 tube sets of B = 1)
    with torch.no_grad():
        costs, valids = knet_vis_costs(model(batches[-1].clip), batches[-1].gt, cfg)
    out["hungarian"] = _hungarian_record(path, gt_rows(torch.cat(costs), torch.cat(valids)))
    del model, state
    return out


def _segments(pred, cfg) -> tuple:
    """(panoptic_seg, segments_info) of a panoptic prediction on the host."""
    from video_knet_tpu_torch.ops.panoptic import segments_to_host

    return segments_to_host(type(pred.result)(*(x.cpu() for x in pred.result)),
                            cfg.num_thing_classes)


def _serve_images(path: str, model, cfg, decode, paths: Paths, hw=IMAGE_HW,
                  count: int = IMAGE_COUNT) -> tuple[list, dict]:
    """`count` seeded images of `hw` through `model` and `decode(rpn_out,
    stage_outs) -> host result`, each timed with a synchronize: 4 launches
    of each mask kernel an image; median ms, peak memory."""
    images = [torch.from_numpy(f).to(model.rpn_head.init_kernels.device)
              for f in _frames(hw, count)]

    def run(i):
        with torch.no_grad():
            out = decode(*model(images[i]))
        torch.cuda.synchronize()
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    results = paths.drive(path, run, list(range(count)), per_item=IMAGE_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    ms = paths.frame_ms[path]
    med = statistics.median(ms[1:])
    log(f"[{path}] median {med:.2f} ms an image over images 1..{count - 1}; peak memory "
        f"{peak / 2**30:.3f} GiB ({peak} bytes)")
    return results, dict(median_ms=med, image_ms=ms, peak_bytes=peak, images=images)


def _check_segments(path: str, results, hw) -> None:
    """Host panoptic results: id maps of `hw` whose ids are the segments'."""
    for i, (pan, infos) in enumerate(results):
        if pan.shape != hw:
            raise AssertionError(f"[{path}] image {i}: id map of shape {pan.shape}")
        ids = {s["id"] for s in infos}
        if set(np.unique(pan).tolist()) - {0} != ids:
            raise AssertionError(f"[{path}] image {i}: segments {infos} vs ids in the map")
        if not all(np.isfinite(s.get("score", 0.0)) for s in infos):
            raise AssertionError(f"[{path}] image {i}: non-finite scores")
    log(f"[{path}] image 0: {len(results[0][1])} segments "
        f"({sum(s['isthing'] for s in results[0][1])} things)")


def phase_image_pan(device, paths: Paths) -> dict:
    """Image K-Net R-50, COCO panoptic preset (100 + 53 kernels), seeded
    random weights, score gate at zero: forward, `panoptic_decode` and
    `segments_to_host` on 5 images of 800x1344."""
    from video_knet_tpu_torch.configs import get_config
    from video_knet_tpu_torch.models.knet import KNet, panoptic_decode

    cfg = get_config("knet_s3_r50_fpn_ms-3x_coco-panoptic")
    cfg = dataclasses.replace(cfg, test=dataclasses.replace(cfg.test, instance_score_thr=0.0))
    if (cfg.num_proposals + cfg.num_stuff_classes, cfg.num_classes) != (COCO_PAN_KERNELS, 133):
        raise AssertionError("[image-pan] not the COCO panoptic class split")
    model = KNet(cfg, generator=torch.Generator().manual_seed(IMAGE_SEED), device=device)
    results, out = _serve_images(
        "image-pan", model, cfg,
        lambda rpn, stages: _segments(panoptic_decode(rpn, stages, cfg, out_hw=IMAGE_HW), cfg),
        paths)
    _check_segments("image-pan", results, IMAGE_HW)
    del model
    return out


def phase_image_inst_deform(device, paths: Paths) -> dict:
    """Image K-Net R-50 with the 6-layer MSDeformAttn decoder, COCO instance
    preset (80 classes, no stuff rows): forward and `instance_decode` on 5
    images of 800x1344; then the encoder's share of the forward and the
    sampling alone at this shape."""
    from video_knet_tpu_torch.configs import get_config
    from video_knet_tpu_torch.models.knet import KNet, instance_decode

    cfg = get_config("knet_s3_r50_deformable_fpn_ms-3x_coco")
    model = KNet(cfg, generator=torch.Generator().manual_seed(IMAGE_SEED), device=device)
    if model.neck.num_layers != 6 or cfg.num_stuff_classes != 0:
        raise AssertionError("[image-inst-deform] not the deformable COCO instance preset")
    raw = {}

    def decode(rpn, stages):
        raw["cls"] = stages[-1].cls_score
        return instance_decode(rpn, stages, cfg, out_hw=IMAGE_HW)

    preds, out = _serve_images("image-inst-deform", model, cfg, decode, paths)
    k = cfg.test.max_per_img
    if tuple(raw["cls"].shape) != (1, cfg.num_proposals, 80):
        raise AssertionError(f"[image-inst-deform] cls of shape {tuple(raw['cls'].shape)}")
    for i, p in enumerate(preds):
        if tuple(p.masks.shape) != (k, *IMAGE_HW) or p.labels.shape[0] != k:
            raise AssertionError(f"[image-inst-deform] image {i}: {k} slots expected")
        if not (bool(torch.isfinite(p.masks).all()) and bool(torch.isfinite(p.scores).all())):
            raise AssertionError(f"[image-inst-deform] image {i}: non-finite decode")
        if not bool(((p.labels >= 0) & (p.labels < 80)).all()):
            raise AssertionError(f"[image-inst-deform] image {i}: labels outside [0, 80)")
    out.update(_encoder_share(model, out.pop("images")[0]))
    del model
    return out


def _event_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event ms of eager calls (host dispatch included)."""
    times = []
    for _ in range(reps + 1):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[1:])


def _encoder_share(model, img) -> dict:
    """The deformable forward, the neck and its encoder layers alone (their
    inputs captured from the forward), each in CUDA-event ms of eager calls;
    then `ms_deform_attn_core` alone at the first layer's shape."""
    neck = model.neck
    layers = [getattr(neck, f"layer{i}") for i in range(neck.num_layers)]
    captured = {}

    def grab(key):
        def hook(module, args):
            captured.setdefault(key, args)
        return hook

    hooks = [layers[0].register_forward_pre_hook(grab("layer")),
             layers[0].self_attn.register_forward_pre_hook(grab("attn"))]
    with torch.no_grad():
        feats = model.backbone(img)
        model(img)
    for h in hooks:
        h.remove()
    query, ref, shapes = captured["layer"]

    def encoder():
        q = query
        for layer in layers:
            q = layer(q, ref, shapes)

    with torch.no_grad():
        fwd = _event_ms(lambda: model(img))
        neck_ms = _event_ms(lambda: neck(feats))
        enc = _event_ms(encoder)
        values, locs, attn = layers[0].self_attn.sampling_inputs(*captured["attn"])
        rec = _sampling_record(values, locs, attn)
    log(f"[image-inst-deform] forward {fwd:.3f} ms, neck {neck_ms:.3f} ms, its {len(layers)} "
        f"encoder layers {enc:.3f} ms ({enc / fwd:.1%} of the forward; CUDA events around "
        f"eager calls)")
    return dict(forward_ms=fwd, neck_ms=neck_ms, encoder_ms=enc, encoder_share=enc / fwd,
                sampling=rec)


def _sampling_record(values, locs, attn) -> dict:
    """`ms_deform_attn_core` (plain PyTorch gathers) on the given inputs: device
    time, the same sampling by `F.grid_sample` (one call a level, the same
    zero padding and half-pixel convention) and the bound."""
    import torch.nn.functional as F

    from video_knet_tpu_torch.ops.sampling import ms_deform_attn_core
    from video_knet_tpu_torch.tools.kernel_timing import device_ms

    b, q, m, l, p, _ = locs.shape
    d = values[0].shape[-1]

    def library():
        out = 0
        for li, v in enumerate(values):
            vm = v.permute(0, 3, 4, 1, 2).reshape(b * m, d, *v.shape[1:3])
            grid = locs[:, :, :, li].permute(0, 2, 1, 3, 4).reshape(b * m, q, p, 2) * 2 - 1
            s = F.grid_sample(vm, grid, mode="bilinear", padding_mode="zeros",
                              align_corners=False)  # [B*M, D, Q, P]
            w = attn[:, :, :, li].permute(0, 2, 1, 3).reshape(b * m, 1, q, p)
            out = out + (s * w).sum(-1)
        return out.reshape(b, m, d, q).permute(0, 3, 1, 2).reshape(b, q, m * d)

    got = ms_deform_attn_core(values, locs, attn)
    lib_err = float((library() - got).abs().max() / got.abs().max())
    ms = device_ms(lambda: ms_deform_attn_core(values, locs, attn))
    lib_ms = device_ms(library)
    samples = b * q * m * l * p
    io_bytes = 4 * (sum(v.numel() for v in values) + locs.numel() + attn.numel() + got.numel())
    # per sample and channel: three lerps (2 mul + 1 add each) and the
    # attention's multiply-add, fp32 on the CUDA cores
    flops = 11 * samples * d
    t_bytes = io_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / OPS_PEAK["fp32"][1] * 1e3
    rec = dict(name="ms_deform_attn_core", route="plain torch (index gathers)",
               source="video_knet_tpu_torch/ops/sampling.py",
               replaces="video_knet_tpu/ops/sampling.py:88 ms_deform_attn_core (no Pallas)",
               shape=[b, q, m, l, p, d], levels=[list(v.shape[1:3]) for v in values], ms=ms,
               library_ms=lib_ms, library="F.grid_sample a level", library_rel_err=lib_err,
               bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops
               else "operations")
    log(f"[sampling] ms_deform_attn_core at B={b} Q={q} M={m} L={l} P={p} D={d}: device "
        f"{ms * 1e3:.2f} us, grid_sample {lib_ms * 1e3:.2f} us (agrees within {lib_err:.1e}), "
        f"bound {rec['bound_ms'] * 1e3:.2f} us ({rec['bound_by']}; {io_bytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.3f} GFLOP)")
    return rec


def phase_image_train(device, paths: Paths) -> dict:
    """Image K-Net training, Cityscapes-STEP R-50 preset, B=8 crops of
    512x1024, 32 GT slots: 3 steps of `train/image.py:train_step`."""
    from video_knet_tpu_torch.configs import get_config
    from video_knet_tpu_torch.models.knet import KNet
    from video_knet_tpu_torch.train.image import make_synthetic_batch, train_step
    from video_knet_tpu_torch.train.optim import make_optimizer
    from video_knet_tpu_torch.train.train_state import create_train_state

    cfg = get_config("knet_s3_r50_fpn_cityscapes_step")
    if (cfg.max_insts, cfg.num_proposals + cfg.num_stuff_classes) != (32, 117):
        raise AssertionError("[image-train] not the Cityscapes-STEP preset")
    model = KNet(cfg, generator=torch.Generator().manual_seed(IMAGE_SEED), device=device)
    state = create_train_state(model, make_optimizer(model, steps_per_epoch=1000))
    batches = [make_synthetic_batch(cfg, IMAGE_TRAIN_B, IMAGE_TRAIN_HW, seed=i, device=device)
               for i in range(IMAGE_TRAIN_STEPS)]
    frozen, trainable = _frozen_split("image-train", model)

    def step(batch):
        nonlocal state
        state, losses = train_step(state, batch)
        return losses

    out = _timed_steps("image-train", step, batches, IMAGE_TRAIN_LAUNCHES,
                       lambda keys: keys == IMAGE_LOSS_KEYS | {"total_loss"})
    _check_trained("image-train", model, frozen, trainable)
    paths.launches["image-train"] = out["launches"]
    paths.frame_ms["image-train"] = out["step_ms"]
    del model, state
    return out


def _image_card_vs_cpu(device, cfg, tag: str, train: bool, worst: dict) -> dict | None:
    """A check configuration of the image K-Net (`train_check.
    image_check_model`, weights from `train_check.image_margin_seed`), card
    against CPU: the forward and the decode (panoptic, or instance without
    stuff rows); with `train`, one train step with the CPU replaying the
    card's ReLU decisions. Updates `worst`; returns the card's launches of
    the forward and the step (None without `train`)."""
    from video_knet_tpu_torch.models import knet as tk
    from video_knet_tpu_torch.tools import train_check
    from video_knet_tpu_torch.train.image import make_synthetic_batch

    instance = cfg.num_stuff_classes == 0
    seed, margin = train_check.image_margin_seed(cfg, CHECK_HW)
    runs, pattern = [], []
    for dev in (device, torch.device("cpu")):
        model = train_check.image_check_model(cfg, seed, dev)
        batch = make_synthetic_batch(cfg, 1, CHECK_HW, seed=0, device=dev)
        _reset_counts()
        with torch.no_grad():
            outs = model(batch.img)
            if instance:
                pred = tk.instance_decode(*outs, cfg, out_hw=CHECK_HW)
                dec = dict(labels=pred.labels.cpu(), scores=pred.scores.cpu(),
                           masks=pred.masks.cpu())
            else:
                pred = tk.panoptic_decode(*outs, cfg, out_hw=CHECK_HW)
                dec = {f: getattr(pred.result, f).cpu() for f in pred.result._fields}
        fwd = _counts()
        run = dict(outs=_leaf_tensors(outs), dec=dec, fwd=fwd)
        if train:
            _reset_counts()
            # the CPU's step (the second run) follows the card's ReLU decisions
            with train_check.relu_pattern(pattern, replay=bool(runs)) as relus:
                rpn_out, stage_outs = model(batch.img)
            losses = tk.knet_loss(rpn_out, stage_outs, batch.gt, cfg)
            sum(losses.values()).backward()
            run["train"] = _counts()
            costs = tk.branch_assignment_costs(rpn_out, stage_outs, batch.gt, cfg)
            run.update(g2p=[a.cpu() for a in tk.solve_assignments(costs, batch.gt.valid)[0]],
                       losses={k: float(v.detach()) for k, v in losses.items()},
                       grads=_grads(model))
        runs.append(run)
    g, c = runs  # the card's run, the CPU's
    if {k: g["fwd"][k] for k in KERNELS} != IMAGE_LAUNCHES:
        raise AssertionError(f"[{tag}] forward launches {g['fwd']}")
    err = max(float((g["outs"][k] - w).abs().max() / max(float(w.abs().max()), 1e-6))
              for k, w in c["outs"].items())
    worst["outputs"] = max(worst["outputs"], err)
    if set(g["outs"]) != set(c["outs"]) or not err <= TOL_IMAGE_CHECK:
        raise AssertionError(f"[{tag}] forward outputs differ: {err}")
    for f, want in c["dec"].items():
        got = g["dec"][f]
        if want.is_floating_point():
            rel = float((got - want).abs().max() / max(float(want.abs().max()), 1e-6))
            if not rel <= TOL_IMAGE_CHECK:
                raise AssertionError(f"[{tag}] decoded {f}: {rel}")
        elif not torch.equal(got, want):
            raise AssertionError(f"[{tag}] decoded {f} differ")
    log(f"[{tag}] weight seed {seed}, margin {margin:.2e}: {len(c['outs'])} forward outputs "
        f"within {err:.2e} relative; decode integers equal")
    if not train:
        return None
    if g["train"] != IMAGE_TRAIN_LAUNCHES:
        raise AssertionError(f"[{tag}] train launches {g['train']}")
    if not all(torch.equal(a, b) for a, b in zip(g["g2p"], c["g2p"])):
        raise AssertionError(f"[{tag}] card and CPU assignments differ")
    worst["losses"] = max(worst["losses"], max(abs(g["losses"][k] - v) / max(abs(v), 1e-6)
                                               for k, v in c["losses"].items()))
    if set(g["losses"]) != set(c["losses"]) or not worst["losses"] <= 1e-4:
        raise AssertionError(f"[{tag}] losses differ: {worst['losses']}")
    for k, want in c["grads"].items():
        scale = float(want.abs().max())
        if k.endswith("key.bias"):  # zero up to rounding: softmax ignores it
            scale = float(c["grads"][k[:-len("bias")] + "weight"].abs().max())
        err = float((g["grads"][k] - want).abs().max())
        worst["grads"] = max(worst["grads"], err / max(scale, 1e-12))
        if not err <= 1e-3 * max(scale, 1e-12):
            raise AssertionError(f"[{tag}] gradient of {k}: {err} vs scale {scale}")
    log(f"[{tag}] train step: {len(c['g2p'])} assignment sets equal, losses within "
        f"{worst['losses']:.2e} relative (limit 1e-4), gradients within {worst['grads']:.2e} "
        f"of each leaf's scale (limit 1e-3), the CPU on the card's decisions at "
        f"{relus['calls']} ReLUs ({relus['differ']} elements decided otherwise)")
    return {k: g["fwd"][k] + g["train"][k] for k in g["train"]}


def phase_image_check(device, paths: Paths) -> dict:
    """The tiny image config (`train_check.image_check_cfg`: MiT-b0,
    64-channel heads, the MSDeformAttn neck with one encoder layer; panoptic
    and instance), card against CPU (whose agreement with the JAX package
    the CPU tests hold), weights from `train_check.image_margin_seed`: the
    forward and both decodes, then one panoptic train step; then
    `ms_deform_attn_core` alone at the COCO deformable shape, card fp32
    against CPU fp32 and fp64."""
    from video_knet_tpu_torch.config import KNetConfig
    from video_knet_tpu_torch.tools import train_check

    worst = {"outputs": 0.0, "losses": 0.0, "grads": 0.0}
    for instance in (False, True):
        cfg = train_check.image_check_cfg(KNetConfig(), instance=instance)
        tag = "instance" if instance else "panoptic"
        launches = _image_card_vs_cpu(device, cfg, f"image-check {tag}", not instance, worst)
        if launches is not None:
            paths.launches["image-check"] = launches
    worst["sampling"] = _sampling_vs_cpu(device)
    return worst


def _sampling_vs_cpu(device) -> dict:
    """`ms_deform_attn_core` at the COCO deformable shape (800x1344: the
    encoder's levels 100x168, 50x84, 25x42; Q = 22050; 8 heads of 32, 4
    points), seeded inputs with ~1/6 of the points off the map, on the card
    in fp32 against the CPU in fp32 and in fp64."""
    from video_knet_tpu_torch.ops.sampling import ms_deform_attn_core

    gen = torch.Generator().manual_seed(SEED)
    shapes = [(IMAGE_HW[0] // s, IMAGE_HW[1] // s) for s in (8, 16, 32)]
    q, m, l, p, d = sum(h * w for h, w in shapes), 8, 3, 4, 32
    values = [torch.randn(1, h, w, m, d, generator=gen) for h, w in shapes]
    locs = torch.rand(1, q, m, l, p, 2, generator=gen) * 1.2 - 0.1
    attn = torch.softmax(torch.randn(1, q, m, l * p, generator=gen), -1).reshape(1, q, m, l, p)
    got = ms_deform_attn_core([v.to(device) for v in values], locs.to(device),
                              attn.to(device)).cpu().double()
    errs = {}
    for prec, dtype in (("fp32", torch.float32), ("fp64", torch.float64)):
        want = ms_deform_attn_core([v.to(dtype) for v in values], locs.to(dtype),
                                   attn.to(dtype)).double()
        errs[prec] = float((got - want).abs().max() / want.abs().max())
    log(f"[image-check] ms_deform_attn_core at Q={q}, levels {shapes}: card fp32 vs CPU, max "
        f"abs err / scale {errs} (limits {TOL_SAMPLING})")
    if not all(errs[k] <= TOL_SAMPLING[k] for k in errs):
        raise AssertionError(f"[image-check] sampling on the card disagrees with the CPU: {errs}")
    return errs


def phase_vis_deform(device, paths: Paths) -> dict:
    """The deformable R-50 YouTube-VIS 2019 preset: 3 clips of 1x5x360x640
    served as `vis` serves them (the neck over the B*T frames), then 3 train
    steps as `vis-train` takes them (the deformable neck's backward)."""
    from video_knet_tpu_torch.configs import get_config

    name = "video_knet_vis_r50_deformable_ytvis2019"
    cfg = get_config(name)
    if cfg.neck_type != "msdeform_pixel_decoder":
        raise AssertionError("[vis-deform] not the deformable preset")
    serve = _serve_vis("vis-deform", cfg, device, paths, VIS_CLIPS, VIS_LAUNCHES)
    # the neck's gradients must all be nonzero; elsewhere a clip stage whose
    # random-weight masks pass no pixel over its hard threshold leaves the
    # next stage's dynamic layer a zero gradient, as the reference would
    train = phase_vis_train(device, paths, name, "vis-deform-train", need_nonzero="neck.")
    return dict(serve=serve, train=train)


class _NumpyFeatures:
    """appearance_fn of the card-vs-CPU unitrack check: the same seeded numpy
    features a frame on both devices (a 64x96 frame's stride-8 map)."""

    def __init__(self):
        self.rng = np.random.RandomState(SEED)

    def __call__(self, img):
        return self.rng.randn(1, 8, 12, 16).astype(np.float32)


def _track_counts(results) -> list:
    return [len(np.unique(r.track_map[r.track_map > 0])) for r in results]


def phase_trackers(device, paths: Paths) -> None:
    """The R-50 release preset (score gates at zero, seeded random weights)
    on the TAO, simple and overlap host trackers, 8 frames of 384x1248 each;
    then the trained tiny model on the four host trackers (unitrack fed the
    same numpy features on both devices), card against CPU: integer maps and
    segments equal, segment scores within 1e-4."""
    from video_knet_tpu_torch.models.video.inference import VPSInferencePipeline
    from video_knet_tpu_torch.tools import trained_golden as tg
    from video_knet_tpu_torch.tools.profile_serving import smoke_config, smoke_model

    cfg = smoke_config()
    model = smoke_model(cfg, device)
    frames = [torch.from_numpy(f).to(device) for f in _frames(SERVE_HW, TRACKER_FRAMES)]
    for tracker_type in ("tao", "simple", "overlap"):
        path = f"trackers-{tracker_type}"
        pipe = VPSInferencePipeline(model, cfg, SERVE_HW, tracker_type=tracker_type,
                                    device=device)
        res = paths.drive(path, lambda i: pipe.run_frame(frames[i], is_first=(i == 0)),
                          list(range(TRACKER_FRAMES)))
        _check_maps(path, res, SERVE_HW)
        log(f"[{path}] things per frame {[sum(s['isthing'] for s in r.segments_info) for r in res]}"
            f"; track ids per frame {_track_counts(res)}")
    del model
    cpu = torch.device("cpu")
    models = [tg.tiny_model(device), tg.tiny_model(cpu)]
    tframes = tg.eval_frames()
    idx = list(range(tg.N_FRAMES))
    for tracker_type in HOST_TRACKERS:
        runs = []  # card, then CPU
        for dev, tiny in zip((device, cpu), models):
            pipe = VPSInferencePipeline(
                tiny, tg.tiny_cfg(), tg.HW, tracker_type=tracker_type, device=dev,
                appearance_fn=_NumpyFeatures() if tracker_type == "unitrack" else None)
            run = lambda i: pipe.run_frame(tframes[i], is_first=(i == 0))  # noqa: E731
            res = (paths.drive(f"trained-{tracker_type}", run, idx) if not runs
                   else [run(i) for i in idx])
            runs.append(tg.flatten_results(res))
        g, c = runs
        for k, want in c.items():
            same = (np.allclose(g[k], want, atol=1e-4) if k.startswith("seg_score_")
                    else np.array_equal(g[k], want))
            if not same:
                raise AssertionError(f"[trained-{tracker_type}] card and CPU differ at {k}")
        log(f"[trained-{tracker_type}] card equals CPU on every integer field of "
            f"{tg.N_FRAMES} frames; track-id spans {tg.track_id_spans(g)}")


def phase_unitrack(device, paths: Paths) -> dict:
    """`video_knet_kitti_step_unitrack` (R-50, no linking; score gates at
    zero, seeded random weights) on the unitrack tracker, 6 frames of
    384x1248 with each appearance encoder: frame ms, the encoder's ms (CUDA
    events around eager calls), the `app_feat` bytes a frame and its copy to
    the host alone."""
    from video_knet_tpu_torch.configs import get_config
    from video_knet_tpu_torch.models.video.appearance import (
        make_appearance_fn,
        make_appearance_model,
    )
    from video_knet_tpu_torch.models.video.inference import VPSInferencePipeline
    from video_knet_tpu_torch.tools.profile_serving import smoke_config, smoke_model
    from video_knet_tpu_torch.utils.tree import to_host

    cfg = smoke_config(get_config("video_knet_kitti_step_unitrack"))
    if cfg.link_previous:
        raise AssertionError("[unitrack] the preset links kernels")
    model = smoke_model(cfg, device)
    frames = [torch.from_numpy(f).to(device) for f in _frames(SERVE_HW, UNITRACK_FRAMES)]
    out = {}
    for name, kw in UNITRACK_ENCODERS:
        path = f"unitrack-{name}"
        fn = make_appearance_fn(make_appearance_model(name, device=device, **kw))
        feat = fn(frames[0])
        h, w = SERVE_HW[0] // 8, SERVE_HW[1] // 8
        if feat.shape[:3] != (1, h, w) or not bool(torch.isfinite(feat).all()):
            raise AssertionError(f"[{path}] features of shape {tuple(feat.shape)}")
        pipe = VPSInferencePipeline(model, cfg, SERVE_HW, tracker_type="unitrack",
                                    device=device, appearance_fn=fn)
        res = paths.drive(path, lambda i: pipe.run_frame(frames[i], is_first=(i == 0)),
                          list(range(UNITRACK_FRAMES)))
        _check_maps(path, res, SERVE_HW)
        enc_ms = _event_ms(lambda: fn(frames[0]))
        fetch = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            to_host({"app_feat": feat})
            fetch.append((time.perf_counter() - t0) * 1e3)
        rec = dict(frame_ms=statistics.median(paths.frame_ms[path][1:]), encoder_ms=enc_ms,
                   app_feat_shape=list(feat.shape), app_feat_bytes=feat.numel() * 4,
                   fetch_ms=statistics.median(fetch[1:]))
        out[name] = rec
        log(f"[{path}] {json.dumps(rec)}; track ids per frame {_track_counts(res)}")
    del model
    return out


def _roi_align_record(device, x_feats, probs) -> dict:
    """`roi_align` at the served shape (the frame's fused features and its
    predicted masks' boxes): card against CPU, forward and gradient; its
    device time beside the bytes bound."""
    from video_knet_tpu_torch.models.video.roi_track_head import masks_to_boxes
    from video_knet_tpu_torch.ops.sampling import roi_align
    from video_knet_tpu_torch.tools.kernel_timing import device_ms

    feat = x_feats[0].detach().float()
    boxes = masks_to_boxes(probs[0].float())
    scale = feat.shape[1] / probs.shape[-1]
    weight = torch.randn((boxes.shape[0], 7, 7, feat.shape[-1]),
                         generator=torch.Generator().manual_seed(SEED))
    got = []  # card, then CPU
    for dev in (device, torch.device("cpu")):
        f = feat.to(dev).clone().requires_grad_()
        y = roi_align(f, boxes.to(dev), spatial_scale=scale)
        (y * weight.to(dev)).sum().backward()
        got.append((y.detach().cpu(), f.grad.cpu()))
    errs = [float((a - b).abs().max() / b.abs().max().clamp(min=1e-12)) for a, b in zip(*got)]
    with torch.no_grad():
        ms = device_ms(lambda: roi_align(feat, boxes, spatial_scale=scale))
    # the samples gathered (4 corners of 2x2 points a bin) and the output
    io_bytes = 4 * (boxes.shape[0] * 49 * 16 * feat.shape[-1] + boxes.shape[0] * 49
                    * feat.shape[-1] + boxes.numel())
    rec = dict(shape=[list(feat.shape), list(boxes.shape)], max_rel_err=errs[0],
               grad_max_rel_err=errs[1], ms=ms, bound_ms=io_bytes / HBM_BYTES_PER_S * 1e3,
               empty_boxes=int((boxes == 0).all(dim=1).sum()))
    log(f"[roi-align] {json.dumps(rec)} (limit {TOL_ROI_ALIGN})")
    if not max(errs) <= TOL_ROI_ALIGN:
        raise AssertionError(f"[roi-align] card and CPU disagree: {errs}")
    return rec


def phase_track_head(device, paths: Paths, name: str, tag: str) -> dict:
    """A track-head preset (`video_knet_kitti_step_fuse_track` or
    `_roi_gt_box`; R-50): 6 frames of 384x1248 served on the device tracker
    (state as wide as the embeddings) and on the host tracker (id and
    semantic maps equal), score gates at zero; then 3 train steps of the
    preset at 384x1248 (7 / 7 / 1 launches, 0 syncs after the first; the
    RoI head leaves the last stage's link without a gradient, as the
    reference does)."""
    from video_knet_tpu_torch.configs import get_config
    from video_knet_tpu_torch.models.video.inference import (
        VPSInferencePipeline,
        _track_embed_dim,
    )
    from video_knet_tpu_torch.tools.profile_serving import smoke_config, smoke_model
    from video_knet_tpu_torch.train.vps import make_synthetic_batch, train_step

    preset = get_config(name)
    head = preset.track_head_type
    cfg = smoke_config(preset)
    model = smoke_model(cfg, device)
    frames = [torch.from_numpy(f).to(device) for f in _frames(SERVE_HW, HEAD_FRAMES)]
    width = _track_embed_dim(cfg)
    res = {}
    for tracker_type, path in (("quasi_dense", tag), ("quasi_dense_host", f"{tag}-host")):
        pipe = VPSInferencePipeline(model, cfg, SERVE_HW, tracker_type=tracker_type,
                                    device=device)
        res[path] = paths.drive(path, lambda i: pipe.run_frame(frames[i], is_first=(i == 0)),
                                list(range(HEAD_FRAMES)))
        _check_maps(path, res[path], SERVE_HW)
        if pipe.device_tracker and (pipe.track_state.embeds.shape[1] != width or
                                    not bool(torch.isfinite(pipe.track_state.embeds).all())):
            raise AssertionError(f"[{path}] tracker state {tuple(pipe.track_state.embeds.shape)}")
        log(f"[{path}] track ids per frame {_track_counts(res[path])}")
    for i, (a, b) in enumerate(zip(res[f"{tag}-host"], res[tag])):
        agree = _agreement(a, b)
        if agree["panoptic_seg"] != 1.0 or agree["semantic_map"] != 1.0:
            raise AssertionError(f"[{tag}-host] frame {i} disagrees with the device tracker")
    with torch.no_grad():
        out = model.test_step(frames[0], pipe.prev_obj_feats, True)
    emb = out["track_embeds"]
    if tuple(emb.shape) != (1, cfg.num_proposals, width) or not bool(torch.isfinite(emb).all()):
        raise AssertionError(f"[{tag}] track embeddings {tuple(emb.shape)}")
    rec = {"embed_width": width, "state_width": width}
    if head == "roi_gt_box":
        probs = torch.sigmoid(out["stage_outs"][-1].scaled_mask_preds[:, :cfg.num_proposals])
        rec["roi_align"] = _roi_align_record(device, out["rpn_out"].x_feats, probs)
    del model, out

    state = _train_model(preset, device)
    tmodel = state.model
    batches = [make_synthetic_batch(preset, 1, TRAIN_HW, seed=i, device=device)
               for i in range(TRAIN_STEPS)]
    frozen, trainable = _frozen_split(f"{tag}-train", tmodel)
    # the RoI head embeds GT boxes, not the linked kernels: the last stage's
    # link takes no gradient (nor does it in the reference)
    last = f"mask_head_{preset.num_stages - 1}."
    unused = [(n, p) for n, p in trainable if head == "roi_gt_box" and n.startswith(last)
              and "previous" in n]
    trainable = [(n, p) for n, p in trainable if n not in dict(unused)]
    keys = TRAIN_LOSS_KEYS - {"loss_track", "loss_track_aux"} | HEAD_LOSS_KEYS[head]

    def step(batch):
        nonlocal state
        state, losses = train_step(state, batch)
        return losses

    train = _timed_steps(f"{tag}-train", step, batches, TRAIN_LAUNCHES,
                         lambda got: got == keys | {"total_loss"})
    _check_trained(f"{tag}-train", tmodel, frozen, trainable)
    if any(p.grad is not None and float(p.grad.abs().max()) != 0.0 for _, p in unused):
        raise AssertionError(f"[{tag}-train] the unused link took a gradient")
    paths.launches[f"{tag}-train"] = train["launches"]
    paths.frame_ms[f"{tag}-train"] = train["step_ms"]
    log(f"[{tag}-train] {len(unused)} link parameters without a gradient (as the reference)")
    del state, tmodel
    rec.update(frame_ms={p: statistics.median(paths.frame_ms[p][1:]) for p in res},
               train=train)
    return rec


def phase_track_check(device, paths: Paths) -> dict:
    """The tiny check config (`train_check.track_check_cfg`: MiT-b0,
    64-channel heads) with each of the two heads, weights from
    `margin_seed`, card against CPU: the test step's outputs within 1e-4
    relative; one train step's assignments equal, losses within 1e-4,
    gradients within 1e-3 of each leaf's scale, the CPU replaying the card's
    ReLU decisions."""
    from video_knet_tpu_torch.models.knet import solve_lanes
    from video_knet_tpu_torch.models.video.knet_vps import (
        VideoKNet,
        video_knet_costs,
        video_knet_loss,
    )
    from video_knet_tpu_torch.tools import train_check
    from video_knet_tpu_torch.tools import trained_golden as tg
    from video_knet_tpu_torch.train.vps import make_synthetic_batch

    worst = {}
    for head in ("query_fuse", "roi_gt_box"):
        cfg = train_check.track_check_cfg(tg.tiny_cfg(), head)
        seed, margin = train_check.margin_seed(cfg, CHECK_HW)
        runs, pattern = [], []  # card, then CPU
        for dev in (device, torch.device("cpu")):
            model = VideoKNet(cfg, generator=torch.Generator().manual_seed(seed), device=dev)
            batch = make_synthetic_batch(cfg, 1, CHECK_HW, seed=0, device=dev)
            prev = torch.zeros((1, cfg.num_proposals + cfg.num_stuff_classes, 1,
                                cfg.head.in_channels), device=dev)
            _reset_counts()
            with torch.no_grad():
                out = model.test_step(batch.img, prev, True)
            fwd = _counts()
            _reset_counts()
            with train_check.relu_pattern(pattern, replay=bool(runs)) as relus:
                key, ref, ke, re = model.forward_train(batch.img, batch.ref_img, None,
                                                       batch.gt.masks, batch.ref_gt.masks)
            losses = video_knet_loss((key, ref), (ke, re), batch.gt, batch.ref_gt, cfg)
            sum(losses.values()).backward()
            step = _counts()
            g2p, p2g = solve_lanes(*video_knet_costs(key, ref, batch.gt, batch.ref_gt, cfg))
            last = out["stage_outs"][-1]
            runs.append(dict(
                outs={k: v.detach().cpu() for k, v in (
                    ("cls", last.cls_score), ("masks", last.mask_preds),
                    ("track_embeds", out["track_embeds"]), ("key_embeds", ke),
                    ("ref_embeds", re))},
                losses={k: float(v.detach()) for k, v in losses.items()},
                g2p=torch.cat(g2p).cpu(), p2g=torch.cat(p2g).cpu(), grads=_grads(model),
                fwd=fwd, step=step))
        g, c = runs
        if {k: g["fwd"][k] for k in KERNELS} != {"mask_pool": 4, "assemble": 4} or \
                g["step"] != TRAIN_LAUNCHES:
            raise AssertionError(f"[track-check] {head}: card launches {g['fwd']}, {g['step']}")
        paths.launches[f"track-check-{head}"] = {k: g["fwd"][k] + g["step"][k]
                                                 for k in g["step"]}
        w = {"outs": max(float((g["outs"][k] - v).abs().max() / v.abs().max().clamp(min=1e-6))
                         for k, v in c["outs"].items())}
        if not w["outs"] <= TOL_TRACK_CHECK:
            raise AssertionError(f"[track-check] {head}: outputs differ by {w['outs']}")
        if not (torch.equal(g["g2p"], c["g2p"]) and torch.equal(g["p2g"], c["p2g"])):
            raise AssertionError(f"[track-check] {head}: assignments differ")
        w["losses"] = max(abs(g["losses"][k] - v) / max(abs(v), 1e-6)
                          for k, v in c["losses"].items())
        if set(g["losses"]) != set(c["losses"]) or not w["losses"] <= 1e-4:
            raise AssertionError(f"[track-check] {head}: losses differ by {w['losses']}")
        w["grads"] = 0.0
        for k, want in c["grads"].items():
            scale = float(want.abs().max())
            if k.endswith("key.bias"):  # zero up to rounding: softmax ignores it
                scale = float(c["grads"][k[:-len("bias")] + "weight"].abs().max())
            err = float((g["grads"][k] - want).abs().max())
            w["grads"] = max(w["grads"], err / max(scale, 1e-12))
            if not err <= 1e-3 * max(scale, 1e-12):
                raise AssertionError(f"[track-check] {head}: gradient of {k}: {err} vs {scale}")
        log(f"[track-check] {head}: weight seed {seed} (margin {margin:.2e}); outputs within "
            f"{w['outs']:.2e} (limit {TOL_TRACK_CHECK}), assignments equal, losses within "
            f"{w['losses']:.2e}, gradients within {w['grads']:.2e} of each leaf's scale, the "
            f"CPU on the card's decisions at {relus['calls']} ReLUs ({relus['differ']} elements "
            f"decided otherwise); card launches {g['fwd']} + {g['step']}")
        worst[head] = w
    return worst


def _fingerprint(t: torch.Tensor) -> bytes:
    import hashlib

    t = t.detach().cpu().contiguous()
    return hashlib.blake2b(t.numpy().tobytes() + str((t.dtype, tuple(t.shape))).encode(),
                           digest_size=16).digest()


def phase_import_ref(device, paths: Paths) -> dict:
    """A seeded synthetic joint-train Video K-Net R-50 checkpoint under the
    reference's key names at the release widths, imported strictly into the
    default VideoKNet on the card: each tensor on the card equal to some
    source tensor after a layout rule and to the import's CPU tensor (which
    source key feeds which port key is held against JAX's importer on the
    CPU, `tests/test_torch_port_checkpoint.py`); then 8 frames of 384x1248
    served on the device tracker."""
    from video_knet_tpu_torch.config import VideoKNetConfig
    from video_knet_tpu_torch.models.video.inference import VPSInferencePipeline
    from video_knet_tpu_torch.models.video.knet_vps import VideoKNet
    from video_knet_tpu_torch.tools.reference_sd import add_joint_train_sd, build_reference_sd
    from video_knet_tpu_torch.utils.checkpoint import image_to_video_params
    from video_knet_tpu_torch.utils.torch_import import import_torch_knet

    gen = torch.Generator().manual_seed(IMPORT_SEED)
    sd = add_joint_train_sd(build_reference_sd(gen), gen)
    cfg = VideoKNetConfig()
    model = VideoKNet(cfg, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    imported = image_to_video_params(import_torch_knet(sd, strict=True))
    model.load_state_dict(imported, strict=True)
    torch.cuda.synchronize()
    import_ms = (time.perf_counter() - t0) * 1e3
    # the layout rules: a copy (conv OIHW, Linear [out, in], norms), a row
    # block of a packed MHA in_proj, or the init kernels' 1x1 conv squeezed
    sources = {}
    for k, v in sd.items():
        forms = [v]
        if k.endswith("in_proj_weight") or k.endswith("in_proj_bias"):
            forms += list(v.chunk(3))
        if k == "rpn_head.init_kernels.weight":
            forms.append(v[:, :, 0, 0])
        for f in forms:
            sources[_fingerprint(f)] = k
    own = model.state_dict()
    if set(own) != set(imported):
        raise AssertionError("[import-ref] the import does not cover the model")
    unmatched = [k for k, v in own.items() if _fingerprint(v) not in sources]
    differ = [k for k, v in own.items() if not torch.equal(v.cpu(), imported[k])]
    if unmatched or differ:
        raise AssertionError(f"[import-ref] tensors without their source {unmatched[:8]}; "
                             f"tensors changed by the load {differ[:8]}")
    used = {sources[_fingerprint(v)] for v in own.values()}
    log(f"[import-ref] {len(sd)} reference keys -> {len(own)} tensors on the card in "
        f"{import_ms:.1f} ms (import + load_state_dict), each equal to some source tensor "
        f"after a layout rule; {len(sd) - len(used)} source keys read and dropped (the earlier "
        f"stages' dead link layers)")

    pipe = VPSInferencePipeline(model, cfg, SERVE_HW, device=device)
    frames = [torch.from_numpy(f).to(device) for f in _frames(SERVE_HW, SERVE_FRAMES)]
    res = paths.drive("import-ref", lambda i: pipe.run_frame(frames[i], is_first=(i == 0)),
                      list(range(SERVE_FRAMES)))
    _check_maps("import-ref", res, SERVE_HW)
    ms = paths.frame_ms["import-ref"]
    med = statistics.median(ms[1:])
    log(f"[import-ref] segments per frame {[len(r.segments_info) for r in res]}; median "
        f"frame {med:.2f} ms")
    return dict(import_ms=import_ms, median_ms=med, results=res)


def _metrics_line(res: dict) -> dict:
    return {"PQ_k1": res["vpq_k1"]["PQ"], "PQ_k2": res["vpq_k2"]["PQ"],
            "STQ": res["stq"]["STQ"], "AQ": res["stq"]["AQ"], "mIoU": res["miou"]["mIoU"],
            "VC2": res["vc"]}


def phase_score(device, paths: Paths, served: list, vis_preds: list) -> dict:
    """The port's metrics: `import-ref`'s 8 frames, and a perturbed copy of
    the GT, against a seeded synthetic GT sequence at 384x1248 (window VPQ
    k = 1, 2, STQ, mIoU, video consistency; host ms a frame of each); the
    trained tiny model's 12 golden frames served on the card and on the
    CPU, every metric equal; the `vis` decodes as COCO results, every RLE
    decoding to its mask."""
    from video_knet_tpu_torch.data.rle import decode_mask
    from video_knet_tpu_torch.eval.coco_instance import instances_to_coco_json, segm2result
    from video_knet_tpu_torch.models.video.inference import VPSInferencePipeline
    from video_knet_tpu_torch.tools import eval_check
    from video_knet_tpu_torch.tools import trained_golden as tg

    gs, gi = eval_check.synthetic_sequence(SERVE_HW, len(served), seed=SCORE_SEED)
    hw = "x".join(map(str, SERVE_HW))
    # the served maps (random weights keep few segments), then a perturbed
    # copy of the GT, whose many matches give the eval loop its full work
    host_ms, metrics = {}, {}
    for what, (ps, pi) in (("served", ([r.semantic_map for r in served],
                                       [r.track_map for r in served])),
                           ("perturbed_gt", eval_check.perturb(gs, gi, seed=SCORE_SEED + 1))):
        res, host_ms[what] = eval_check.score(ps, pi, gs, gi)
        if not all(np.isfinite(v).all() for k, v in eval_check.flatten(res).items()
                   if v.dtype.kind == "f" and "per_class" not in k):
            raise AssertionError(f"[score] {what}: a non-finite metric")
        metrics[what] = _metrics_line(res)
        log(f"[score] {what}: {len(gs)} frames of {hw} against a seeded GT: "
            f"{json.dumps(metrics[what])}; host ms a frame {json.dumps(host_ms[what])}")

    runs = []  # card, then CPU
    frames = tg.eval_frames()
    gs, gi = eval_check.synthetic_sequence(tg.HW, tg.N_FRAMES, seed=SCORE_SEED)
    for dev in (device, torch.device("cpu")):
        model = tg.tiny_model(dev)
        pipe = VPSInferencePipeline(model, tg.tiny_cfg(), tg.HW, device=dev)
        fr = [torch.from_numpy(f).to(dev) for f in frames]
        if not runs:
            out = paths.drive("score-trained", lambda i: pipe.run_frame(fr[i], is_first=(i == 0)),
                              list(range(tg.N_FRAMES)))
        else:
            out = [pipe.run_frame(f, is_first=(i == 0)) for i, f in enumerate(fr)]
        got, _ = eval_check.score([r.semantic_map for r in out], [r.track_map for r in out],
                                  gs, gi)
        runs.append((got, eval_check.flatten(got)))
    (_, g), (trained, c) = runs
    differ = [k for k in c if not np.array_equal(g[k], c[k], equal_nan=c[k].dtype.kind == "f")]
    if set(g) != set(c) or differ:
        raise AssertionError(f"[score] card and CPU metrics differ: {differ[:8]}")
    log(f"[score] the trained tiny model's {tg.N_FRAMES} frames: {len(c)} metric fields equal "
        f"on the card and the CPU: {json.dumps(_metrics_line(trained))}")

    t0 = time.perf_counter()
    n_det = n_img = 0
    for clip, pred in enumerate(vis_preds):
        probs = torch.sigmoid(pred.masks)  # [T, K, H, W]
        for t in range(probs.shape[0]):
            _, segm = segm2result(probs[t], pred.labels, pred.scores, num_classes=len(VIS_CAT_IDS))
            dets = instances_to_coco_json(clip * 100 + t, probs[t], pred.labels, pred.scores,
                                          VIS_CAT_IDS)
            want = (probs[t] > 0.5).numpy()
            for k, d in enumerate(dets):
                if not np.array_equal(decode_mask(d["segmentation"]), want[k]):
                    raise AssertionError(f"[score] clip {clip} frame {t} detection {k}: the RLE "
                                         "does not decode to its mask")
            if sum(len(x) for x in segm) != len(dets):
                raise AssertionError("[score] segm2result and the JSON disagree on the count")
            n_det += len(dets)
            n_img += 1
    coco_ms = (time.perf_counter() - t0) * 1e3 / n_img
    log(f"[score] vis decodes: {n_det} detections on {n_img} frames of 360x640 to COCO results, "
        f"every RLE decoding to its mask; {coco_ms:.2f} ms a frame on the host")
    host_ms["coco_vis"] = coco_ms
    return dict(host_ms=host_ms, metrics=metrics)


def phase_ckpt(device, paths: Paths) -> dict:
    """Phase 12's training setup for 2 steps, saved, restored into a model and
    optimizer built from another seed: parameters, AdamW moments, step and
    learning rates bit-equal; one step from each state, with deterministic
    algorithms: losses equal, parameters within TOL_CKPT_STEP of each leaf's
    scale."""
    from video_knet_tpu_torch.config import VideoKNetConfig
    from video_knet_tpu_torch.train.vps import make_synthetic_batch, train_step
    from video_knet_tpu_torch.utils.checkpoint import (
        CHECKPOINT_FILE,
        restore_checkpoint,
        save_checkpoint,
    )

    cfg = VideoKNetConfig()
    state = _train_model(cfg, device)
    batches = [make_synthetic_batch(cfg, 1, TRAIN_HW, seed=i, device=device) for i in range(3)]

    def step(batch):
        nonlocal state
        state, losses = train_step(state, batch)
        return losses

    out = _timed_steps("ckpt", step, batches[:2], TRAIN_LAUNCHES,
                       lambda keys: keys == TRAIN_LOSS_KEYS | {"total_loss"})
    paths.launches["ckpt"] = out["launches"]
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_checkpoint(tmp, state, step=state.step)
        save_ms = (time.perf_counter() - t0) * 1e3
        nbytes = os.path.getsize(os.path.join(path, CHECKPOINT_FILE))
        restored = _train_model(cfg, device, seed=TRAIN_SEED + 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restore_checkpoint(path, restored)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3

    a, b = state.optimizer.adamw, restored.optimizer.adamw
    bad = [n for (n, x), (_, y) in zip(state.model.state_dict().items(),
                                       restored.model.state_dict().items())
           if x.device != y.device or not torch.equal(x, y)]
    for ga, gb in zip(a.param_groups, b.param_groups):
        if ga["lr"] != gb["lr"]:
            bad.append(f"lr of {ga['name']}")
        for p, q in zip(ga["params"], gb["params"]):
            bad += [f"{ga['name']} {k}" for k in ("exp_avg", "exp_avg_sq", "step")
                    if not torch.equal(a.state[p][k], b.state[q][k])]
    if bad or restored.step != state.step or state.step == 0:
        raise AssertionError(f"[ckpt] restored state differs: {bad[:8]}, step {restored.step}")
    log(f"[ckpt] step {state.step}: saved {nbytes} bytes in {save_ms:.1f} ms, restored in "
        f"{restore_ms:.1f} ms; parameters, buffers, AdamW moments, steps and lr bit-equal")

    # PyTorch's default backward sums some scatters (gather's backward) with
    # atomics in no fixed order: two identical backward passes differ in
    # rounding, and AdamW turns the rounding noise of the attention key
    # biases (true gradient zero) into whole lr-sized steps (PERF.md section
    # 6). So the compared steps run under `torch.use_deterministic_algorithms`.
    losses = {}
    torch.use_deterministic_algorithms(True)
    try:
        for name, st in (("original", state), ("restored", restored)):
            _reset_counts()
            st, out_l = train_step(st, batches[2])
            launches = _counts()
            if launches != TRAIN_LAUNCHES:
                raise AssertionError(f"[ckpt] {name} step: launches {launches}")
            losses[name] = {k: float(v) for k, v in out_l.items()}
            paths.launches["ckpt"] = {k: paths.launches["ckpt"][k] + launches[k]
                                      for k in launches}
    finally:
        torch.use_deterministic_algorithms(False)
    if losses["original"] != losses["restored"]:
        raise AssertionError(f"[ckpt] the next step's losses differ: {losses}")
    worst, n_differ = 0.0, 0
    with torch.no_grad():
        for x, y in zip(state.model.parameters(), restored.model.parameters()):
            err = float((x - y).abs().max())
            n_differ += err > 0
            worst = max(worst, err / max(float(x.abs().max()), 1e-12))
    if not worst <= TOL_CKPT_STEP:
        raise AssertionError(f"[ckpt] parameters after the next step differ by {worst}")
    log(f"[ckpt] the next step from either state, deterministic algorithms: losses equal "
        f"(total {losses['original']['total_loss']:.6f}), parameters within {worst:.2e} of "
        f"each leaf's scale (limit {TOL_CKPT_STEP}), {n_differ} parameter tensors not "
        f"bit-equal")
    return dict(save_ms=save_ms, restore_ms=restore_ms, bytes=nbytes, step_worst=worst,
                step_differ=n_differ, step_ms=out["step_ms"])


def _same_batch(a, b) -> bool:
    """Every field of two VPSBatches equal, bit for bit (b on the CPU)."""
    fields = [(a.img, b.img), (a.ref_img, b.ref_img), *zip(a.gt, b.gt), *zip(a.ref_gt, b.ref_gt)]
    return all(x.dtype == y.dtype and torch.equal(x.cpu(), y) for x, y in fields)


def phase_data(device, paths: Paths, root: str) -> dict:
    """The VPS data path: a seeded KITTI-STEP tree of 375x1242 frames written
    with the port's PNG writer, every file read back bit-equal; decode ms;
    the loader alone (host ms a batch at 1 and 4 threads; the CUDA batches
    equal the CPU loader's); then 4 R-50 train steps on loader-fed batches
    at 384x1248 (7 / 7 / 1 launches a step)."""
    from video_knet_tpu_torch.configs import get_config
    from video_knet_tpu_torch.data import KittiStepDVPS, VPSTrainLoader
    from video_knet_tpu_torch.data.panoptic_png import load_png
    from video_knet_tpu_torch.tools.data_check import write_kitti_step_tree
    from video_knet_tpu_torch.train.vps import train_step

    t0 = time.perf_counter()
    written = write_kitti_step_tree(root, n_seqs=DATA_SEQS, n_frames=DATA_FRAMES, hw=DATA_HW,
                                    n_things=DATA_THINGS, seed=DATA_SEED)
    write_s = time.perf_counter() - t0
    bad = []
    for path, arr in written.items():
        got = load_png(path)
        if got.dtype != arr.dtype or not np.array_equal(got, arr):
            bad.append(path)
    if bad:
        raise AssertionError(f"[data] files that do not read back bit-equal: {bad}")
    decode_ms = {}
    for kind in ("leftImg8bit", "panoptic"):
        path = next(p for p in written if p.endswith(kind + ".png"))
        ms = []
        for _ in range(DATA_DECODE_READS):
            t0 = time.perf_counter()
            load_png(path)
            ms.append((time.perf_counter() - t0) * 1e3)
        decode_ms[kind] = statistics.median(ms)
    nbytes = sum(os.path.getsize(p) for p in written)
    log(f"[data] wrote {len(written)} PNGs of {DATA_HW[0]}x{DATA_HW[1]} ({nbytes} bytes) in "
        f"{write_s:.2f} s, each read back bit-equal; load_png median of {DATA_DECODE_READS} "
        f"reads: RGB frame {decode_ms['leftImg8bit']:.3f} ms, panoptic PNG "
        f"{decode_ms['panoptic']:.3f} ms")

    cfg = get_config("video_knet_kitti_step_r50")
    if (cfg.max_insts, cfg.num_stuff_classes, cfg.mask_assign_stride) != (32, 17, 2):
        raise AssertionError("[data] not the KITTI-STEP R-50 preset")
    ds = KittiStepDVPS(root, split="train", ref_seq_index=DATA_REF)

    def loader(dev, threads: int = 4):
        return VPSTrainLoader(ds, cfg, batch_size=1, crop_hw=TRAIN_HW, seed=DATA_SEED,
                              num_threads=threads, device=dev)

    loader_ms = {}
    for threads in (1, 4):
        ms, cpu_batches = [], []
        t0 = time.perf_counter()
        for b in loader("cpu", threads):
            ms.append((time.perf_counter() - t0) * 1e3)
            cpu_batches.append(b)
            t0 = time.perf_counter()
        loader_ms[threads] = dict(median_ms=statistics.median(ms[1:]),
                                  mean_ms=sum(ms) / len(ms), ms=[round(t, 3) for t in ms])
        log(f"[data] loader alone, {threads} thread(s), B=1 at {TRAIN_HW[0]}x{TRAIN_HW[1]}: "
            f"median {loader_ms[threads]['median_ms']:.2f} ms a batch over batches "
            f"1..{len(ms) - 1}, epoch mean {loader_ms[threads]['mean_ms']:.2f} ms; ms {ms}")
    gt = cpu_batches[0].gt
    cuda_batches = list(loader(device))
    if len(cuda_batches) != len(ds) or len(cpu_batches) != len(ds) or not all(
            b.img.device.type == device.type and _same_batch(b, c)
            for b, c in zip(cuda_batches, cpu_batches)):
        raise AssertionError("[data] the CUDA loader's batches differ from the CPU loader's")
    log(f"[data] {len(cuda_batches)} CUDA batches equal the CPU loader's in every field; batch "
        f"0: {int(gt.valid.sum())} thing slots of {cfg.max_insts}, {int(gt.sem_valid.sum())} "
        f"stuff classes, GT at {tuple(gt.masks.shape[-2:])}")
    del cuda_batches, cpu_batches

    state = _train_model(cfg, device, seed=DATA_SEED)
    model = state.model
    frozen, trainable = _frozen_split("data-train", model)
    batches = iter(loader(device))
    waits, fed = [], []

    def step(batch):
        nonlocal state
        if batch is None:  # loader-fed: the wait on the loader is part of the step
            t0 = time.perf_counter()
            batch = next(batches)
            waits.append((time.perf_counter() - t0) * 1e3)
            fed.append(batch)
        state, losses = train_step(state, batch)
        return losses

    keys_ok = lambda keys: keys == TRAIN_LOSS_KEYS | {"total_loss"}  # noqa: E731
    out = _timed_steps("data-train", step, [None] * DATA_TRAIN_STEPS, TRAIN_LAUNCHES, keys_ok)
    batches.close()  # stops the producer
    _check_trained("data-train", model, frozen, trainable)
    paths.launches["data-train"] = out["launches"]
    paths.frame_ms["data-train"] = out["step_ms"]
    # the same batches again with no loader thread running: the step alone
    alone = _timed_steps("data-train-alone", step, fed, TRAIN_LAUNCHES, keys_ok)
    paths.launches["data-train-alone"] = alone["launches"]
    out.update(wait_ms=waits, decode_ms=decode_ms, loader_ms=loader_ms,
               alone_median_ms=alone["median_ms"], alone_ms=alone["step_ms"])
    log(f"[data-train] waited on next(loader) {[round(w, 3) for w in waits]} ms a step; median "
        f"step (wait included) {out['median_ms']:.2f} ms while the loader's threads run, "
        f"{alone['median_ms']:.2f} ms on the same batches with none running")
    del model, state, fed
    return out


def phase_eval_hook(device, paths: Paths, root: str, tmp: str) -> dict:
    """`evaluate_vps` and `evaluate_image_panoptic`: (a) the trained tiny
    model over its sequence written as a KITTI-STEP tree, card and CPU,
    every metric equal, PQ and STQ above 0; (b) the R-50 device-tracker
    pipeline over `data`'s tree at 384x1248, 8 frames, the loop's host ms by
    part; (c) the Cityscapes-STEP R-50 image K-Net over 4 of its frames."""
    from video_knet_tpu_torch.configs import get_config
    from video_knet_tpu_torch.data import KittiStepDVPS
    from video_knet_tpu_torch.models.knet import KNet, panoptic_decode
    from video_knet_tpu_torch.models.video.inference import VPSInferencePipeline
    from video_knet_tpu_torch.tools import trained_golden as tg
    from video_knet_tpu_torch.tools.profile_serving import smoke_config, smoke_model
    from video_knet_tpu_torch.train.eval_hook import evaluate_image_panoptic, evaluate_vps

    def counted(path: str, n: int, fn, per_item: dict | None = None) -> dict:
        """fn() over n frames (or images), its launches counted; each item is
        credited the mean time."""
        def body():
            t0 = time.perf_counter()
            res = fn()
            return [res] * n, [(time.perf_counter() - t0) * 1e3 / n] * n
        return paths._counted(path, n, body, per_item)[0]

    # (a) the trained tiny model, card and CPU
    tree = tg.write_sequence(tmp)
    runs = []
    for dev in (device, torch.device("cpu")):
        pipe = VPSInferencePipeline(tg.tiny_model(dev), tg.tiny_cfg(), tg.HW, device=dev)
        go = lambda: evaluate_vps(pipe, KittiStepDVPS(tree), size_hw=tg.HW)  # noqa: E731
        runs.append(counted("eval-hook-trained", tg.N_FRAMES, go) if not runs else go())
    (card, cpu) = runs
    differ = [k for k in cpu if not np.array_equal(card[k], cpu[k])]
    if set(card) != set(cpu) or differ:
        log(f"[eval-hook] card and CPU metrics differ in {differ}: card "
            f"{ {k: card[k] for k in differ} } CPU { {k: cpu[k] for k in differ} }")
        raise AssertionError(f"[eval-hook] card and CPU metrics differ: {differ}")
    if not all(r["PQ"] > 0 and r["STQ"] > 0 for r in runs):
        raise AssertionError(f"[eval-hook] the trained model scores 0: {card}")
    scalars = {k: v for k, v in card.items() if not isinstance(v, np.ndarray)}
    log(f"[eval-hook] trained tiny model, {card['frames']} frames of 64x96 read from PNG: "
        f"{len(card)} metric fields equal on the card and the CPU: {json.dumps(scalars)}")

    # (b) R-50, device tracker, over data's tree at 384x1248
    ds = KittiStepDVPS(root, split="train")
    cfg = smoke_config()
    pipe = VPSInferencePipeline(smoke_model(cfg, device), cfg, SERVE_HW, device=device)
    stats = {}
    res = counted("eval-hook", EVAL_FRAMES, lambda: evaluate_vps(
        pipe, ds, size_hw=SERVE_HW, max_frames=EVAL_FRAMES, stats=stats))
    if res["frames"] != EVAL_FRAMES or not all(
            np.isfinite(v).all() for v in res.values() if not isinstance(v, (int, str))):
        raise AssertionError(f"[eval-hook] R-50: {res}")
    frame_ms = stats["total"] * 1e3 / EVAL_FRAMES
    host_ms = {k: stats[k] * 1e3 / EVAL_FRAMES for k in ("load", "decode", "resize", "vpq", "stq")}
    log(f"[eval-hook] R-50 device tracker, {EVAL_FRAMES} frames of {DATA_HW[0]}x{DATA_HW[1]} "
        f"served at {SERVE_HW[0]}x{SERVE_HW[1]}: {frame_ms:.2f} ms a frame; the loop's host ms a "
        f"frame {json.dumps({k: round(v, 3) for k, v in host_ms.items()})}; PQ {res['PQ']:.3f}, "
        f"STQ {res['STQ']:.4f}")

    # (c) the Cityscapes-STEP image K-Net over 4 frames
    icfg = get_config("knet_s3_r50_fpn_cityscapes_step")
    icfg = dataclasses.replace(icfg, test=dataclasses.replace(icfg.test, instance_score_thr=0.0))
    model = KNet(icfg, generator=torch.Generator().manual_seed(IMAGE_SEED), device=device)

    def decode_fn(img):
        with torch.no_grad():
            rpn, stages = model(img.to(device))
        return _segments(panoptic_decode(rpn, stages, icfg, out_hw=SERVE_HW), icfg)

    samples = [ds.frames[k] for k in ds.order[:EVAL_IMAGES]]
    img_res = counted("eval-hook-image", EVAL_IMAGES, lambda: evaluate_image_panoptic(
        decode_fn, samples, size_hw=SERVE_HW, thing_ids_in_seg=ds.thing_ids_in_seg,
        num_classes=19, class_names=ds.CLASSES), per_item=IMAGE_LAUNCHES)
    image_ms = paths.frame_ms["eval-hook-image"][0]
    table = img_res["table"].splitlines()
    if img_res["images"] != EVAL_IMAGES or len(table) != 21:
        raise AssertionError(f"[eval-hook] image: {img_res['images']} images, table {table}")
    log(f"[eval-hook] Cityscapes-STEP R-50 image K-Net, {EVAL_IMAGES} frames at "
        f"{SERVE_HW[0]}x{SERVE_HW[1]}: {image_ms:.2f} ms an image (load, forward, decode, score); "
        f"table first and last lines: {table[0]!r} / {table[-1]!r}")
    del model
    return dict(trained=scalars, frame_ms=frame_ms, host_ms=host_ms, image_ms=image_ms)


def _run_cli(name: str, argv: list, patches=(), stats: list | None = None) -> str:
    """The port's CLI `name` in process (its `main(argv)`), each (module,
    attribute, value) of `patches` set meanwhile; returns what it printed,
    which is also logged."""
    import importlib

    mod = importlib.import_module(f"video_knet_tpu_torch.tools.{name}")
    saved = [(m, a, getattr(m, a)) for m, a, _ in patches]
    out = io.StringIO()
    try:
        for m, a, v in patches:
            setattr(m, a, v)
        with contextlib.redirect_stdout(out):
            mod.main(argv) if stats is None else mod.main(argv, stats=stats)
    finally:
        for m, a, v in saved:
            setattr(m, a, v)
    for line in out.getvalue().splitlines():
        log(f"[{name}] {line}")
    return out.getvalue()


def _cli_counted(paths: Paths, path: str, n: int, run, per_item: dict | None = None,
                 after: int = 0) -> dict:
    """`run(stats)` (a CLI run over n frames or images) with the launch counts
    set to 0 just before and read just after. The CLI appends a timestamp as
    each item's outputs are written; `mean_ms` is the time from item
    `after`'s to the last one's over the items between. `test_step` writes a
    window's frames together (`run_sequence`), so its callers pass the last
    frame of the first sequence: the second sequence's frames, one window,
    end to end. `loop_ms` is the CLI's own printed loop time an item, where
    it prints one (first window included)."""
    stats: list = []

    def body():
        t0 = time.perf_counter()
        text = run(stats)
        stamps = [t0, *stats]
        return [text] * n, [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]

    text = paths._counted(path, n, body, per_item)[0]
    ms = paths.frame_ms[path]
    if len(ms) != n:
        raise AssertionError(f"[{path}] {len(ms)} timestamps for {n} items")
    rec = dict(text=text, ms=ms, first_ms=ms[0], mean_ms=sum(ms[after + 1:]) / (n - 1 - after))
    m = re.search(r"done: (\d+) frames in ([\d.]+)s", text)
    if m:
        if int(m.group(1)) != n:
            raise AssertionError(f"[{path}] printed {text!r}")
        rec["loop_ms"] = float(m.group(2)) * 1e3 / n
    log(f"[{path}] {n} items: {rec['mean_ms']:.2f} ms an item over items {after + 1}..{n - 1}"
        f"; the CLI's loop {rec.get('loop_ms', float('nan')):.2f} ms an item; first item "
        f"{ms[0]:.1f} ms with the model build; launches {paths.launches[path]}")
    return rec


def _same_pngs(path: str, a: str, b: str, ties=None) -> dict:
    """Every PNG under directory `a` decodes equal to the same file under
    `b`; `ties(relpath, got, want)` may excuse pixels (returns a bool mask
    of those allowed to differ). Returns {"files": n, "excused": pixels}."""
    from video_knet_tpu_torch.data.panoptic_png import load_png

    files = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs if f.endswith(".png"))
    others = sorted(os.path.relpath(os.path.join(d, f), b)
                    for d, _, fs in os.walk(b) for f in fs if f.endswith(".png"))
    if files != others or not files:
        raise AssertionError(f"[{path}] file lists differ: {len(files)} vs {len(others)}")
    excused = 0
    for f in files:
        got, want = load_png(os.path.join(a, f)), load_png(os.path.join(b, f))
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"[{path}] {f}: {got.dtype}{got.shape} vs {want.dtype}"
                                 f"{want.shape}")
        differ = got != want
        if differ.any():
            allowed = ties(f, got, want) if ties is not None else np.zeros_like(differ)
            if (differ & ~allowed).any():
                raise AssertionError(f"[{path}] {f}: {int(differ.sum())} pixels differ, "
                                     f"{int((differ & ~allowed).sum())} off the near-ties")
            excused += int(differ.sum())
    return {"files": len(files), "excused": excused}


def _trained_ckpt(tmp: str) -> str:
    from video_knet_tpu_torch.tools import trained_golden as tg
    from video_knet_tpu_torch.utils.checkpoint import save_checkpoint

    return save_checkpoint(os.path.join(tmp, "trained_ckpt"), tg.tiny_model("cpu"))


def phase_cli_step(device, paths: Paths, root: str, tmp: str) -> dict:
    """`tools/test_step` in process on the card: R-50 (seeded random
    weights, `smoke_config` gates) with the device tracker over `data`'s
    KITTI-STEP tree at 384x1248, then `eval_dvpq` and `eval_stq` over its
    output; the trained tiny model's 12 frames on the card and the CPU, every
    `_cat` / `_ins` / `final` map equal."""
    from video_knet_tpu_torch import config as tconfig
    from video_knet_tpu_torch.tools import trained_golden as tg
    from video_knet_tpu_torch.tools.profile_serving import smoke_config, smoke_model
    from video_knet_tpu_torch.utils.checkpoint import save_checkpoint

    ckpt = save_checkpoint(os.path.join(tmp, "r50_ckpt"),
                           smoke_model(smoke_config(), device))
    r50 = [(tconfig, "kitti_step_video_config", smoke_config)]
    n = DATA_SEQS * DATA_FRAMES
    out = os.path.join(tmp, "cli_step")
    argv = ["--data-root", root, "--split", "train", "--size", *map(str, SERVE_HW),
            "--checkpoint", ckpt, "--out", out]
    rec = _cli_counted(paths, "cli-step", n,
                       lambda stats: _run_cli("test_step", argv, r50, stats),
                       after=DATA_FRAMES - 1)
    gt = os.path.join(root, "video_sequence", "train")
    scores = {}
    for name, extra in (("eval_dvpq", ["--eval-frames", "1", "2"]), ("eval_stq", [])):
        t0 = time.perf_counter()
        text = _run_cli(name, [out, "--gt-dir", gt, *extra])
        scores[name] = dict(text=text.strip(), ms=(time.perf_counter() - t0) * 1e3)
        values = [float(v) for v in re.findall(r" (-?[\d.]+|nan|inf)\b", text)]
        if not values or not all(np.isfinite(v) for v in values):
            raise AssertionError(f"[{name}] printed {text!r}")
    log(f"[cli-step] R-50 test_step over {n} frames of {DATA_HW[0]}x{DATA_HW[1]} at "
        f"{SERVE_HW[0]}x{SERVE_HW[1]}: {rec['mean_ms']:.2f} ms a frame (second sequence); "
        f"the CLI's loop {rec['loop_ms']:.2f} ms a frame ({1e3 / rec['loop_ms']:.3f} "
        f"frames/s); eval_dvpq {scores['eval_dvpq']['ms']:.1f} ms, "
        f"eval_stq {scores['eval_stq']['ms']:.1f} ms over the {n} frames")

    # the trained tiny model, card and CPU
    trained = os.path.join(tmp, "trained")
    tiny_ckpt = _trained_ckpt(tmp)
    tiny = [(tconfig, "kitti_step_video_config", tg.tiny_cfg)]
    targv = ["--data-root", trained, "--split", "train", "--backbone", "mit_b0",
             "--size", *map(str, tg.HW), "--checkpoint", tiny_ckpt]
    outs = {d: os.path.join(tmp, f"cli_trained_{d}") for d in ("cuda", "cpu")}
    _cli_counted(paths, "cli-step-trained", tg.N_FRAMES, lambda stats: _run_cli(
        "test_step", [*targv, "--out", outs["cuda"]], tiny, stats))
    _run_cli("test_step", [*targv, "--out", outs["cpu"], "--device", "cpu"], tiny)
    same = _same_pngs("cli-step-trained", outs["cuda"], outs["cpu"])
    log(f"[cli-step-trained] {same['files']} PNGs of the trained tiny model's {tg.N_FRAMES} "
        f"frames equal on the card and the CPU")
    return dict(rec, ckpt=ckpt, scores=scores, tiny_ckpt=tiny_ckpt)


def _tta_split(device, root: str, frames: int = 3) -> dict:
    """Where a fused R-50 TTA frame's time goes (`fn.logits` on `data`'s
    first frames at SERVE_HW): host ms a frame in the keep-ratio resizes, in
    `bilinear_resize` of the 6 variants' logits to the base grid, and the
    rest (the 6 test_steps, each ending in its logits' copy to the host,
    the flips and the sum); the first frame is left out."""
    from video_knet_tpu_torch.data import tta as tta_mod
    from video_knet_tpu_torch.data.panoptic_png import load_png
    from video_knet_tpu_torch.tools.profile_serving import smoke_config, smoke_model

    cfg = smoke_config()
    fn = tta_mod.make_tta_semantic_fn(smoke_model(cfg, device), cfg, SERVE_HW,
                                      (0.75, 1.0, 1.25), flip=True, device=device)
    spent = {"keep_ratio_resize_pad": 0.0, "bilinear_resize": 0.0}

    def timed(name):
        inner = getattr(tta_mod, name)

        def f(*args, **kwargs):
            t0 = time.perf_counter()
            out = inner(*args, **kwargs)
            spent[name] += time.perf_counter() - t0
            return out
        return f

    imgs = sorted(f for f in os.listdir(os.path.join(root, "video_sequence", "train"))
                  if f.endswith("leftImg8bit.png"))[:frames + 1]
    saved = {k: getattr(tta_mod, k) for k in spent}
    try:
        for k in spent:
            setattr(tta_mod, k, timed(k))
        total = 0.0
        for i, f in enumerate(imgs):
            rgb = load_png(os.path.join(root, "video_sequence", "train", f))
            if i == 1:
                spent = dict.fromkeys(spent, 0.0)
                total = 0.0
            t0 = time.perf_counter()
            fn.logits(rgb)
            total += time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            setattr(tta_mod, k, v)
    split = {k: v * 1e3 / frames for k, v in spent.items()}
    split["total"] = total * 1e3 / frames
    split["forwards_and_rest"] = split["total"] - sum(v for k, v in split.items() if k != "total")
    log(f"[tta] fused logits of an R-50 frame at {SERVE_HW[0]}x{SERVE_HW[1]}, host ms a frame "
        f"(mean of {frames}): {json.dumps({k: round(v, 3) for k, v in split.items()})}")
    return split


def phase_tta(device, paths: Paths, root: str, tmp: str, ckpt: str, tiny_ckpt: str) -> dict:
    """`test_step --tta-scales 0.75 1.0 1.25 --tta-flip`: R-50 over `data`'s
    tree (28 launches of each mask kernel a frame); the trained tiny model's
    TTA run on the card and the CPU: `_ins` and `final`'s track channels
    equal, `_cat` equal but at pixels whose CPU fused logits are within twice
    the card-vs-CPU logit difference of a tie."""
    from video_knet_tpu_torch import config as tconfig
    from video_knet_tpu_torch.data.panoptic_png import load_png
    from video_knet_tpu_torch.data.tta import make_tta_semantic_fn, near_ties
    from video_knet_tpu_torch.tools import trained_golden as tg
    from video_knet_tpu_torch.tools.profile_serving import smoke_config

    n = DATA_SEQS * DATA_FRAMES
    argv = ["--data-root", root, "--split", "train", "--size", *map(str, SERVE_HW),
            "--checkpoint", ckpt, "--out", os.path.join(tmp, "cli_tta"), *TTA_ARGS]
    rec = _cli_counted(paths, "tta", n, lambda stats: _run_cli(
        "test_step", argv, [(tconfig, "kitti_step_video_config", smoke_config)], stats),
        per_item=TTA_LAUNCHES, after=DATA_FRAMES - 1)

    rec["split_ms"] = _tta_split(device, root)

    tiny = [(tconfig, "kitti_step_video_config", tg.tiny_cfg)]
    targv = ["--data-root", os.path.join(tmp, "trained"), "--split", "train", "--backbone",
             "mit_b0", "--size", *map(str, tg.HW), "--checkpoint", tiny_ckpt, *TTA_ARGS]
    outs = {d: os.path.join(tmp, f"tta_trained_{d}") for d in ("cuda", "cpu")}
    _cli_counted(paths, "tta-trained", tg.N_FRAMES, lambda stats: _run_cli(
        "test_step", [*targv, "--out", outs["cuda"]], tiny, stats), per_item=TTA_LAUNCHES)
    _run_cli("test_step", [*targv, "--out", outs["cpu"], "--device", "cpu"], tiny)
    card_fn, cpu_fn = (make_tta_semantic_fn(tg.tiny_model(d), tg.tiny_cfg(), tg.HW,
                                            (0.75, 1.0, 1.25), flip=True, device=d)
                       for d in (device, torch.device("cpu")))
    images = tg.sequence_images()
    worst = {"logit_err": 0.0, "tie_pixels": 0}

    def ties(rel, got, want):
        if not rel.endswith("_cat.png") and not rel.startswith("final"):
            return np.zeros(got.shape, bool)
        rgb = images[int(os.path.basename(rel)[:6])]
        card, cpu = card_fn.logits(rgb), cpu_fn.logits(rgb)
        err = float(np.abs(card - cpu).max())
        tie = near_ties(cpu, err)
        worst["logit_err"] = max(worst["logit_err"], err)
        worst["tie_pixels"] += int(tie.sum())
        return tie if got.ndim == 2 else np.stack([tie, np.zeros_like(tie),
                                                   np.zeros_like(tie)], -1)

    same = _same_pngs("tta-trained", outs["cuda"], outs["cpu"], ties)
    cats = [load_png(os.path.join(outs["cuda"], "panoptic", "0", f"{f:06d}_cat.png"))
            for f in range(tg.N_FRAMES)]
    log(f"[tta] R-50 TTA (3 scales x flip) over {n} frames: {rec['mean_ms']:.2f} ms a frame, "
        f"{rec['split_ms']['bilinear_resize']:.2f} ms of it resizing the variants' logits; "
        f"trained tiny model: {same['files']} PNGs equal on the card and the CPU, "
        f"{same['excused']} pixels differing at near-ties (fused-logit difference up to "
        f"{worst['logit_err']:.3e} where checked); {len(np.unique(np.concatenate(cats)))} "
        f"classes in its fused maps")
    return dict(rec, trained=same, worst=worst)


def phase_cli_eval(device, paths: Paths, root: str, tmp: str, ckpt: str) -> dict:
    """The other serving CLIs once each on the card: `test_vss` (R-50 over
    `data`'s tree), `test_dvps` (R-50 SemKITTI preset with seeded random
    weights over a seeded SemKITTI-DVPS tree; then `eval_dstq` over its
    output), `test_image` (the Cityscapes-STEP R-50 image K-Net over the
    KITTI-STEP frames), `test_coco_instance` (the COCO instance preset, two
    images at its 800x1344 default): ms a frame or an image, 4 launches of
    each mask kernel an item."""
    from video_knet_tpu_torch import config as tconfig
    from video_knet_tpu_torch import configs as tconfigs
    from video_knet_tpu_torch.tools.data_check import write_coco_images, write_semkitti_tree
    from video_knet_tpu_torch.tools.profile_serving import smoke_config

    out = {}
    n = DATA_SEQS * DATA_FRAMES
    vss = _cli_counted(paths, "cli-vss", n, lambda stats: _run_cli(
        "test_vss", ["--data-root", root, "--split", "train", "--size", *map(str, SERVE_HW),
                     "--checkpoint", ckpt, "--vc-windows", "2", "4"],
        [(tconfig, "kitti_step_video_config", smoke_config)], stats))
    want = "mIoU [\\d.]+  aAcc [\\d.]+\\n" + "".join(
        f"mVC{k} [\\d.]+\\n" for k in (2, 4) if k <= DATA_FRAMES)
    if not re.fullmatch(want, vss["text"]):
        raise AssertionError(f"[cli-vss] printed {vss['text']!r}")
    out["vss"] = vss

    semkitti = write_semkitti_tree(os.path.join(tmp, "semkitti"), n_frames=DVPS_FRAMES,
                                   hw=DATA_HW, seed=DATA_SEED)
    sem_cfg = smoke_config(tconfig.semkitti_video_config())
    dvps_out = os.path.join(tmp, "cli_dvps")
    dvps = _cli_counted(paths, "cli-dvps", DVPS_FRAMES, lambda stats: _run_cli(
        "test_dvps", ["--data-root", semkitti, "--size", *map(str, SERVE_HW), "--out",
                      dvps_out],
        [(tconfig, "semkitti_video_config", lambda: sem_cfg)], stats))
    depth = os.path.join(dvps_out, "depth", "0")
    if len(os.listdir(depth)) != DVPS_FRAMES:
        raise AssertionError(f"[cli-dvps] {len(os.listdir(depth))} depth maps")
    text = _run_cli("eval_dstq", [dvps_out, "--gt-dir", os.path.join(semkitti, "video_sequence",
                                                                    "val"),
                                  "--ann-mode", "class_instance", "--thing-ids",
                                  *map(str, range(11, 19))])
    # GT depth 2-90 m passed through, clipped at 80 m: every pixel within
    # 1.25 (90 / 80 = 1.125), those beyond 88 m outside 1.1
    dq = [float(v) for v in re.findall(r"DQ@[\d.]+ ([\d.]+)", text)]
    if len(dq) != 2 or dq[0] != 1.0 or not 0.9 < dq[1] < 1.0:
        raise AssertionError(f"[eval_dstq] printed {text!r}")
    out["dvps"] = dvps

    icfg = tconfigs.knet_s3_r50_fpn_cityscapes_step()
    icfg = dataclasses.replace(icfg, test=dataclasses.replace(icfg.test, instance_score_thr=0.0))
    image = _cli_counted(paths, "cli-image", CLI_IMAGES, lambda stats: _run_cli(
        "test_image", ["--data-root", root, "--split", "train", "--size",
                       *map(str, SERVE_HW), "--max-images", str(CLI_IMAGES)],
        [(tconfigs, "knet_s3_r50_fpn_cityscapes_step", lambda: icfg)], stats))
    lines = image["text"].splitlines()
    if len(lines) != 22 or json.loads(lines[-1])["images"] != CLI_IMAGES:
        raise AssertionError(f"[cli-image] printed {image['text']!r}")
    out["image"] = image

    ann = write_coco_images(os.path.join(tmp, "coco"), n=COCO_IMAGES, hw=COCO_HW, seed=IMAGE_SEED)
    coco = _cli_counted(paths, "cli-coco", COCO_IMAGES, lambda stats: _run_cli(
        "test_coco_instance", ["--ann-file", ann, "--img-root", os.path.dirname(ann),
                               "--size", *map(str, IMAGE_HW),
                               "--out", os.path.join(tmp, "cli_coco")], (), stats))
    res = json.loads(coco["text"])
    with open(res["results"]) as f:
        dets = json.load(f)
    if res["n_images"] != COCO_IMAGES or len(dets) != res["n_detections"] or not dets or any(
            tuple(d["segmentation"]["size"]) != COCO_HW for d in dets):
        raise AssertionError(f"[cli-coco] {res}, {len(dets)} results")
    out["coco"] = coco
    log(f"[cli-eval] ms an item: test_vss {vss['mean_ms']:.2f}, test_dvps {dvps['loop_ms']:.2f} "
        f"(the CLI's loop: its {DVPS_FRAMES} frames are one window), "
        f"test_image {image['mean_ms']:.2f}, test_coco_instance {coco['mean_ms']:.2f} "
        f"({res['n_detections']} detections)")
    return out


def _ytvis_cocovid(root: str, **kw) -> tuple[str, str]:
    """`data_check.write_ytvis_cocovid`: a seeded raw YouTube-VIS tree and
    its COCO-VID json written by the `youtubevis2coco` CLI, whose printed
    line is checked: (json, image root)."""
    from video_knet_tpu_torch.tools.data_check import write_ytvis_cocovid

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ann, img_root = write_ytvis_cocovid(root, **kw)
    text = out.getvalue()
    log(f"[youtubevis2coco] {text.strip()}")
    n = kw["n_videos"] * kw["n_frames"]
    if not re.fullmatch(f"wrote {re.escape(ann)}: {n} images, \\d+ annotations, "
                        f"{kw['n_videos']} videos\n", text):
        raise AssertionError(f"[youtubevis2coco] printed {text!r}")
    return ann, img_root


def _same_vis_batch(a, b) -> bool:
    """Every field of two VISBatches equal, bit for bit (b on the CPU)."""
    return all(x.dtype == y.dtype and torch.equal(x.cpu(), y)
               for x, y in ((a.clip, b.clip), *zip(a.gt, b.gt)))


def phase_vis_data(device, paths: Paths, tmp: str) -> dict:
    """The VIS data path: a seeded YouTube-VIS 2019-style train tree (8
    videos x 8 frames of 720x1280, 1-3 instances a video as RLEs and
    polygons) converted by `youtubevis2coco` and read by
    `YouTubeVISDataset`; decode ms a frame and `clip_gt_arrays` ms a clip;
    `VISTrainLoader` alone (host ms a batch of B=2 x 5 frames at 1 and 4
    threads, the CUDA batches equal to the CPU loader's); 4 loader-fed
    steps of the R-50 YouTube-VIS 2019 preset on a 360x640 canvas (7 / 7 /
    1 launches a step, 0 host syncs after the first), then the same batches
    with no loader running (`vis-data-train-alone`)."""
    from video_knet_tpu_torch.configs import get_config
    from video_knet_tpu_torch.data.panoptic_png import load_png
    from video_knet_tpu_torch.data.vis_loader import VISTrainLoader
    from video_knet_tpu_torch.data.ytvis import YouTubeVISDataset
    from video_knet_tpu_torch.models.vis.knet_vis import KNetVIS, knet_vis_costs
    from video_knet_tpu_torch.ops.hungarian import gt_rows
    from video_knet_tpu_torch.train.optim import make_optimizer
    from video_knet_tpu_torch.train.train_state import create_train_state
    from video_knet_tpu_torch.train.vis import train_step

    t0 = time.perf_counter()
    ann, img_root = _ytvis_cocovid(os.path.join(tmp, "ytvis_train"), n_videos=VIS_DATA_VIDEOS,
                                   n_frames=VIS_DATA_FRAMES, hw=VIS_DATA_HW,
                                   max_insts=VIS_DATA_INSTS, seed=DATA_SEED)
    write_s = time.perf_counter() - t0
    ds = YouTubeVISDataset(ann, img_root)
    n_anns = sum(len(a) for v in ds.videos for a in v.anns_by_frame)
    if len(ds) != VIS_DATA_VIDEOS or not n_anns:
        raise AssertionError(f"[vis-data] {len(ds)} videos, {n_anns} annotations")
    frame = ds.frame_path(ds.videos[0].frames[0])
    ms = []
    for _ in range(DATA_DECODE_READS):
        t0 = time.perf_counter()
        rgb = load_png(frame)
        ms.append((time.perf_counter() - t0) * 1e3)
    if rgb.shape != (*VIS_DATA_HW, 3):
        raise AssertionError(f"[vis-data] a frame of shape {rgb.shape}")
    decode_ms = statistics.median(ms)
    cfg = get_config("video_knet_vis_r50_ytvis2019")
    if (cfg.max_insts, cfg.num_frames, cfg.num_classes) != (16, VIS_FRAMES, 40):
        raise AssertionError("[vis-data] not the YouTube-VIS 2019 R-50 preset")
    gt_ms = []
    for v in range(len(ds)):
        t0 = time.perf_counter()
        ds.clip_gt_arrays(v, list(range(VIS_FRAMES)), max_insts=cfg.max_insts)
        gt_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"[vis-data] wrote and converted {VIS_DATA_VIDEOS} x {VIS_DATA_FRAMES} frames of "
        f"{VIS_DATA_HW[0]}x{VIS_DATA_HW[1]} ({n_anns} annotations) in {write_s:.2f} s; load_png "
        f"median {decode_ms:.3f} ms a frame; clip_gt_arrays (16 slots x {VIS_FRAMES} frames at "
        f"full size) median {statistics.median(gt_ms):.3f} ms a clip")

    def loader(dev, threads: int = 4):
        return VISTrainLoader(ds, cfg, batch_size=VIS_DATA_B, canvas_hw=VIS_HW, seed=DATA_SEED,
                              num_threads=threads, device=dev)

    loader_ms, cpu = {}, {}
    for threads in (1, 4):
        ms, cpu[threads] = [], []
        t0 = time.perf_counter()
        for b in loader("cpu", threads):
            ms.append((time.perf_counter() - t0) * 1e3)
            cpu[threads].append(b)
            t0 = time.perf_counter()
        loader_ms[threads] = dict(median_ms=statistics.median(ms[1:]),
                                  mean_ms=sum(ms) / len(ms), ms=[round(t, 3) for t in ms])
        log(f"[vis-data] loader alone, {threads} thread(s), B={VIS_DATA_B} x {VIS_FRAMES} frames "
            f"on {VIS_HW[0]}x{VIS_HW[1]}: median {loader_ms[threads]['median_ms']:.2f} ms a "
            f"batch over batches 1..{len(ms) - 1}, epoch mean "
            f"{loader_ms[threads]['mean_ms']:.2f} ms; ms {loader_ms[threads]['ms']}")
    cuda = list(loader(device))
    n_batches = VIS_DATA_VIDEOS // VIS_DATA_B
    if not (len(cuda) == len(cpu[1]) == len(cpu[4]) == n_batches and all(
            a.clip.device.type == device.type and _same_vis_batch(a, b) and _same_vis_batch(b, c)
            for a, b, c in zip(cuda, cpu[1], cpu[4]))):
        raise AssertionError("[vis-data] the CUDA loader's batches differ from the CPU loaders'")
    gt = cpu[1][0].gt
    log(f"[vis-data] {n_batches} CUDA batches equal the CPU loader's (1 and 4 threads) in every "
        f"field; batch 0: {int(gt.valid.sum())} tube slots of {VIS_DATA_B} x {cfg.max_insts}, "
        f"tubes at {tuple(gt.masks.shape[-2:])}, {float(gt.masks.sum()):.1f} mask pixels")
    del cuda, cpu

    model = KNetVIS(cfg, generator=torch.Generator().manual_seed(VIS_SEED), device=device)
    state = create_train_state(model, make_optimizer(model, steps_per_epoch=1000))
    frozen, trainable = _frozen_split("vis-data-train", model)
    batches = iter(loader(device))
    waits, fed, keys = [], [], []

    def step(batch):
        nonlocal state
        if batch is None:  # loader-fed: the wait on the loader is part of the step
            t0 = time.perf_counter()
            batch = next(batches)
            waits.append((time.perf_counter() - t0) * 1e3)
            fed.append(batch)
        state, losses = train_step(state, batch)
        return losses

    def check_keys(got: set) -> bool:
        keys.append(got)
        return got == keys[0] and {"loss_rpn_seg", "tracker_s2_loss_dice", "total_loss"} <= got

    out = _timed_steps("vis-data-train", step, [None] * VIS_DATA_STEPS, VIS_TRAIN_LAUNCHES,
                       check_keys)
    batches.close()  # stops the producer
    _check_trained("vis-data-train", model, frozen, trainable)
    paths.launches["vis-data-train"] = out["launches"]
    paths.frame_ms["vis-data-train"] = out["step_ms"]
    alone = _timed_steps("vis-data-train-alone", step, fed, VIS_TRAIN_LAUNCHES, check_keys)
    paths.launches["vis-data-train-alone"] = alone["launches"]
    out.update(wait_ms=waits, decode_ms=decode_ms, gt_ms=statistics.median(gt_ms),
               loader_ms=loader_ms, write_s=write_s, alone_median_ms=alone["median_ms"],
               alone_ms=alone["step_ms"])
    log(f"[vis-data-train] waited on next(loader) {[round(w, 3) for w in waits]} ms a step; "
        f"median step (wait included) {out['median_ms']:.2f} ms while the loader's threads run, "
        f"{alone['median_ms']:.2f} ms on the same batches with none running")
    # the step's problems at B=2 (4 per-frame sets of B*T = 10, 2 tube sets of B = 2)
    with torch.no_grad():
        costs, valids = knet_vis_costs(model(fed[-1].clip), fed[-1].gt, cfg)
    out["hungarian"] = _hungarian_record("vis-data-train",
                                         gt_rows(torch.cat(costs), torch.cat(valids)))
    del model, state, fed
    return out


def phase_vis_cli(device, paths: Paths, tmp: str) -> dict:
    """`tools/test_whole_video` in process at its defaults (clips of 8 at
    360x640) on a seeded 2-video x 12-frame 720x1280 val tree: the R-50
    YouTube-VIS 2019 preset (seeded random weights) on the card, 7 / 7
    launches a clip, results.json with both videos, every RLE of 360x640,
    the zip's member equal to it; then the tiny VIS config (weights from
    `vis_margin_seed`) on the card and on the CPU at 180x320, equal under
    the threshold's near-tie rule (`train_check.vis_results_agree`)."""
    import zipfile

    from video_knet_tpu_torch import config_vis
    from video_knet_tpu_torch.data.rle import decode_mask
    from video_knet_tpu_torch.data.ytvis import YouTubeVISDataset
    from video_knet_tpu_torch.models.vis.knet_vis import KNetVIS
    from video_knet_tpu_torch.tools import train_check
    from video_knet_tpu_torch.utils.checkpoint import save_checkpoint

    ann, img_root = _ytvis_cocovid(os.path.join(tmp, "ytvis_val"), n_videos=VIS_CLI_VIDEOS,
                                   n_frames=VIS_CLI_FRAMES, hw=VIS_DATA_HW,
                                   max_insts=VIS_DATA_INSTS, seed=DATA_SEED + 1)
    clips = VIS_CLI_VIDEOS * -(-VIS_CLI_FRAMES // VIS_CLI_CLIP)
    out_dir = os.path.join(tmp, "cli_vis")
    argv = ["--ann-file", ann, "--img-root", img_root, "--out", out_dir]
    rec = _cli_counted(paths, "vis-cli", clips, lambda stats: _run_cli(
        "test_whole_video", argv, (), stats), per_item=VIS_LAUNCHES)
    # clips 1.. cover every frame but the first clip's, their reads included;
    # a video's later clips read no frame: the forward, decode and copy alone
    rec["frame_ms"] = sum(rec["ms"][1:]) / (VIS_CLI_VIDEOS * VIS_CLI_FRAMES - VIS_CLI_CLIP)
    per_video = clips // VIS_CLI_VIDEOS
    rec["clip_ms"] = statistics.median(rec["ms"][i] for i in range(1, clips) if i % per_video)
    with open(os.path.join(out_dir, "results.json")) as f:
        results = json.load(f)
    with zipfile.ZipFile(os.path.join(out_dir, "submission_file.zip")) as z:
        member = json.loads(z.read("results.json"))
    rles = [s for r in results for s in r["segmentations"] if s is not None]
    k = config_vis.youtube_vis_2019_config().test.max_per_img
    if (member != results or {r["video_id"] for r in results} != set(range(1, VIS_CLI_VIDEOS + 1))
            or len(results) != VIS_CLI_VIDEOS * k or not rles
            or any(decode_mask(s).shape != VIS_HW for s in rles)
            or rec["text"] != f"wrote {os.path.join(out_dir, 'results.json')}\n"):
        raise AssertionError(f"[vis-cli] {len(results)} results, {len(rles)} RLEs, printed "
                             f"{rec['text']!r}")
    log(f"[vis-cli] R-50 test_whole_video over {VIS_CLI_VIDEOS} x {VIS_CLI_FRAMES} frames of "
        f"{VIS_DATA_HW[0]}x{VIS_DATA_HW[1]} in clips of {VIS_CLI_CLIP} at "
        f"{VIS_HW[0]}x{VIS_HW[1]}: {rec['clip_ms']:.2f} ms a clip that reads no frame "
        f"(ms {[round(t, 3) for t in rec['ms']]}: a video's first clip waits for its frames' "
        f"reads), {rec['frame_ms']:.2f} ms a frame over clips 1..{clips - 1} (reads "
        f"included); {len(results)} tracks, {len(rles)} non-empty masks, the zip "
        f"equal to results.json")

    cfg = train_check.vis_check_cfg(config_vis.VISConfig())
    seed, _ = train_check.vis_margin_seed(cfg, CHECK_HW)
    models = {d: KNetVIS(cfg, generator=torch.Generator().manual_seed(seed), device=dev)
              for d, dev in (("cuda", device), ("cpu", "cpu"))}
    ckpt = save_checkpoint(os.path.join(tmp, "vis_tiny_ckpt"), models["cpu"])
    tiny = [(config_vis, "youtube_vis_2019_config", lambda: cfg)]
    targv = ["--ann-file", ann, "--img-root", img_root, "--checkpoint", ckpt, "--size",
             *map(str, VIS_CLI_TINY_HW)]
    res = {}
    for d in ("cuda", "cpu"):
        tout = os.path.join(tmp, f"cli_vis_tiny_{d}")
        if d == "cuda":
            _cli_counted(paths, "vis-cli-tiny", clips, lambda stats: _run_cli(
                "test_whole_video", [*targv, "--out", tout], tiny, stats), per_item=VIS_LAUNCHES)
        else:
            _run_cli("test_whole_video", [*targv, "--out", tout, "--device", "cpu"], tiny)
        with open(os.path.join(tout, "results.json")) as f:
            res[d] = json.load(f)
    # raises where the mask logits differ by more than VIS_MASK_TOL of their scale
    near, worst, per_clip = train_check.vis_near_ties(
        models["cuda"], models["cpu"], cfg, YouTubeVISDataset(ann, img_root), VIS_CLI_TINY_HW,
        VIS_CLI_CLIP)
    agree = train_check.vis_results_agree(res["cuda"], res["cpu"], near)
    n_near = sum(int(v.sum()) for v in near.values())
    log(f"[vis-cli-tiny] the tiny VIS model (seed {seed}) at {VIS_CLI_TINY_HW[0]}x"
        f"{VIS_CLI_TINY_HW[1]}, card vs CPU: {agree['tracks']} tracks with equal video ids, "
        f"order, categories and non-empty frames, scores within {train_check.VIS_SCORE_TOL}; "
        f"mask logits within {worst:.2e} of their scale (limit {train_check.VIS_MASK_TOL}); "
        f"{agree['excused']} mask pixels differ, all at near-ties ({n_near} near-tie pixels); "
        f"clip by clip, the difference and the hard decisions taken otherwise: {per_clip}")
    rec.update(tiny=dict(agree, worst=worst, near=n_near))
    rec["flip_clips"] = _vis_flip_clips(models, cfg, os.path.join(tmp, "ytvis_flip"))
    return rec


def _vis_flip_clips(models: dict, cfg, root: str) -> dict:
    """The tiny VIS model on the clips of the card test
    `test_whole_video_on_the_card_matches_the_cpu` (2 videos x 7 frames of
    72x128, tree seed 2, clips of 3) at the size its weight seed was chosen
    for, 64x96: each clip's card-vs-CPU difference of the mask logits and
    the hard decisions inside its forward that the devices took otherwise.
    Not bounded: a clip whose difference exceeds VIS_MASK_TOL must show such
    a decision, the cause of the difference."""
    from video_knet_tpu_torch.data.ytvis import YouTubeVISDataset
    from video_knet_tpu_torch.tools import train_check
    from video_knet_tpu_torch.tools.data_check import write_ytvis_cocovid

    with contextlib.redirect_stdout(io.StringIO()):
        ann, img_root = write_ytvis_cocovid(root, n_videos=2, n_frames=7, hw=(72, 128), seed=2)
    _, worst, per_clip = train_check.vis_near_ties(
        models["cuda"], models["cpu"], cfg, YouTubeVISDataset(ann, img_root), (64, 96), 3,
        tol=math.inf)
    log(f"[vis-cli-tiny] the card test's clips at 64x96: worst difference {worst:.3e} of the "
        f"scale; clip by clip, the difference and the hard decisions taken otherwise: "
        f"{per_clip}")
    unexplained = [(v, i) for v, clips in per_clip.items() for i, c in enumerate(clips)
                   if c["err"] > train_check.VIS_MASK_TOL and len(c) == 1]
    if unexplained:
        raise AssertionError(f"[vis-cli-tiny] (video, clip) {unexplained}: the mask logits "
                             f"differ past {train_check.VIS_MASK_TOL} with no hard decision "
                             f"taken otherwise")
    return per_clip


def phase_coco_data(tmp: str) -> dict:
    """The COCO-panoptic, Cityscapes-VPS and forecasting readers on the
    host: a seeded COCO panoptic tree (4 images of 480x640, ~20 segments:
    stuff bands, thing boxes, a crowd and an unknown category, void) and a
    Cityscapes-VPS tree (2 clips x 3 frames of 1024x2048); `load_sem_inst`
    ms, the `get_pair` sequence, `load_instance_annotations` and `pad_to` on
    a 1024x2048 Cityscapes-style instance map. No PIL: every file is a PNG."""
    from video_knet_tpu_torch.data.coco_panoptic import CityscapesVPSDataset, CocoPanopticDataset
    from video_knet_tpu_torch.data.forecasting import load_instance_annotations, pad_to
    from video_knet_tpu_torch.data.panoptic_png import load_png
    from video_knet_tpu_torch.tools.data_check import (
        write_cityscapes_vps_tree,
        write_coco_panoptic_tree,
    )

    out = {}
    ds = CocoPanopticDataset(*write_coco_panoptic_tree(
        os.path.join(tmp, "coco_panoptic"), n_images=COCO_DATA_IMAGES, hw=COCO_HW,
        seed=DATA_SEED))
    ms, labels = [], set()
    for i in range(len(ds)):
        t0 = time.perf_counter()
        sem, inst = ds.load_sem_inst(i)
        ms.append((time.perf_counter() - t0) * 1e3)
        labels |= set(np.unique(sem).tolist())
        crowd = [s["id"] for s in ds.samples[i].segments_info if s.get("iscrowd")]
        if not (inst.max() > 1 and (sem == 255).any()) or len(crowd) != 1:
            raise AssertionError(f"[coco-data] image {i}: {int(inst.max())} instances, crowd "
                                 f"{crowd}")
    if not (any(lb < ds.num_thing_classes for lb in labels)
            and any(ds.num_thing_classes <= lb < 255 for lb in labels)):
        raise AssertionError(f"[coco-data] labels {sorted(labels)}")
    out["coco_ms"] = statistics.median(ms)
    log(f"[coco-data] COCO panoptic, {len(ds)} images of {COCO_HW[0]}x{COCO_HW[1]} "
        f"({sum(len(s.segments_info) for s in ds.samples)} segments): load_sem_inst median "
        f"{out['coco_ms']:.3f} ms; labels {sorted(labels)}")

    paths_ = write_cityscapes_vps_tree(os.path.join(tmp, "cityscapes_vps"),
                                       n_clips=CITYSCAPES_CLIPS, n_frames=CITYSCAPES_FRAMES,
                                       hw=CITYSCAPES_HW, seed=DATA_SEED)
    cvps = CityscapesVPSDataset(*paths_, seed=DATA_SEED)
    pairs = [cvps.get_pair(k) for k in range(len(cvps.keys))]
    clip_of = lambda i: os.path.basename(cvps.samples[i].img)[:4]  # noqa: E731
    if len(pairs) != CITYSCAPES_CLIPS * CITYSCAPES_FRAMES or any(
            k == r or clip_of(k) != clip_of(r) for k, r in pairs):
        raise AssertionError(f"[coco-data] get_pair {pairs}")
    t0 = time.perf_counter()
    sem, inst = cvps.load_sem_inst(0)
    out["cityscapes_ms"] = (time.perf_counter() - t0) * 1e3
    # a Cityscapes-style instance map of that frame: things (trainIds 11-18,
    # things-first labels 0-7) as class * 1000 + instance, stuff and crowd
    # as their trainId, void as 255
    thing = (sem < cvps.num_thing_classes) & (inst > 0)
    train_id = np.where(sem < cvps.num_thing_classes, sem + 11, sem - cvps.num_thing_classes)
    inst_map = np.where(thing, train_id * 1000 + inst, np.where(sem == 255, 255, train_id))
    t0 = time.perf_counter()
    ann = load_instance_annotations(inst_map, with_inst=True, semantic_seg=sem)
    padded = pad_to(load_png(cvps.samples[0].img), size_divisor=32, masks=ann["gt_masks"],
                    seg=ann["gt_semantic_seg"])
    square = pad_to(load_png(cvps.samples[0].img), pad_to_square=True)
    out["forecast_ms"] = (time.perf_counter() - t0) * 1e3
    n_inst = int(len(np.unique(inst[thing])))
    if (len(ann["gt_labels"]) != n_inst or not n_inst
            or padded["img"].shape[:2] != CITYSCAPES_HW or square["img"].shape[:2] != (max(CITYSCAPES_HW),) * 2
            or padded["masks"].shape != (n_inst, *CITYSCAPES_HW)):
        raise AssertionError(f"[coco-data] {len(ann['gt_labels'])} instances of {n_inst}, "
                             f"padded {padded['img'].shape}, square {square['img'].shape}")
    out["pairs"] = pairs
    log(f"[coco-data] Cityscapes-VPS, {CITYSCAPES_CLIPS} clips x {CITYSCAPES_FRAMES} frames of "
        f"{CITYSCAPES_HW[0]}x{CITYSCAPES_HW[1]}: get_pair {pairs}; load_sem_inst "
        f"{out['cityscapes_ms']:.2f} ms; load_instance_annotations + pad_to (divisor 32, square) "
        f"{out['forecast_ms']:.2f} ms for {n_inst} instances, boxes "
        f"{ann['gt_bboxes'][:2].tolist()}...")
    return out


def _uncounted(fn):
    """`fn()` with the launch counts put back as they were after it (a
    reference computation beside the path, not the path)."""
    from video_knet_tpu_torch.ops.kernels import hungarian, mask_ops

    saved = (dict(mask_ops.LAUNCHES), dict(hungarian.LAUNCHES), dict(mask_ops.FLOPS))
    try:
        return fn()
    finally:
        for table, old in zip((mask_ops.LAUNCHES, hungarian.LAUNCHES, mask_ops.FLOPS), saved):
            table.update(old)


class _StepProbe:
    """A train module's `train_step` wrapped while a CLI runs: each step's
    launches (the counts read before and after it), the host syncs inside
    it (`set_sync_debug_mode("warn")`), the last state it returned;
    `before(state, batch)` runs before the first step, `each(state, batch)`
    before every step and `after(i, state)` after each."""

    def __init__(self, module, before=None, after=None, each=None):
        self.module, self.orig = module, module.train_step
        self.before, self.after, self.each = before, after, each
        self.launches, self.syncs, self.state = [], [], None

    def __call__(self, state, batch, *args, **kwargs):
        import warnings

        if self.before is not None and not self.launches:
            _uncounted(lambda: self.before(state, batch))
        if self.each is not None:
            _uncounted(lambda: self.each(state, batch))
        start = _counts()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if batch[0].device.type == "cuda":
                torch.cuda.set_sync_debug_mode("warn")
            try:
                out = self.orig(state, batch, *args, **kwargs)
            finally:
                if batch[0].device.type == "cuda":
                    torch.cuda.set_sync_debug_mode(0)
        end = _counts()
        self.launches.append({k: end[k] - start[k] for k in end})
        self.syncs.append(sum("synchroniz" in str(w.message) for w in caught))
        self.state = out[0]
        if self.after is not None:
            self.after(len(self.launches), out[0])
        return out

    def check(self, path: str, expected: dict) -> None:
        bad = [i for i, c in enumerate(self.launches) if c != expected]
        if bad or any(self.syncs[1:]):
            raise AssertionError(f"[{path}] launches a step {self.launches} (expected "
                                 f"{expected}), host syncs a step {self.syncs}")


def _records(text: str) -> list[dict]:
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{") and '"iter"' in line]


def _finite_records(path: str, recs: list, n: int) -> None:
    if len(recs) != n or not all(np.isfinite(v) for r in recs for v in r.values()):
        raise AssertionError(f"[{path}] {len(recs)} records (expected {n}): {recs}")


def _cli_run(paths: Paths, path: str, name: str, argv: list, module, expected: dict,
             n_steps: int, extra: dict | None = None, patches=(), before=None,
             after=None, each=None) -> dict:
    """The port's train CLI `name` in process with `module.train_step`
    probed: the launch counts set to 0 just before the run and read just
    after (its steps' and any eval's), each step's launches held to
    `expected` and 0 host syncs after the first; the step ms between the
    CLI's per-step timestamps (a record every step syncs), peak memory."""
    probe = _StepProbe(module, before, after, each)
    stats: list = []
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    text = _run_cli(name, argv, patches=[*patches, (module, "train_step", probe)], stats=stats)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    total = _counts()
    probe.check(path, expected)
    preempted = "preemption checkpoint written" in text  # its last step has no stamp
    if len(probe.launches) != n_steps or len(stats) != n_steps - preempted:
        raise AssertionError(f"[{path}] {len(probe.launches)} steps, {len(stats)} stamps, "
                             f"expected {n_steps}")
    want = {k: expected[k] * n_steps + (extra or {}).get(k, 0) for k in expected}
    if total != want:
        raise AssertionError(f"[{path}] launches in the run {total}, expected {want}")
    paths.launches[path] = dict(total)  # the mask kernels' and the Hungarian kernel's
    ms = [(b - a) * 1e3 for a, b in zip(stats, stats[1:])]
    paths.frame_ms[path] = ms or [seconds * 1e3]
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0
    rec = dict(text=text, records=_records(text), step_ms=ms,
               median_ms=statistics.median(ms) if ms else float("nan"), peak_bytes=peak,
               syncs=probe.syncs, launches=total, steps=n_steps, seconds=seconds,
               state=probe.state)
    log(f"[{path}] {n_steps} steps in {seconds:.1f} s: median step {rec['median_ms']:.2f} ms "
        f"over steps 2..{n_steps} (loader-fed, a record a step), launches a step "
        f"{probe.launches[0]}, host syncs a step {probe.syncs}, peak memory {peak} bytes")
    return rec


def phase_train_cli(device, paths: Paths, root: str, tmp: str) -> dict:
    """`tools/train_vps` in process on `data`'s KITTI-STEP tree (and a val
    split written beside it): the R-50 default config at 384x1248, B=1, one
    epoch with a record a step and eval; `--resume-from` for a second epoch;
    a SIGTERM after the first step (the preemption checkpoint, then
    `--resume-from` it); `--freeze-detector` for one epoch of B=6 (2 steps);
    `--bf16` for one epoch of B=1 (its first step's loss against the fp32
    run's on the same batch; every backbone and neck convolution and dense
    layer of that step in bf16)."""
    import signal

    import video_knet_tpu_torch.train.vps as tvps
    from video_knet_tpu_torch.tools.data_check import write_kitti_step_tree
    from video_knet_tpu_torch.train.optim import frozen_mask
    from video_knet_tpu_torch.utils.precision import layer_dtypes

    write_kitti_step_tree(root, n_seqs=1, n_frames=TRAIN_CLI_VAL_FRAMES, hw=DATA_HW,
                          n_things=DATA_THINGS, split="val", seed=DATA_SEED + 1)
    n = DATA_SEQS * DATA_FRAMES
    work = os.path.join(tmp, "train_vps")
    dev = [] if device.type == "cuda" else ["--device", "cpu"]
    base = ["--data-root", root, "--crop", *map(str, TRAIN_HW), "--log-interval", "1", *dev]
    out = {}
    t0 = time.perf_counter()
    import video_knet_tpu_torch.train.eval_hook as eval_hook

    evaluate, eval_s = eval_hook.evaluate_vps, []

    def timed_eval(*args, **kwargs):
        t1 = time.perf_counter()
        try:
            return evaluate(*args, **kwargs)
        finally:
            eval_s.append(time.perf_counter() - t1)

    first = _cli_run(paths, "train-cli", "train_vps",
                     [*base, "--epochs", "1", "--batch-size", "1", "--work-dir", work,
                      "--eval-interval", "1", "--eval-max-frames", str(TRAIN_CLI_EVAL_FRAMES)],
                     tvps, TRAIN_LAUNCHES, n,
                     extra={k: 4 * TRAIN_CLI_EVAL_FRAMES for k in KERNELS},
                     patches=[(eval_hook, "evaluate_vps", timed_eval)])
    _finite_records("train-cli", first["records"], n)
    evals = [line for line in first["text"].splitlines() if line.startswith("eval:")]
    rec = json.loads(evals[0][len("eval:"):]) if evals else {}
    if rec.get("frames") != TRAIN_CLI_EVAL_FRAMES:
        raise AssertionError(f"[train-cli] eval {evals}")
    with open(os.path.join(work, "train_log.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    if logged != [*first["records"], {"eval": rec}]:
        raise AssertionError("[train-cli] train_log.jsonl differs from the printed records")
    out.update(median_ms=first["median_ms"], peak_bytes=first["peak_bytes"],
               syncs=first["syncs"], eval=rec, eval_ms=eval_s[0] * 1e3 / TRAIN_CLI_EVAL_FRAMES)
    # a second epoch from the first's checkpoint: the step count carries on
    second = _cli_run(paths, "train-cli-resume", "train_vps",
                      [*base, "--epochs", "2", "--batch-size", "1", "--work-dir", work,
                       "--resume-from", os.path.join(work, "ckpt", "step_1")],
                      tvps, TRAIN_LAUNCHES, n)
    if [r["epoch"] for r in second["records"]] != [1] * n or second["state"].step != 2 * n:
        raise AssertionError(f"[train-cli-resume] records {second['records'][:2]}..., step "
                             f"{second['state'].step}")
    # SIGTERM after the first step: the step finishes, ckpt/step_1 is written
    pre = os.path.join(tmp, "train_vps_preempt")

    def term(i, state):
        if i == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    text = _cli_run(paths, "train-cli-preempt", "train_vps",
                    [*base, "--epochs", "1", "--batch-size", "1", "--work-dir", pre],
                    tvps, TRAIN_LAUNCHES, 1, after=term)["text"]
    ckpt = os.path.join(pre, "ckpt", "step_1")
    saved = torch.load(os.path.join(ckpt, "checkpoint.pt"), map_location="cpu",
                       weights_only=True)["step"]
    if "preemption checkpoint written; exiting" not in text or saved != 1:
        raise AssertionError(f"[train-cli-preempt] printed {text!r}, checkpoint step {saved}")
    resumed = _cli_run(paths, "train-cli-preempt-resume", "train_vps",
                       [*base, "--epochs", "1", "--batch-size", "1", "--work-dir", pre,
                        "--resume-from", ckpt], tvps, TRAIN_LAUNCHES, n)
    if resumed["state"].step != 1 + n:
        raise AssertionError(f"[train-cli-preempt] resumed to step {resumed['state'].step}")
    # --freeze-detector: the detector stays bit-equal, every track / link parameter moves
    start = {}

    def keep(state, batch):
        start.update({k: p.detach().clone() for k, p in state.model.named_parameters()})

    b = TRAIN_CLI_B
    frz = _cli_run(paths, "train-cli-freeze", "train_vps",
                   [*base, "--epochs", "1", "--batch-size", str(b), "--freeze-detector",
                    "--work-dir", os.path.join(tmp, "train_vps_freeze")],
                   tvps, TRAIN_LAUNCHES, n // b, before=keep)
    model = frz["state"].model
    trainable = {k for k, v in frozen_mask(model, True).items() if v}
    wrong = [k for k, p in model.named_parameters()
             if torch.equal(p, start[k]) == (k in trainable)]
    if wrong or not trainable:
        raise AssertionError(f"[train-cli-freeze] parameters that moved when frozen or stayed "
                             f"when trainable: {wrong[:8]}")
    out["freeze"] = dict(trainable=len(trainable), frozen=len(start) - len(trainable),
                         median_ms=frz["median_ms"])
    # --bf16 from the same weights over the same batches: the first step's
    # total within 5% of the fp32 run's first step; in that step every
    # convolution and dense layer of the backbone and neck computes in bf16
    watch = contextlib.ExitStack()
    layers: dict = {}

    def watch_layers(state, batch):
        layers.update(seen=watch.enter_context(layer_dtypes(state.model)))

    def dtypes(i, state):
        if i == 1:
            watch.close()
            not16 = sorted(k for k, d in layers["seen"].items() if d != {torch.bfloat16})
            if not layers["seen"] or not16:
                raise AssertionError(f"[train-cli-bf16] layers not in bf16: {not16[:8]}")
        bad = [k for k, p in state.model.named_parameters()
               if p.dtype != torch.float32 or (p.grad is not None and p.grad.dtype != torch.float32)]
        if bad:
            raise AssertionError(f"[train-cli-bf16] masters or gradients not fp32: {bad[:8]}")

    bf = _cli_run(paths, "train-cli-bf16", "train_vps",
                  [*base, "--epochs", "1", "--batch-size", "1", "--bf16",
                   "--work-dir", os.path.join(tmp, "train_vps_bf16")],
                  tvps, TRAIN_LAUNCHES, n, before=watch_layers, after=dtypes)
    _finite_records("train-cli-bf16", bf["records"], n)
    fp32 = first["records"][0]["total_loss"]
    rel = abs(bf["records"][0]["total_loss"] - fp32) / fp32
    if rel > BF16_REL:
        raise AssertionError(f"[train-cli-bf16] first step {bf['records'][0]['total_loss']} "
                             f"vs fp32 {fp32}: {rel:.4f} > {BF16_REL}")
    out["bf16"] = dict(total=bf["records"][0]["total_loss"], fp32_total=fp32, rel=rel,
                       median_ms=bf["median_ms"], peak_bytes=bf["peak_bytes"],
                       bf16_layers=len(layers["seen"]))
    out["seconds"] = time.perf_counter() - t0
    log(f"[train-cli] R-50 train_vps at {TRAIN_HW[0]}x{TRAIN_HW[1]}: loader-fed median step "
        f"{out['median_ms']:.2f} ms (B=1), host syncs a step {out['syncs']}, peak memory "
        f"{out['peak_bytes']} bytes, eval {json.dumps(rec)}; resume, preemption (checkpoint at "
        f"step 1, resumed to step {1 + n}), freeze ({out['freeze']['trainable']} trainable, "
        f"{out['freeze']['frozen']} frozen parameters), bf16 first step "
        f"{out['bf16']['total']} vs fp32 {fp32} ({rel:.4%}; {out['bf16']['bf16_layers']} "
        f"backbone / neck layers in bf16), bf16 loader-fed median step "
        f"{out['bf16']['median_ms']:.2f} ms; eval {out['eval_ms']:.2f} ms a frame; "
        f"{out['seconds']:.1f} s")
    return out


def phase_train_vis_cli(device, paths: Paths, tmp: str) -> dict:
    """`tools/train_vis` on `vis-data`'s YouTube-VIS tree: the R-50 preset,
    360x640, T=5, B=2, one epoch; then `train/vis.py:train_step` with
    `bf16_train` on the loader's first batch: the loss within 5% of fp32,
    every backbone and neck convolution and dense layer in bf16, fp32
    masters and gradients, 7 / 7 / 1 launches."""
    import video_knet_tpu_torch.train.vis as tvis
    from video_knet_tpu_torch.config_vis import youtube_vis_2019_config
    from video_knet_tpu_torch.models.vis.knet_vis import KNetVIS
    from video_knet_tpu_torch.train.optim import make_optimizer
    from video_knet_tpu_torch.train.train_state import create_train_state
    from video_knet_tpu_torch.utils.precision import layer_dtypes

    ann = os.path.join(tmp, "ytvis_train", "cocovid.json")
    img_root = os.path.join(tmp, "ytvis_train", "JPEGImages")
    dev = [] if device.type == "cuda" else ["--device", "cpu"]
    batches = []
    t0 = time.perf_counter()
    n = VIS_DATA_VIDEOS // VIS_DATA_B
    run = _cli_run(paths, "train-vis-cli", "train_vis",
                   ["--ann-file", ann, "--img-root", img_root, "--epochs", "1", "--batch-size",
                    str(VIS_DATA_B), "--crop", *map(str, VIS_HW), "--num-frames",
                    str(VIS_FRAMES), "--log-interval", "1", "--work-dir",
                    os.path.join(tmp, "train_vis"), *dev],
                   tvis, VIS_TRAIN_LAUNCHES, n, before=lambda s, b: batches.append(b))
    _finite_records("train-vis-cli", run["records"], n)
    cfg = dataclasses.replace(youtube_vis_2019_config(), num_frames=VIS_FRAMES)
    out = dict(median_ms=run["median_ms"], peak_bytes=run["peak_bytes"], syncs=run["syncs"])
    # a bf16 step on the loader's first batch against the fp32 loss there
    models = {}
    for bf16 in (False, True):
        c = dataclasses.replace(cfg, bf16_train=bf16)
        models[bf16] = KNetVIS(c, generator=torch.Generator().manual_seed(VIS_SEED),
                               device=device)
    with torch.no_grad():
        t32 = float(tvis.make_vis_loss_fn(models[False], cfg)(batches[0])[0])
    del models[False]
    model16 = models[True]
    probe16 = _StepProbe(tvis)
    with layer_dtypes(model16) as seen:
        _, losses16 = probe16(create_train_state(model16, make_optimizer(model16, 1000)),
                              batches[0])
    probe16.check("train-vis-cli-bf16", VIS_TRAIN_LAUNCHES)
    b16 = float(losses16["total_loss"])
    bad = [k for k, p in model16.named_parameters()
           if p.dtype != torch.float32 or (p.grad is not None and p.grad.dtype != torch.float32)]
    not16 = sorted(k for k, d in seen.items() if d != {torch.bfloat16})
    rel = abs(b16 - t32) / t32
    if bad or not seen or not16 or not np.isfinite(b16) or rel > BF16_REL:
        raise AssertionError(f"[train-vis-cli-bf16] bf16 {b16} vs fp32 {t32} ({rel:.4f}); "
                             f"not fp32: {bad[:8]}; layers not in bf16: {not16[:8]}")
    out["seconds"] = time.perf_counter() - t0
    out["bf16"] = dict(total=b16, fp32_total=t32, rel=rel, launches=probe16.launches[0],
                       bf16_layers=len(seen))
    log(f"[train-vis-cli] R-50 YouTube-VIS 2019, B={VIS_DATA_B} x T={VIS_FRAMES} at "
        f"{VIS_HW[0]}x{VIS_HW[1]}: loader-fed median step {out['median_ms']:.2f} ms, host syncs "
        f"a step {out['syncs']}, peak memory {out['peak_bytes']} bytes; bf16 step loss {b16:.4f} "
        f"vs fp32 {t32:.4f} ({rel:.4%}; {len(seen)} backbone / neck layers in bf16); "
        f"{out['seconds']:.1f} s")
    return out


def phase_train_image_cli(device, paths: Paths, tmp: str) -> dict:
    """`tools/train_image --dataset cityscapes_step` on a seeded Cityscapes-STEP
    tree (1024x2048 images, crop 512x1024, B=2, one epoch of 2 steps, eval
    of 2 val images), then `--dataset coco` on a COCO panoptic tree with
    COCO's 80 + 53 categories (2 images, one step)."""
    import video_knet_tpu_torch.train.image as timage
    from video_knet_tpu_torch.tools.data_check import (
        write_cityscapes_step_tree,
        write_coco_panoptic_tree,
    )

    t0 = time.perf_counter()
    city = os.path.join(tmp, "cityscapes_step")
    write_cityscapes_step_tree(city, cities=("aachen",), n_images=IMAGE_CLI_IMAGES,
                               hw=CITYSCAPES_HW, seed=DATA_SEED)
    write_cityscapes_step_tree(city, cities=("bremen",), n_images=IMAGE_CLI_EVAL_IMAGES,
                               hw=CITYSCAPES_HW, split="val", seed=DATA_SEED + 1)
    dev = [] if device.type == "cuda" else ["--device", "cpu"]
    b = IMAGE_CLI_B
    base = ["--epochs", "1", "--batch-size", str(b), "--crop", *map(str, IMAGE_TRAIN_HW),
            "--log-interval", "1", *dev]
    run = _cli_run(paths, "train-image-cli", "train_image",
                   ["--dataset", "cityscapes_step", "--data-root", city, *base,
                    "--eval-interval", "1", "--eval-max-images", str(IMAGE_CLI_EVAL_IMAGES),
                    "--work-dir", os.path.join(tmp, "train_image")],
                   timage, IMAGE_TRAIN_LAUNCHES, IMAGE_CLI_IMAGES // b,
                   extra={k: IMAGE_LAUNCHES[k] * IMAGE_CLI_EVAL_IMAGES for k in KERNELS})
    _finite_records("train-image-cli", run["records"], IMAGE_CLI_IMAGES // b)
    lines = run["text"][run["text"].index("epoch 1 done"):].splitlines()[1:]
    ev = json.loads(lines[-1])["eval"] if lines and lines[-1].startswith("{") else {}
    if ev.get("images") != IMAGE_CLI_EVAL_IMAGES or not lines[-2].startswith("ALL"):
        raise AssertionError(f"[train-image-cli] eval lines {lines}")
    ann, img_root, pan_root = write_coco_panoptic_tree(
        os.path.join(tmp, "coco_train"), n_images=b, hw=COCO_HW, thing_ids=COCO_THING_IDS,
        stuff_ids=COCO_STUFF_IDS, seed=DATA_SEED)
    coco = _cli_run(paths, "train-image-cli-coco", "train_image",
                    ["--dataset", "coco", "--ann-file", ann, "--img-root", img_root,
                     "--pan-root", pan_root, *base, "--work-dir",
                     os.path.join(tmp, "train_image_coco")],
                    timage, IMAGE_TRAIN_LAUNCHES, 1)
    _finite_records("train-image-cli-coco", coco["records"], 1)
    out = dict(median_ms=run["median_ms"], step_ms=run["step_ms"], peak_bytes=run["peak_bytes"],
               syncs=run["syncs"], eval=ev, coco_s=coco["seconds"],
               seconds=time.perf_counter() - t0)
    log(f"[train-image-cli] Cityscapes-STEP R-50, B={b} crops of {IMAGE_TRAIN_HW[0]}x"
        f"{IMAGE_TRAIN_HW[1]} from {CITYSCAPES_HW[0]}x{CITYSCAPES_HW[1]}: step ms "
        f"{[round(t, 2) for t in run['step_ms']]}, host syncs a step {run['syncs']}, peak memory "
        f"{run['peak_bytes']} bytes, eval {json.dumps(ev)}; COCO panoptic (80 + 53 classes) one "
        f"step in {coco['seconds']:.1f} s; {out['seconds']:.1f} s")
    return out


def phase_flops(device, paths: Paths, tmp: str) -> dict:
    """`tools/get_flops` for vps, image and vis at their defaults on the card
    and on the CPU: equal lines. Then `utils/profiling`: `benchmark` of an
    R-50 serving frame, a `trace` of one naming both mask kernels, and
    `device_memory_stats` of the card."""
    from video_knet_tpu_torch.models.video.inference import VPSInferencePipeline
    from video_knet_tpu_torch.tools.profile_serving import smoke_config, smoke_model
    from video_knet_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    out = {"flops": {}}
    for model in ("vps", "image", "vis"):
        lines = {d: _run_cli("get_flops", ["--model", model, "--device", d]).splitlines()
                 for d in (device.type, "cpu")}
        if lines[device.type] != lines["cpu"] or len(lines["cpu"]) != 3:
            raise AssertionError(f"[flops] {model}: {lines}")
        out["flops"][model] = dict(gflops=float(lines["cpu"][1].split()[1]),
                                   params_m=float(lines["cpu"][2].split()[1]))
    cfg = smoke_config()
    pipe = VPSInferencePipeline(smoke_model(cfg, device), cfg, SERVE_HW, device=device)
    frame = torch.from_numpy(_frames(SERVE_HW, 1)[0]).to(device)
    pipe.run_frame(frame, is_first=True)
    bench = profiling.benchmark(lambda: pipe.run_frame(frame, is_first=False), warmup=2,
                                iters=FLOPS_BENCH_ITERS)
    tdir = os.path.join(tmp, "trace")
    with profiling.trace(tdir):
        profiling.block_until_ready(pipe.run_frame(frame, is_first=False))
    with open(os.path.join(tdir, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    named = {k: sorted(n for n in kernels if k in n) for k in TRACE_KERNELS}
    if device.type == "cuda" and not all(named.values()):
        raise AssertionError(f"[flops] the trace names no {[k for k, v in named.items() if not v]}"
                             f" kernel among {sorted(kernels)[:20]}...")
    mem = profiling.device_memory_stats()
    if device.type == "cuda" and not any(v.get("allocated_bytes.all.peak", 0) > 0
                                         for v in mem.values()):
        raise AssertionError(f"[flops] device_memory_stats {list(mem)}")
    out.update(bench=dict(compile_s=bench.compile_s, mean_ms=bench.mean_s * 1e3,
                          p50_ms=bench.p50_s * 1e3, p99_ms=bench.p99_s * 1e3, iters=bench.iters),
               trace_kernels=named, trace_events=len(events),
               memory={k: v.get("allocated_bytes.all.peak") for k, v in mem.items()},
               seconds=time.perf_counter() - t0)
    log(f"[flops] get_flops on the card and the CPU, equal: {json.dumps(out['flops'])}; "
        f"benchmark of an R-50 frame at {SERVE_HW[0]}x{SERVE_HW[1]}: {json.dumps(out['bench'])}; "
        f"trace ({len(events)} events) kernels {json.dumps(named)}; device_memory_stats peak "
        f"{json.dumps(out['memory'])}; {out['seconds']:.1f} s")
    return out


def _state_diffs(a: dict, b: dict) -> dict:
    """Worst |a - b| over the BatchNorm statistics, relative to each leaf's
    largest magnitude."""
    stats = 0.0
    for k, v in b.items():
        if k.endswith(("running_mean", "running_var")) and v.numel():
            err = float((a[k].float() - v.float()).abs().max())
            stats = max(stats, err / max(float(v.abs().max()), 1e-12))
    return {"stats": stats}


def _grad_scale(grads: dict, name: str) -> float:
    """The magnitude `name`'s gradient error is measured against: its own
    largest, but an attention's query and key parameters take the largest
    over the attention's projections. Their gradients are differences of
    softmax weights, which cancel where the keys are near-equal (random
    weights: the previous frame's kernels in a link attention, 1% of its
    value projection's scale) and cancel exactly for a key's bias (a shift
    equal for every key), leaving rounding noise."""
    module, _, proj = name.rpartition(".")[0].rpartition(".")
    if proj in ("query", "key") and f"{module}.value.weight" in grads:
        return max(float(grads[f"{module}.{p}.{w}"].abs().max())
                   for p in ("query", "key", "value", "out") for w in ("weight", "bias"))
    return float(grads[name].abs().max())


def _grad_diff(a: dict, b: dict) -> tuple[float, str]:
    """(worst |a - b| over two runs' gradients, each parameter relative to
    `_grad_scale` in `b`; the parameter)."""
    if set(a) != set(b):
        raise AssertionError(f"gradients of {sorted(set(a) ^ set(b))[:8]} on one side only")
    worst, leaf = 0.0, ""
    for k, v in b.items():
        err = float((a[k].float() - v.float()).abs().max()) / max(_grad_scale(b, k), 1e-12)
        if err >= worst:
            worst, leaf = err, k
    return worst, leaf


def _loss_diff(a: list, b: list) -> float:
    """Worst relative difference of two runs' per-step loss dicts."""
    return max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-6) for x, y in zip(a, b) for k in y)


def _hold(path: str, what: str, diffs: dict, tol: dict) -> None:
    log(f"[{path}] {what}: worst differences {json.dumps(diffs)} (tolerances {json.dumps(tol)})")
    bad = {k: v for k, v in diffs.items() if not v <= tol[k]}
    if bad:
        raise AssertionError(f"[{path}] {what}: {bad} beyond {tol}")


def phase_train_live_bn(device, paths: Paths, train_ms: float) -> dict:
    """Live BatchNorm (`norm_eval=False`) on the default config: 4 steps at
    384x1248, B=2, then the card against the CPU at 64x96."""
    from video_knet_tpu_torch.config import VideoKNetConfig
    from video_knet_tpu_torch.parallel.mesh import DataMesh
    from video_knet_tpu_torch.tools import dp_check
    from video_knet_tpu_torch.tools.train_check import margin_seed
    from video_knet_tpu_torch.train.vps import make_synthetic_batch, train_step

    cfg = dataclasses.replace(VideoKNetConfig(), norm_eval=False)
    state = _train_model(cfg, device)
    model = state.model
    stats0 = {k: v.clone() for k, v in model.named_buffers() if k.startswith("backbone.")}
    batches = [make_synthetic_batch(cfg, LIVE_BN_B, TRAIN_HW, seed=i, device=device)
               for i in range(LIVE_BN_STEPS)]
    frozen, trainable = _frozen_split("train-live-bn", model)

    def step(batch):
        nonlocal state
        state, losses = train_step(state, batch)
        return losses

    out = _timed_steps("train-live-bn", step, batches, TRAIN_LAUNCHES,
                       lambda keys: keys == TRAIN_LOSS_KEYS | {"total_loss"})
    _check_trained("train-live-bn", model, frozen, trainable)
    moved = {k: not torch.equal(v, stats0[k]) for k, v in model.named_buffers() if k in stats0}
    wrong = [k for k, m in moved.items() if m == k.startswith(FROZEN)]
    if wrong or model.training:
        raise AssertionError(f"[train-live-bn] statistics moved in a frozen stage or stayed "
                             f"in a live one: {wrong[:8]} (training mode after: "
                             f"{model.training})")
    paths.launches["train-live-bn"] = out["launches"]
    paths.frame_ms["train-live-bn"] = out["step_ms"]
    # the card against the CPU at 64x96: two steps on one batch, the CPU
    # replaying the card's ReLU decisions
    seed = margin_seed(cfg, TRAIN_CHECK_HW)[0]
    batch = make_synthetic_batch(cfg, LIVE_BN_B, TRAIN_CHECK_HW, seed=0, device="cpu")
    spec = dict(kind="vps", cfg=cfg, seed=seed, batches=[batch] * LIVE_BN_CHECK_STEPS)
    relus: list = []
    card = _uncounted(lambda: dp_check.train_steps(DataMesh(), device, spec, record=relus))
    cpu = dp_check.train_steps(DataMesh(), "cpu", {**spec, "relus": relus})
    if not all(cpu["replayed"]):
        raise AssertionError("[train-live-bn] the CPU did not replay every ReLU decision")
    grads, leaf = _grad_diff(card["grads"], cpu["grads"])
    diffs = {"loss": _loss_diff(card["losses"], cpu["losses"]), "grads": grads,
             **_state_diffs(card["state"], cpu["state"])}
    _hold("train-live-bn", f"card vs CPU at 64x96 (gradient's worst: {leaf})", diffs,
          TOL_LIVE_BN)
    # train-dp's ranks replay the card's decisions on their rows
    out.update(check=diffs, frozen_bn_ms=train_ms, check_spec={**spec, "relus": relus},
               check_card=card)
    log(f"[train-live-bn] median step {out['median_ms']:.2f} ms at B={LIVE_BN_B} (the frozen-BN "
        f"`train` phase: {train_ms:.2f} ms at B=1), peak memory {out['peak_bytes']} bytes, "
        f"host syncs a step {out['syncs']}")
    return out


def _check_ranks(path: str, what: str, ranks: list, one: dict, expected: dict,
                 replayed: bool = True, tol: dict = TOL_LIVE_BN) -> dict:
    """Each rank against the one-process run: the worst differences of the
    losses, the first step's gradient summed over the ranks and the final
    statistics, held to `tol` (what it has no limit for is printed); the
    ranks' states bit-equal, each rank's launches a step `expected`.
    Without the ReLU decisions replayed (`replayed=False`) the gradient is
    printed, not held, and so are the losses after LOSS_STEPS: from the
    second step the runs' weights differ by rounding, which a near-tie
    decision can turn into a discrete change (train-cli-dp's steps)."""
    worst = {"loss": 0.0, "grads": 0.0, "stats": 0.0, "later_loss": 0.0}
    leaf = ""
    n = len(one["losses"]) if replayed else LOSS_STEPS
    for r in ranks:
        if r["launches"] != [expected] * len(one["losses"]):
            raise AssertionError(f"[{path}] launches a step {r['launches']}, expected {expected}")
        grads, at = _grad_diff(r["grads"], one["grads"])
        d = {"loss": _loss_diff(r["losses"][:n], one["losses"][:n]), "grads": grads,
             **_state_diffs(r["state"], one["state"]),
             "later_loss": _loss_diff(r["losses"][n:], one["losses"][n:])
             if len(one["losses"]) > n else 0.0}
        leaf = at if grads >= worst["grads"] else leaf
        worst = {k: max(worst[k], d[k]) for k in worst}
    differ = [k for k, v in ranks[0]["state"].items()
              if any(not torch.equal(v, r["state"][k]) for r in ranks[1:])]
    if differ:
        raise AssertionError(f"[{path}] the ranks' states differ: {differ[:8]}")
    hold = tuple(k for k in (("loss", "grads", "stats") if replayed else ("loss", "stats"))
                 if k in tol)
    log(f"[{path}] {what}: the gradient's worst at {leaf}"
        + ("" if replayed else f"; not held (no ReLU replay at this size): gradient "
           f"{worst['grads']:.3e}, losses of steps {n + 1}.. {worst['later_loss']:.3e}")
        + ("" if not replayed or "grads" in hold else f"; the gradient not held: "
           f"{worst['grads']:.3e}"))
    _hold(path, what, {k: worst[k] for k in hold}, tol)
    return worst


def _rank_threads(processes: int) -> int:
    """Intra-op threads a rank process when `processes` share the host's
    cores (the model's seeded init runs on the CPU in each)."""
    return max(1, (os.cpu_count() or 1) // processes)


def _later_median(ms: list) -> float:
    """The median step time after the first (which builds and tunes)."""
    return statistics.median(ms[1:])


def phase_train_dp(device, paths: Paths, tmp: str, live_bn: dict) -> dict:
    """The live-BN default config at 384x1248, global B=2, DP_STEPS steps,
    against the one-process step on the card: 1 NCCL rank alone on the card
    at B=2 (DDP_VARIANTS, DDP_ROUNDS times, timed; then train-live-bn's
    64x96 check), then 2 gloo ranks sharing it at B=1 each (the 384x1248
    spec and the check). At 64x96 the ranks replay the one-process card
    run's ReLU decisions on their rows, and the first step's gradient is
    held too."""
    from video_knet_tpu_torch.config import VideoKNetConfig
    from video_knet_tpu_torch.parallel.mesh import DataMesh
    from video_knet_tpu_torch.tools import dp_check
    from video_knet_tpu_torch.train.vps import make_synthetic_batch

    cfg = dataclasses.replace(VideoKNetConfig(), norm_eval=False)
    pair = [make_synthetic_batch(cfg, 2, TRAIN_HW, seed=s, device="cpu") for s in range(2)]
    spec = dict(kind="vps", cfg=cfg, seed=TRAIN_SEED, batches=pair * (DP_STEPS // 2))
    check, check_one = live_bn["check_spec"], live_bn["check_card"]
    one = _uncounted(lambda: dp_check.train_steps(DataMesh(), device, spec))
    order = list(DDP_VARIANTS) * DDP_ROUNDS
    t0 = time.perf_counter()
    nccl = dp_check.run_ranks(1, [{**spec, "ddp": v, "timing": True} for v in order] + [check],
                              os.path.join(tmp, "dp_nccl"), device=device.type,
                              backend="nccl" if device.type == "cuda" else "gloo",
                              threads=_rank_threads(1))[0]
    t1 = time.perf_counter()
    gloo = dp_check.run_ranks(2, [spec, check], os.path.join(tmp, "dp_gloo"),
                              device=device.type, backend="gloo", threads=_rank_threads(2))
    launch_s = [t1 - t0, time.perf_counter() - t1]
    later = {v: [] for v in DDP_VARIANTS}  # each variant's steps 2.., over its rounds
    worst = 0.0
    for v, r in zip(order, nccl):
        if r["launches"] != [TRAIN_LAUNCHES] * DP_STEPS:
            raise AssertionError(f"[train-dp] NCCL ({v}) launches a step {r['launches']}")
        worst = max(worst, _loss_diff(r["losses"][:LOSS_STEPS], one["losses"][:LOSS_STEPS]))
        later[v] += r["ms"][1:]
    _hold("train-dp", f"1 NCCL rank (every variant) vs one process at "
          f"{TRAIN_HW[0]}x{TRAIN_HW[1]}, steps 1..{LOSS_STEPS}", {"loss": worst}, TOL_LIVE_BN)
    out = dict(one_ms=one["ms"], variant_ms={v: r["ms"] for v, r in zip(order, nccl)},
               gloo_ms=[r[0]["ms"] for r in gloo], launch_s=launch_s, nccl_loss=worst)
    out["nccl_check"] = _check_ranks("train-dp", f"1 NCCL rank vs one process at "
                                     f"{TRAIN_CHECK_HW[0]}x{TRAIN_CHECK_HW[1]}", [nccl[-1]],
                                     check_one, TRAIN_LAUNCHES)
    out["gloo"] = _check_ranks("train-dp", f"2 gloo ranks at B=1 vs one process at B=2, "
                               f"{TRAIN_HW[0]}x{TRAIN_HW[1]}", [r[0] for r in gloo], one,
                               TRAIN_LAUNCHES, replayed=False)
    out["gloo_check"] = _check_ranks("train-dp", f"2 gloo ranks at B=1 vs one process at B=2, "
                                     f"{TRAIN_CHECK_HW[0]}x{TRAIN_CHECK_HW[1]}",
                                     [r[1] for r in gloo], check_one, TRAIN_LAUNCHES)
    if not all(all(r[1]["replayed"]) for r in gloo) or not all(nccl[-1]["replayed"]):
        raise AssertionError("[train-dp] a rank did not replay every ReLU decision")
    paths.launches["train-dp"] = {k: sum(c[k] for c in gloo[0][0]["launches"])
                                  for k in TRAIN_LAUNCHES}
    paths.frame_ms["train-dp"] = gloo[0][0]["ms"]
    medians = {"one process": _later_median(one["ms"]),
               **{f"NCCL {v}": statistics.median(ms) for v, ms in later.items()}}
    log(f"[train-dp] median step ms at B=2 over steps 2..{DP_STEPS} ({DDP_ROUNDS} runs of each "
        f"NCCL variant, interleaved), each alone on the card: {json.dumps(medians)}; the NCCL "
        f"steps {json.dumps({v: [round(t, 2) for t in ms] for v, ms in later.items()})}; gloo "
        f"ranks at B=1, sharing it: {[_later_median(r[0]['ms']) for r in gloo]}; launches "
        f"{launch_s[0]:.1f} s (NCCL) and {launch_s[1]:.1f} s (gloo)")
    out["medians"] = medians
    return out


def _split_flips(model, snaps: list) -> list[dict]:
    """For each (weights, global batch) of `snaps`: the decisions
    (`train_check.vps_decisions`) that the batch at B=4 in one process and
    its two ranks' halves at B=2 take apart, at those weights (both on the
    card): {"mask_pool": elements, "hungarian": assignments}."""
    from video_knet_tpu_torch.parallel.mesh import DataMesh, shard_batch
    from video_knet_tpu_torch.tools.train_check import vps_decisions

    out = []
    for weights, batch in snaps:
        model.load_state_dict(weights)
        whole = vps_decisions(model, batch)
        halves = [vps_decisions(model, shard_batch(DataMesh(r, 2), batch)) for r in range(2)]
        out.append({kind: sum(int((w != torch.cat([a, b])).sum())
                              for w, a, b in zip(whole[i], halves[0][i], halves[1][i]))
                    for i, kind in enumerate(("mask_pool", "hungarian"))})
    return out


def phase_train_cli_dp(device, paths: Paths, root: str, tmp: str) -> dict:
    """`train_vps` under `torchrun --nproc_per_node=2` over gloo, one epoch
    then a resumed second, against the one-process CLI for two epochs; each
    step's records held to TOL_CLI_DP_LOSS beside the decisions its batch
    splits take apart at the one-process run's weights (`_split_flips`)."""
    import copy
    import subprocess

    import video_knet_tpu_torch.train.vps as tvps
    from video_knet_tpu_torch.utils.checkpoint import load_model_state

    n = DATA_SEQS * DATA_FRAMES // CLI_DP_B  # steps an epoch
    dev = [] if device.type == "cuda" else ["--device", "cpu"]
    base = ["--data-root", root, "--crop", *map(str, TRAIN_HW), "--log-interval", "1",
            "--batch-size", str(CLI_DP_B), *dev]
    work = os.path.join(tmp, "train_vps_dp")

    def torchrun(epochs: int, *extra):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node=2", "-m", "video_knet_tpu_torch.tools.dp_check", "--cli",
               "train_vps", *base, "--epochs", str(epochs), "--work-dir", work,
               "--dist-backend", "gloo", *extra]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                env=dict(os.environ, OMP_NUM_THREADS=str(_rank_threads(2))))

    def finish(proc) -> str:
        out, err = proc.communicate(timeout=600)
        for line in out.splitlines():
            log(f"[train-cli-dp] {line}")
        if proc.returncode != 0:
            raise AssertionError(f"[train-cli-dp] torchrun exited {proc.returncode}: "
                                 f"{err[-3000:]}")
        return out

    snaps: list = []

    def keep(state, batch):  # each step's weights and global batch, for `_split_flips`
        snaps.append(({k: v.detach().clone() for k, v in state.model.state_dict().items()},
                      torch.utils._pytree.tree_map(torch.clone, batch)))

    # the first epoch over two ranks while the one-process CLI runs here
    t0 = time.perf_counter()
    first = torchrun(1)
    try:
        one = _cli_run(paths, "train-cli-dp-one", "train_vps",
                       [*base, "--epochs", "2", "--work-dir",
                        os.path.join(tmp, "train_vps_one")], tvps, TRAIN_LAUNCHES, 2 * n,
                       each=keep)
    finally:
        texts = [finish(first)]
    texts.append(finish(torchrun(2, "--resume-from", os.path.join(work, "ckpt", "step_1"))))
    dp_s = time.perf_counter() - t0
    got = _records(texts[0]) + _records(texts[1])
    want = one["records"]
    if [(r["epoch"], r["iter"]) for r in got] != [(r["epoch"], r["iter"]) for r in want]:
        raise AssertionError(f"[train-cli-dp] records {got} vs {want}")
    model = copy.deepcopy(one["state"].model).eval()
    flips = _uncounted(lambda: _split_flips(model, snaps))
    del model, snaps
    steps = []
    for i, (g, w, f) in enumerate(zip(got, want, flips)):
        gaps = {k: abs(g[k] - w[k]) / max(abs(w[k]), 1.0) for k in w
                if k not in ("epoch", "iter", "imgs_per_sec")}
        worst = max(gaps, key=gaps.get)
        total = abs(g["total_loss"] - w["total_loss"]) / abs(w["total_loss"])
        split = f["mask_pool"] + f["hungarian"] > 0
        # held: every loss at the first step, the total loss after it
        held, limit = ((gaps[worst], TOL_CLI_DP_LOSS[1] if split else TOL_CLI_DP_LOSS[0])
                       if i == 0 else (total, TOL_CLI_DP_LOSS[0]))
        steps.append(dict(step=i + 1, gap=gaps[worst], key=worst, total=total, held=held,
                          limit=limit, **f,
                          over_1e3=sorted(k for k, v in gaps.items() if v > TOL_CLI_DP_LOSS[0])))
        log(f"[train-cli-dp] step {i + 1}: losses within {gaps[worst]:.3e} ({worst}), total "
            f"{total:.3e}; held {'every loss' if i == 0 else 'the total'} to {limit:g}; "
            f"decisions the batch splits take apart {json.dumps(f)}; losses beyond "
            f"{TOL_CLI_DP_LOSS[0]:g}: {steps[-1]['over_1e3']}")
    bad = [st for st in steps if not st["held"] <= st["limit"]]
    if bad:
        raise AssertionError(f"[train-cli-dp] records vs the one-process CLI beyond their "
                             f"limits: {bad}")
    a = load_model_state(os.path.join(work, "ckpt", "step_2"))
    b = load_model_state(os.path.join(tmp, "train_vps_one", "ckpt", "step_2"))
    diffs = {"loss": max(st["gap"] for st in steps), **_state_diffs(a, b)}
    _hold("train-cli-dp", "2 torchrun ranks vs one process, final statistics",
          {"stats": diffs["stats"]}, TOL_LIVE_BN)
    with open(os.path.join(work, "train_log.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    if (sorted(os.listdir(work)) != ["ckpt", "train_log.jsonl"] or logged != got
            or sorted(os.listdir(os.path.join(work, "ckpt"))) != ["step_1", "step_2"]):
        raise AssertionError(f"[train-cli-dp] work dir {os.listdir(work)}, log {len(logged)} "
                             f"records")
    launches = [json.loads(m.group(2)) for t in texts  # the ranks' lines may share one
                for m in re.finditer(r"LAUNCHES rank=(\d) (\{[^}]*\})", t)]
    want_l = {k: v * n for k, v in TRAIN_LAUNCHES.items()}
    if len(launches) != 4 or any(c != want_l for c in launches):
        raise AssertionError(f"[train-cli-dp] each rank's launches {launches}, expected "
                             f"{want_l} an epoch")
    paths.launches["train-cli-dp"] = {k: sum(c[k] for c in launches) for k in want_l}
    per_rank = sum('"iter"' in line for line in "".join(texts).splitlines())
    if per_rank != 2 * n:
        raise AssertionError(f"[train-cli-dp] {per_rank} records printed, expected {2 * n}")
    log(f"[train-cli-dp] 2 ranks x 2 epochs of {n} steps (B={CLI_DP_B}) in {dp_s:.1f} s, the "
        f"first beside the one-process CLI ({one['seconds']:.1f} s, median step "
        f"{one['median_ms']:.2f} ms, both on the card at once)")
    return dict(dp_s=dp_s, one_s=one["seconds"], one_ms=one["median_ms"], diffs=diffs,
                steps=steps, imgs_per_sec=[r["imgs_per_sec"] for r in got])


def phase_train_model_axis(device, paths: Paths, tmp: str) -> dict:
    """The mesh's `model` axis on MODEL_AXIS_N gloo ranks sharing the card
    (a 1 x MODEL_AXIS_N mesh, `tools/dp_check.py`), against the one-process
    step on the card: VPS `video_knet_kitti_step_r50` at 384x1248, global
    B=1, the image rows in bands (`parallel/model_axis.py`), and VIS
    `video_knet_vis_r50_ytvis2019` on 1x5x360x640 clips, the frames split
    3 + 2 from the backbone to the losses; MODEL_AXIS_STEPS steps of each
    preset, then one step of each with live BatchNorm (`norm_eval=False`),
    and one step of the VIS volume preset on the same clips; one step of the
    VPS preset at MODEL_AXIS_KITTI_HW, 376 rows (not a multiple of 32: bands
    of 192 + 184), and at that size with the MSDeformAttn pixel decoder
    (`vps-deform-376`: six encoder layers over strides 8-32, each gathering
    the whole value maps), and with the DetectoRS R-50 backbone
    (`vps-rfp-376`: the recursive feature pyramid, no neck; its SACs' global
    contexts summed over the group, `_log_sac_reduces`); one step of the
    deformable VIS preset (`vis-deform`, the decoder per frame). Every step's
    losses (the
    presets' beside the hard decisions the split takes apart, which loosen
    that step's limit; at every step the ranks replay the one-process
    run's ReLU decisions and mask-pool binarizations on their band or
    frames), the presets' first step's gradient and the live statistics within
    TOL_MODEL_AXIS; each rank's backbone
    input its share; 7 / 7 / 1
    launches a step on each rank (4 / 4 / 1 in volume mode). Per rank: step
    ms, peak memory beside the one-process run's, the bytes it hands to the
    collectives a step: the VPS bands gather nothing but the decoder's value
    maps (`dp_check.decoder_gather_bytes`, exactly), the VIS frames gather
    the merge's per-frame kernels alone, below MODEL_AXIS_VIS_GATHER_SHARE
    of the pyramid gather (`_vis_pyramid_gather`); both reduce."""
    from video_knet_tpu_torch.configs import get_config
    from video_knet_tpu_torch.parallel.model_axis import frame_counts
    from video_knet_tpu_torch.tools.dp_check import decoder_gather_bytes
    from video_knet_tpu_torch.train import vis as tvis
    from video_knet_tpu_torch.train import vps as tvps

    vps, vis = get_config("video_knet_kitti_step_r50"), get_config("video_knet_vis_r50_ytvis2019")
    if vis.num_frames != VIS_FRAMES:
        raise AssertionError("[train-model-axis] not the VIS preset's clip length")
    specs, expected, shares = {}, {}, {}
    b, (h, w) = 1, TRAIN_HW
    for tag, cfg, make, hw, launches, share in (
            ("vps", vps, tvps, TRAIN_HW, TRAIN_LAUNCHES,
             [(2 * b, h // MODEL_AXIS_N, w, 3)] * MODEL_AXIS_N),
            ("vis", vis, tvis, VIS_HW, VIS_TRAIN_LAUNCHES,
             [(b * c, *VIS_HW, 3) for c in frame_counts(VIS_FRAMES, MODEL_AXIS_N)])):
        batches = [make.make_synthetic_batch(cfg, b, hw, seed=i, device="cpu")
                   for i in range(MODEL_AXIS_STEPS)]
        specs[tag] = dict(kind=tag, cfg=cfg, seed=MODEL_AXIS_SEED, batches=batches,
                          decisions=True)
        specs[f"{tag}-live"] = dict(kind=tag, cfg=dataclasses.replace(cfg, norm_eval=False),
                                    seed=MODEL_AXIS_SEED, batches=batches[:1], decisions=True)
        for t in (tag, f"{tag}-live"):
            expected[t], shares[t] = launches, [[x] for x in share]
    volume = get_config("video_knet_vis_volume_r50_ytvis2019")
    specs["vis-volume"] = dict(kind="vis", cfg=volume, seed=MODEL_AXIS_SEED, decisions=True,
                               batches=[tvis.make_synthetic_batch(volume, b, VIS_HW, seed=0,
                                                                  device="cpu")])
    expected["vis-volume"], shares["vis-volume"] = VIS_VOLUME_TRAIN_LAUNCHES, shares["vis"]
    specs["vps-376"] = dict(kind="vps", cfg=vps, seed=MODEL_AXIS_SEED, decisions=True,
                            batches=[tvps.make_synthetic_batch(vps, b, MODEL_AXIS_KITTI_HW,
                                                               seed=0, device="cpu")])
    expected["vps-376"] = TRAIN_LAUNCHES
    shares["vps-376"] = [[(2 * b, rows, MODEL_AXIS_KITTI_HW[1], 3)]
                         for rows in MODEL_AXIS_KITTI_BANDS]
    deform = dataclasses.replace(vps, neck_type="msdeform_pixel_decoder")
    specs["vps-deform-376"] = {**specs["vps-376"], "cfg": deform,
                               "spread_offsets": MODEL_AXIS_DEFORM_REACH}
    expected["vps-deform-376"], shares["vps-deform-376"] = TRAIN_LAUNCHES, shares["vps-376"]
    vis_deform = get_config("video_knet_vis_r50_deformable_ytvis2019")
    if vis_deform.neck_type != "msdeform_pixel_decoder":
        raise AssertionError("[train-model-axis] not the deformable VIS preset")
    specs["vis-deform"] = dict(kind="vis", cfg=vis_deform, seed=MODEL_AXIS_SEED,
                               decisions=True, spread_offsets=MODEL_AXIS_DEFORM_REACH,
                               batches=[tvis.make_synthetic_batch(vis_deform, b, VIS_HW,
                                                                  seed=0, device="cpu")])
    expected["vis-deform"], shares["vis-deform"] = VIS_TRAIN_LAUNCHES, shares["vis"]
    specs["vps-rfp-376"] = {**specs["vps-376"],
                            "cfg": dataclasses.replace(vps, backbone="detectors_r50")}
    expected["vps-rfp-376"], shares["vps-rfp-376"] = TRAIN_LAUNCHES, shares["vps-376"]
    out = _model_axis_runs("train-model-axis", device, tmp, specs, expected, shares)
    _log_sac_reduces("train-model-axis", "vps-rfp-376", "detectors_r50", 2 * b, out)
    # neither split gathers the pyramid: the band split gathers nothing but
    # the decoder's value maps, the frame split the merge's per-frame kernels
    # (none in volume mode); the heads and losses run on the band or the
    # frames, their sums reduced
    pyramid = _vis_pyramid_gather()
    # the decoder's six encoder layers on [ref; key]
    values = decoder_gather_bytes(MODEL_AXIS_KITTI_HW, MODEL_AXIS_N, 2 * b, layers=6)
    for tag in specs:
        comm = [c for r in out[tag]["comm"] for c in r]
        ok = (all(c["gather"] == (values if tag == "vps-deform-376" else 0)
                  and c["reduce"] > 0 and c["halo"] > 0 for c in comm)
              if tag.startswith("vps") else
              all(c["gather"] < MODEL_AXIS_VIS_GATHER_SHARE * pyramid and c["reduce"] > 0
                  for c in comm))
        if not ok:
            raise AssertionError(f"[train-model-axis] {tag}: bytes by kind {comm}")
        if tag == "vps-deform-376":
            log(f"[train-model-axis] {tag}: the decoder's value-map gather a step on each "
                f"rank {[max(c['gather'] for c in r) for r in out[tag]['comm']]} bytes, as "
                f"reckoned ({values}: {2 * b} images, [ref; key]; {values // (2 * b)} an "
                f"image)")
        if tag.startswith("vis"):
            log(f"[train-model-axis] {tag}: gather a step by rank "
                f"{[max(c['gather'] for c in r) for r in out[tag]['comm']]} bytes, below "
                f"{100 * MODEL_AXIS_VIS_GATHER_SHARE:g}% of the pyramid gather's {pyramid}")
    paths.launches["train-model-axis"] = {
        k: sum(c[k] for tag in specs for c in out[tag]["launches"]) for k in TRAIN_LAUNCHES}
    return out


def _log_sac_reduces(path: str, tag: str, backbone: str, images: int, out: dict) -> None:
    """Print the all-reduces of an RFP case's SAC global contexts a rank a
    step (`dp_check.sac_reduces`, reckoned from the backbone) beside the
    bytes each rank reduced; the reckoning must lie within them."""
    from video_knet_tpu_torch.models.backbones import build_backbone
    from video_knet_tpu_torch.tools.dp_check import sac_reduces

    count, nbytes = sac_reduces(build_backbone(backbone), images)
    reduced = [c["reduce"] for r in out[tag]["comm"] for c in r]
    log(f"[{path}] {tag}: SAC global-context all-reduces a rank a step {count} ({count // 2} "
        f"forward, {count // 2} backward), {nbytes} bytes, of the {reduced} bytes each rank "
        f"reduced")
    if not all(r >= nbytes for r in reduced):
        raise AssertionError(f"[{path}] {tag}: reduced {reduced} bytes, below the SACs' "
                             f"{nbytes}")


def _vis_pyramid_gather() -> int:
    """The bytes a VIS rank handed a step to the pyramid's gather while the
    heads ran whole (fp32, R-50 + FPN's 256 channels at VIS_HW): its frames'
    levels forward (padded to the longest share), the clip's back."""
    from video_knet_tpu_torch.parallel.model_axis import frame_counts

    h, w = VIS_HW
    area = sum(-(-h // s) * -(-w // s) for s in (4, 8, 16, 32))
    return 4 * 256 * area * (max(frame_counts(VIS_FRAMES, MODEL_AXIS_N)) + VIS_FRAMES)


def _model_axis_runs(path: str, device, tmp: str, specs: dict, expected: dict,
                     shares: dict) -> dict:
    """Each spec's one-process run on the card (recording every step's
    ReLU decisions and mask-pool binarizations; its memory freed before the
    ranks start), then all of
    them over MODEL_AXIS_N gloo ranks sharing the card, each rank replaying
    the decisions on its rows, band or frames at every step; every rank held against the
    one-process run as `phase_train_model_axis` says. {tag: its record}."""
    from video_knet_tpu_torch.parallel.mesh import DataMesh
    from video_knet_tpu_torch.tools import dp_check

    one = {}
    for tag, spec in specs.items():  # here, before the ranks start, recording the decisions
        relus: list = []
        pools: list = []
        one[tag] = _uncounted(lambda: dp_check.train_steps(
            DataMesh(), device, spec, record=relus, pools=pools))
        one[tag]["relus"], one[tag]["pools"] = relus, pools
        if device.type == "cuda":  # the ranks share the card
            gc.collect()
            torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = dp_check.run_ranks(
        MODEL_AXIS_N, [{**spec, "n_model": MODEL_AXIS_N, "relus": one[tag].pop("relus"),
                        "pools": one[tag].pop("pools")}
                       for tag, spec in specs.items()], os.path.join(tmp, path),
        device=device.type, backend="gloo", threads=_rank_threads(MODEL_AXIS_N))
    out = {"launch_s": time.perf_counter() - t0}
    from video_knet_tpu_torch.ops.kernels import mask_ops as mo

    for i, (tag, spec) in enumerate(specs.items()):
        per_rank = [r[i] for r in ranks]
        for r in per_rank:  # the ranks' launch shapes, for kernel-shapes to hold
            for k, shapes in r["shapes"].items():
                mo.SHAPES[k].update(shapes)
        if not all(r["replayed"] == [True] * len(spec["batches"]) for r in per_rank):
            raise AssertionError(f"[{path}] {tag}: a rank did not replay every ReLU "
                                 f"decision and mask-pool binarization of every step")
        log(f"[{path}] {tag}: each step's replayed decisions that a rank's own would "
            f"have taken otherwise: ReLU {[r['differ'] for r in per_rank]}, mask-pool pixels "
            f"{[r['pool_differ'] for r in per_rank]}")
        tol = TOL_MODEL_AXIS_LIVE if tag.endswith("live") else TOL_MODEL_AXIS
        flips = []
        if spec.get("decisions"):  # losses held step by step, beside the decisions
            tol = {k: v for k, v in tol.items() if k != "loss"}
            flips = [sum(int((a != b).sum()) for a, b in zip(x, y))
                     for x, y in zip(one[tag]["decisions"], per_rank[0]["decisions"])]
            for k, w in enumerate(one[tag]["losses"]):
                gaps = {key: max(abs(r["losses"][k][key] - w[key]) for r in per_rank)
                        / max(abs(w[key]), 1e-6) for key in w}
                worst_key = max(gaps, key=gaps.get)
                limit = TOL_MODEL_AXIS_SPLIT_LOSS if flips[k] else TOL_MODEL_AXIS["loss"]
                log(f"[{path}] {tag} step {k + 1}: losses within "
                    f"{gaps[worst_key]:.3e} ({worst_key}); hard decisions the split takes "
                    f"apart {flips[k]}; held to {limit:g}")
                if not gaps[worst_key] <= limit:
                    raise AssertionError(f"[{path}] {tag} step {k + 1}: "
                                         f"{worst_key} {gaps[worst_key]:.3e} beyond {limit:g}")
        got = [r["inputs"] for r in per_rank]
        if got != shares[tag]:
            raise AssertionError(f"[{path}] {tag}: the ranks' backbone inputs {got}, "
                                 f"expected their shares {shares[tag]}")
        worst = _check_ranks(path, f"{tag}: {MODEL_AXIS_N} gloo ranks (1x"
                             f"{MODEL_AXIS_N} mesh) vs one process, {len(spec['batches'])} "
                             f"step(s)", per_rank, one[tag], expected[tag], tol=tol)
        one_peak = one[tag]["peak_bytes"]
        out[tag] = dict(
            worst=worst, inputs=got, one_ms=one[tag]["ms"], one_peak=one_peak,
            rank_ms=[r["ms"] for r in per_rank], rank_peak=[r["peak_bytes"] for r in per_rank],
            peak_share=[r["peak_bytes"] / one_peak if one_peak else None for r in per_rank],
            comm=[r["comm"] for r in per_rank], launches=per_rank[0]["launches"], apart=flips)
        for m, r in enumerate(per_rank):
            share = out[tag]["peak_share"][m]
            limit = MODEL_AXIS_PEAK_SHARE.get(tag)
            log(f"[{path}] {tag} rank {m}: peak {r['peak_bytes']} bytes, "
                f"{'n/a' if share is None else f'{100 * share:.1f}%'} of the one-process "
                f"step's {one_peak}{'' if limit is None else f' (below {100 * limit:.1f}%)'}; "
                f"bytes a step by kind {json.dumps(r['comm'])}")
            if limit is not None and share is not None and not share < limit:
                raise AssertionError(f"[{path}] {tag} rank {m}: peak {share:.3f} of one "
                                     f"process's, not below {limit}")
        log(f"[{path}] {tag}: step ms one process {json.dumps(one[tag]['ms'])}, ranks "
            f"{json.dumps(out[tag]['rank_ms'])}; peak memory one process "
            f"{one[tag]['peak_bytes']} bytes, ranks {out[tag]['rank_peak']}; bytes each rank "
            f"hands to the collectives a step {json.dumps(out[tag]['comm'])}; launches a step on "
            f"rank 0 {json.dumps(per_rank[0]['launches'])}")
    return out


def phase_train_model_axis_swin(device, paths: Paths, tmp: str) -> dict:
    """The band split of Swin and MiT on MODEL_AXIS_N gloo ranks sharing
    the card, against the one-process step on the card, as
    `phase_train_model_axis` holds it: Swin-B VIP-Seg
    (`video_knet_vipseg_swin_b`) at 736x1280, global B=1, drop path 0.3
    drawn from the step-seeded generator, the image's 23 stride-32 rows in
    bands of 12 + 11 (384 + 352 rows), MODEL_AXIS_SWIN_STEPS steps, and one
    step at VIP-Seg's native 720x1280 (bands of 384 + 336: the last holds
    the half stride-32 row); MiT-b0 under the default VPS config at
    384x1248 in bands of 192 rows and at 376x1248 (192 + 184), one step
    each; the KITTI-STEP R-50 preset with the Swin-B RFP backbone
    (`swin-b-rfp-376`) at 376x1248, one step. 7 / 7 / 1 launches a step on
    each rank."""
    from video_knet_tpu_torch.config import VideoKNetConfig
    from video_knet_tpu_torch.configs import get_config
    from video_knet_tpu_torch.train.vps import make_synthetic_batch

    swin = get_config("video_knet_vipseg_swin_b")
    if swin.backbone != "swin_base" or swin.backbone_drop_path_rate != 0.3:
        raise AssertionError("[train-model-axis-swin] not the Swin-B preset's drop path")
    specs, shares = {}, {}
    mit = dataclasses.replace(VideoKNetConfig(), backbone="mit_b0")
    swin_rfp = dataclasses.replace(get_config("video_knet_kitti_step_r50"), backbone="swin_b_rfp")
    for tag, cfg, hw, steps, bands in (
            ("swin-b", swin, SWIN_VIPSEG_HW, MODEL_AXIS_SWIN_STEPS, MODEL_AXIS_SWIN_BANDS),
            ("swin-b-720", swin, MODEL_AXIS_VIPSEG_HW, 1, MODEL_AXIS_VIPSEG_BANDS),
            ("mit-b0", mit, TRAIN_HW, 1, (TRAIN_HW[0] // MODEL_AXIS_N,) * MODEL_AXIS_N),
            ("mit-b0-376", mit, MODEL_AXIS_KITTI_HW, 1, MODEL_AXIS_KITTI_BANDS),
            ("swin-b-rfp-376", swin_rfp, MODEL_AXIS_KITTI_HW, 1, MODEL_AXIS_KITTI_BANDS)):
        specs[tag] = dict(kind="vps", cfg=cfg, seed=MODEL_AXIS_SEED, decisions=True, batches=[
            make_synthetic_batch(cfg, 1, hw, seed=i, device="cpu") for i in range(steps)])
        shares[tag] = [[(2, rows, hw[1], 3)] for rows in bands]
    out = _model_axis_runs("train-model-axis-swin", device, tmp, specs,
                           {tag: TRAIN_LAUNCHES for tag in specs}, shares)
    _log_sac_reduces("train-model-axis-swin", "swin-b-rfp-376", "swin_b_rfp", 2, out)
    # Swin-B and its RFP gather nothing; MiT-b0 gathers its spatially reduced keys
    for tag in specs:
        mit_b0 = tag.startswith("mit-b0")
        if not all(c["halo"] > 0 and c["reduce"] > 0 and (c["gather"] > 0) == mit_b0
                   for r in out[tag]["comm"] for c in r):
            raise AssertionError(f"[train-model-axis-swin] {tag}: bytes by kind "
                                 f"{out[tag]['comm']}")
    # stage 3's 46 rows (45 at 720) pad to 49: its shifted windows' last one
    # joins the map's last rows to rows 0-2, across the bands
    for tag in ("swin-b", "swin-b-720"):
        if not all(c["ring"] > 0 for r in out[tag]["comm"] for c in r):
            raise AssertionError(f"[train-model-axis-swin] {tag}: no ring exchange "
                                 f"{out[tag]['comm']}")
    paths.launches["train-model-axis-swin"] = {
        k: sum(c[k] for tag in specs for c in out[tag]["launches"]) for k in TRAIN_LAUNCHES}
    return out


def phase_profile_train(device, paths: Paths) -> dict:
    """`tools/profile_train.py:profile` at its default configuration (R-50,
    KITTI-STEP heads, max_insts 8), 384x1248, B=1, in fp32 and in bf16:
    every part's time finite and positive, the heads' estimate full -
    backbone - loss block, one `full` step launching 7 / 7 / 1, and each
    run's launches (the counts set to 0 just before it) those its parts'
    calls make (a count pass, the warm-up and the timed calls; one forward
    for the loss block's outputs and one step more, the one whose launches
    the report reads). Both
    reports are printed, each on a line of its own."""
    from video_knet_tpu_torch.config import VideoKNetConfig
    from video_knet_tpu_torch.tools import profile_train

    calls = 1 + profile_train.WARMUP + PROFILE_ITERS
    # `fwd` and `full` launch a step's kernels a call, the loss block its one
    # solve; one forward makes the loss block's outputs, one more step the
    # report's launches
    expected = {k: (2 * calls + 1) * v + (calls * v if k == "hungarian" else v)
                for k, v in TRAIN_LAUNCHES.items()}
    out = {}
    for tag, bf16 in (("fp32", False), ("bf16", True)):
        path = f"profile-train-{tag}"
        cfg = VideoKNetConfig(max_insts=8, bf16_train=bf16)
        t0 = time.perf_counter()
        _reset_counts()
        rep = profile_train.profile(cfg, TRAIN_HW, 1, iters=PROFILE_ITERS, device=device)
        paths.launches[path] = _counts()
        secs = time.perf_counter() - t0
        log(f"[{path}] {json.dumps(rep)}")
        times = [rep[k] for k in profile_train.MS_KEYS.values()]
        times += [t for k in profile_train.MS_KEYS.values() for t in rep[f"{k}_spread"]]
        if not all(np.isfinite(t) and t > 0 for t in times):
            raise AssertionError(f"[{path}] times {times}")
        est = rep["full_ms"] - rep["backbone_fwd_bwd_ms"] - rep["loss_block_fwd_bwd_ms"]
        if rep["heads_fwd_bwd_ms_est"] != est or rep["bf16"] != bf16:
            raise AssertionError(f"[{path}] heads {rep['heads_fwd_bwd_ms_est']} against {est}")
        if rep["launches"] != TRAIN_LAUNCHES or paths.launches[path] != expected:
            raise AssertionError(f"[{path}] launches in a full step {rep['launches']} (expected "
                                 f"{TRAIN_LAUNCHES}), in the run {paths.launches[path]} "
                                 f"(expected {expected})")
        out[tag] = dict(report=rep, seconds=secs)
    log(f"[profile-train] fp32 {out['fp32']['seconds']:.1f} s, bf16 {out['bf16']['seconds']:.1f}"
        f" s; full / fwd / backbone / loss block / heads est ms: " + "; ".join(
            f"{tag} " + " / ".join(f"{out[tag]['report'][k]:.2f}" for k in (
                "full_ms", "fwd_ms", "backbone_fwd_bwd_ms", "loss_block_fwd_bwd_ms",
                "heads_fwd_bwd_ms_est")) for tag in out))
    return out


def phase_kitti_prepare(device, paths: Paths, tmp: str) -> dict:
    """A raw KITTI-STEP tree (`data_check.write_kitti_step_raw`: train
    sequences 0 and 1, val sequence 2, KITTI_RAW_FRAMES frames of 376x1248
    each) through the port's `tools/kitti_step_prepare`, then
    `tools/train_vps` in process on the prepared tree: the R-50 default
    config at 384x1248, B=2, one epoch of 2 steps (7 / 7 / 1 launches a
    step, finite losses, 0 host syncs after the first step)."""
    import video_knet_tpu_torch.train.vps as tvps
    from video_knet_tpu_torch.data.datasets import KittiStepDVPS
    from video_knet_tpu_torch.tools.data_check import write_kitti_step_raw

    t0 = time.perf_counter()
    images, panoptic = write_kitti_step_raw(os.path.join(tmp, "kitti_raw"), seqs=KITTI_RAW_SEQS,
                                            n_frames=KITTI_RAW_FRAMES, hw=KITTI_RAW_HW,
                                            n_things=DATA_THINGS, seed=DATA_SEED)
    root = os.path.join(tmp, "kitti_prepared")
    t1 = time.perf_counter()
    text = _run_cli("kitti_step_prepare",
                    ["--raw-images", images, "--raw-panoptic", panoptic, "--out", root])
    prepare_s = time.perf_counter() - t1
    done = [line for line in text.splitlines() if not line.startswith("skip missing ")]
    want = [f"{split}: done -> {os.path.join(root, 'video_sequence', split)}"
            for split in ("train", "val")]
    if done != want:
        raise AssertionError(f"[kitti-prepare] printed {done}")
    for split, seqs in (("train", KITTI_RAW_SEQS[:2]), ("val", KITTI_RAW_SEQS[2:])):
        ds = KittiStepDVPS(root, split)
        frames = [(s, f) for s in seqs for f in range(KITTI_RAW_FRAMES)]
        if sorted(ds.frames) != frames or any(x.ann is None for x in ds.frames.values()):
            raise AssertionError(f"[kitti-prepare] {split}: frames {sorted(ds.frames)}")
    steps = len(KITTI_RAW_SEQS[:2]) * KITTI_RAW_FRAMES // KITTI_PREPARE_B
    dev = [] if device.type == "cuda" else ["--device", "cpu"]
    rec = _cli_run(paths, "kitti-prepare-train", "train_vps",
                   ["--data-root", root, "--crop", *map(str, TRAIN_HW), "--epochs", "1",
                    "--batch-size", str(KITTI_PREPARE_B), "--log-interval", "1",
                    "--work-dir", os.path.join(tmp, "kitti_prepare_train"), *dev],
                   tvps, TRAIN_LAUNCHES, steps)
    _finite_records("kitti-prepare-train", rec["records"], steps)
    out = dict(prepare_s=prepare_s, seconds=time.perf_counter() - t0,
               step_ms=rec["step_ms"], total=[r["total_loss"] for r in rec["records"]])
    log(f"[kitti-prepare] raw {KITTI_RAW_HW[0]}x{KITTI_RAW_HW[1]} tree prepared in "
        f"{prepare_s:.2f} s; train_vps {steps} steps of B={KITTI_PREPARE_B}, total_loss "
        f"{out['total']}; the phase {out['seconds']:.1f} s")
    return out


@torch.no_grad()
def _unsaturate_fusion(rfp, img) -> list[float]:
    """Scale each RFP fusion conv so that its output has unit spread on the
    levels of `img`'s second pass: random backbone weights give levels in
    the thousands, whose fusion sigmoid saturates to exactly 0 or 1 in fp32
    and passes no gradient. Returns the scales."""
    levels = []
    hook = rfp.fpn.register_forward_hook(lambda m, a, out: levels.append(out))
    rfp(img)
    hook.remove()
    scales = []
    for i, new in enumerate(levels[1][:4]):
        conv = getattr(rfp, f"fusion_weight{i}")
        scale = 1.0 / max(float((conv(new) - conv.bias).std()), 1e-12)
        conv.weight.mul_(scale)
        scales.append(scale)
    return scales


def phase_rfp(device, paths: Paths, name: str, tag: str) -> dict:
    """An RFP preset of the image K-Net (no neck: the recursive feature
    pyramid is the backbone's output) at 384x1248, seeded random weights with
    the zero-initialized leaves (`rfp_conv`, SAC's `weight_diff`) drawn
    nonzero and the fusion convs scaled to unit spread (`_unsaturate_fusion`),
    score gate at zero: RFP_IMAGES images through the forward,
    `panoptic_decode` and `segments_to_host` (4 / 4 launches an image), then
    RFP_TRAIN_STEPS steps of `train/image.py:train_step` at B=RFP_TRAIN_B
    (4 / 4 / 1 launches a step, warmup off so that weight decay shows in
    fp32): every parameter takes a nonzero gradient (each `rfp_conv`,
    `fusion_weight`, SAC's `weight_diff`, context convs and switch among
    them) but the DetectoRS stem and layer1, which take none and move by
    weight decay alone, as the reference's optimizer decays its
    stop-gradient leaves."""
    from video_knet_tpu_torch.configs import get_config
    from video_knet_tpu_torch.models.knet import KNet, panoptic_decode
    from video_knet_tpu_torch.models.rfp import RFP
    from video_knet_tpu_torch.tools.train_check import draw_zero_init_leaves
    from video_knet_tpu_torch.train.image import make_synthetic_batch, train_step
    from video_knet_tpu_torch.train.optim import make_optimizer
    from video_knet_tpu_torch.train.train_state import create_train_state

    cfg = get_config(name)
    cfg = dataclasses.replace(cfg, test=dataclasses.replace(cfg.test, instance_score_thr=0.0))
    model = KNet(cfg, generator=torch.Generator().manual_seed(RFP_SEED), device=device)
    if model.neck is not None or not isinstance(model.backbone, RFP):
        raise AssertionError(f"[{tag}] not an RFP backbone without a neck")
    drawn = draw_zero_init_leaves(model, torch.Generator().manual_seed(RFP_SEED))
    first = torch.from_numpy(_frames(RFP_HW, 1)[0]).to(device)
    scales = _unsaturate_fusion(model.backbone, first)
    log(f"[{tag}] fusion convs scaled by {[f'{x:.3g}' for x in scales]} to unit spread")
    n_params = sum(p.numel() for p in model.parameters())
    results, serve = _serve_images(
        tag, model, cfg,
        lambda rpn, stages: _segments(panoptic_decode(rpn, stages, cfg, out_hw=RFP_HW), cfg),
        paths, RFP_HW, RFP_IMAGES)
    _check_segments(tag, results, RFP_HW)
    del serve["images"]

    state = create_train_state(model, make_optimizer(model, steps_per_epoch=1000,
                                                     warmup_iters=0))
    batches = [make_synthetic_batch(cfg, RFP_TRAIN_B, RFP_HW, seed=i, device=device)
               for i in range(RFP_TRAIN_STEPS)]
    detectors = cfg.backbone.startswith("detectors")
    leaves = {k: sum(1 for n, _ in model.named_parameters() if k in n) for k in RFP_LEAVES}
    if not all(leaves[k] for k in (RFP_LEAVES if detectors else RFP_LEAVES[:2])):
        raise AssertionError(f"[{tag}] RFP leaves missing: {leaves}")

    def step(batch):
        nonlocal state
        state, losses = train_step(state, batch)
        return losses

    train = _cut_and_decayed(f"{tag}-train", model, step, batches, IMAGE_TRAIN_LAUNCHES,
                             lambda keys: keys == IMAGE_LOSS_KEYS | {"total_loss"},
                             RFP_CUT if detectors else ())
    paths.launches[f"{tag}-train"] = train["launches"]
    paths.frame_ms[f"{tag}-train"] = train["step_ms"]
    log(f"[{tag}] {n_params} parameters, {len(drawn)} zero-initialized leaves drawn; the RFP "
        f"leaves by kind, each with a nonzero gradient: {json.dumps(leaves)}")
    del model, state
    return dict(serve=serve, train=train, params=n_params)


def _dcn_record(dcn, x) -> dict:
    """`DeformConv2d` (plain PyTorch gathers) on `x`: device time of its
    forward and of its sampling alone, beside one `F.grid_sample` call over
    the same taps and the bound of each."""
    import torch.nn.functional as F

    from video_knet_tpu_torch.models.deform_conv import dcn_sample_points
    from video_knet_tpu_torch.tools.kernel_timing import device_ms

    b, h, w, c = x.shape
    f = dcn.weight.shape[-1]
    taps = dcn.weight.shape[0]
    with torch.no_grad():
        ys, xs = dcn_sample_points(dcn.offset_conv(x), dcn.kernel_size)
        # the same taps in grid_sample's normalized pixel-centre coordinates
        grid = torch.stack([(2 * xs + 1) / w - 1, (2 * ys + 1) / h - 1], dim=-1)
        grid = grid.reshape(b, h, w * taps, 2)
        xn = x.permute(0, 3, 1, 2).contiguous()

        def library():
            return F.grid_sample(xn, grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=False)

        got = dcn.sample(x)
        lib = library().reshape(b, c, h, w, taps).permute(0, 2, 3, 4, 1)
        lib_err = float((lib - got).abs().max() / got.abs().max())
        ms = device_ms(lambda: dcn(x))
        sample_ms = device_ms(lambda: dcn.sample(x))
        lib_ms = device_ms(library)
    hw = b * h * w
    # bytes: the input, the weights and the output once; operations: the
    # offset conv and the contraction (2 a product) and per sampled value
    # the three lerps (2 mul + 1 add each) and the validity multiplies (4)
    io = 4 * (x.numel() + sum(p.numel() for p in dcn.parameters()) + hw * f)
    conv_flops = 2 * hw * taps * c * (2 * taps + f)
    sample_flops = 10 * hw * taps * c
    sample_io = 4 * (x.numel() + hw * taps * 2 + hw * taps * c)

    def bound(n_bytes, flops):
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / OPS_PEAK["fp32"][1] * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    fwd_bound, fwd_by = bound(io, conv_flops + sample_flops)
    s_bound, s_by = bound(sample_io, sample_flops)
    rec = dict(name="deform_conv", route="plain torch (index gathers + one matmul)",
               source="video_knet_tpu_torch/models/deform_conv.py",
               replaces="video_knet_tpu/models/deform_conv.py:22 DeformConv2d (no Pallas)",
               shape=[b, h, w, c, f], ms=ms, bound_ms=fwd_bound, bound_by=fwd_by,
               sample_ms=sample_ms, sample_bound_ms=s_bound, sample_bound_by=s_by,
               library_ms=lib_ms, library="F.grid_sample over the taps",
               library_rel_err=lib_err)
    log(f"[dcn] DeformConv2d at {b}x{h}x{w}x{c} -> {f}: forward {ms * 1e3:.2f} us (bound "
        f"{fwd_bound * 1e3:.2f} us, {fwd_by}); its sampling {sample_ms * 1e3:.2f} us (bound "
        f"{s_bound * 1e3:.2f} us, {s_by}), F.grid_sample over the same taps {lib_ms * 1e3:.2f} "
        f"us (agrees within {lib_err:.1e})")
    return rec


def phase_upernet_align(device, paths: Paths) -> dict:
    """Video K-Net R-50 with the SFNet aligned head as the init head's
    localization FPN (`rpn.fpn_type='upernet_align'`), seeded random
    weights with DCN's offsets drawn nonzero, score gates at zero:
    ALIGN_FRAMES frames of 384x1248 on the device tracker (4 / 4 launches a
    frame); ALIGN_TRAIN_STEPS `train_step`s at B=1 (7 / 7 / 1 a step): the
    aligned head, `dcn_out` and the aux convs take nonzero gradients, the
    head's BatchNorm statistics (running averages, as the reference's) do
    not move; then `DeformConv2d` alone at its 48x156x256 shape."""
    from video_knet_tpu_torch.config import VideoKNetConfig
    from video_knet_tpu_torch.models.sfnet import UperNetAlignHead
    from video_knet_tpu_torch.models.video.inference import VPSInferencePipeline
    from video_knet_tpu_torch.tools.profile_serving import smoke_config, smoke_model
    from video_knet_tpu_torch.tools.train_check import draw_zero_init_leaves
    from video_knet_tpu_torch.train.optim import make_optimizer
    from video_knet_tpu_torch.train.train_state import create_train_state
    from video_knet_tpu_torch.train.vps import make_synthetic_batch, train_step

    base = VideoKNetConfig()
    cfg = smoke_config(dataclasses.replace(
        base, rpn=dataclasses.replace(base.rpn, fpn_type="upernet_align")))
    model = smoke_model(cfg, device)
    head = model.rpn_head.localization_fpn
    if not isinstance(head, UperNetAlignHead):
        raise AssertionError("[upernet-align] the localization FPN is not the aligned head")
    draw_zero_init_leaves(model, torch.Generator().manual_seed(ALIGN_SEED))
    pipe = VPSInferencePipeline(model, cfg, SERVE_HW, device=device)
    frames = [torch.from_numpy(f).to(device) for f in _frames(SERVE_HW, ALIGN_FRAMES)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = paths.drive("upernet-align", lambda i: pipe.run_frame(frames[i], is_first=(i == 0)),
                      list(range(ALIGN_FRAMES)))
    serve_peak = torch.cuda.max_memory_allocated()
    _check_maps("upernet-align", res, SERVE_HW)
    if not torch.isfinite(pipe.prev_obj_feats).all():
        raise AssertionError("[upernet-align] non-finite carried kernels")
    ms = paths.frame_ms["upernet-align"]
    serve = dict(median_ms=statistics.median(ms[1:]), peak_bytes=serve_peak)
    log(f"[upernet-align] segments per frame {[len(r.segments_info) for r in res]}; peak "
        f"memory {serve_peak} bytes")

    state = create_train_state(model, make_optimizer(model, steps_per_epoch=1000))
    batches = [make_synthetic_batch(cfg, 1, TRAIN_HW, seed=i, device=device)
               for i in range(ALIGN_TRAIN_STEPS)]
    frozen, trainable = _frozen_split("upernet-align-train", model)
    stats = {n: b.detach().clone() for n, b in head.named_buffers()}

    def step(batch):
        nonlocal state
        state, losses = train_step(state, batch)
        return losses

    train = _timed_steps("upernet-align-train", step, batches, TRAIN_LAUNCHES,
                         lambda keys: keys == TRAIN_LOSS_KEYS | {"total_loss"})
    _check_trained("upernet-align-train", model, frozen, trainable)
    moved = [n for n, b in head.named_buffers() if not torch.equal(b, stats[n])]
    if moved or not stats:
        raise AssertionError(f"[upernet-align-train] the aligned head's BatchNorm statistics "
                             f"moved: {moved}")
    head_grads = {k: sum(1 for n, p in head.named_parameters() if n.startswith(k)
                         and float(p.grad.norm()) > 0) for k in ("align", "dcn_out", "aux_conv")}
    log(f"[upernet-align-train] the aligned head's parameters with a nonzero gradient "
        f"{json.dumps(head_grads)}; its {len(stats)} BatchNorm buffers unchanged")
    paths.launches["upernet-align-train"] = train["launches"]
    paths.frame_ms["upernet-align-train"] = train["step_ms"]
    x = torch.from_numpy(np.random.RandomState(SEED).randn(*DCN_SHAPE).astype(np.float32))
    dcn = _dcn_record(head.dcn_out, x.to(device))
    del model, state, pipe
    return dict(serve=serve, train=train, dcn=dcn)


def _modules_vs_cpu(device) -> dict:
    """`UperNetAlignHead` v1 and v2 on random levels of the R-50 FPN at
    384x1248, `STDCNet` (813) on a 384x1248 image and `KernelUpdateHead` at
    K=3 at the R-50 stage shape (117 kernels of 9 taps, 48x156, C=256; mask
    logits kept 0.01 from the pooling threshold), seeded weights with the
    zero-initialized leaves drawn: card against CPU, each output within
    TOL_IMAGE_CHECK of its scale."""
    import copy

    from video_knet_tpu_torch.config import KernelUpdateHeadConfig
    from video_knet_tpu_torch.models.kernel_update_head import KernelUpdateHead
    from video_knet_tpu_torch.models.layers import init_parameters
    from video_knet_tpu_torch.models.sfnet import STDCNet, UperNetAlignHead
    from video_knet_tpu_torch.tools.train_check import draw_zero_init_leaves

    rng = np.random.RandomState(SEED)
    h, w = SERVE_HW

    def rand(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    levels = [rand(1, h // s, w // s, 256) for s in (4, 8, 16, 32)]
    logits = rand(1, 117, h // 8, w // 8) * 3
    logits = torch.where(logits >= 0, logits.clamp(min=1e-2), logits.clamp(max=-1e-2))
    cases = [("upernet-v1", UperNetAlignHead(align_type="v1"), (levels,)),
             ("upernet-v2", UperNetAlignHead(align_type="v2"), (levels,)),
             ("stdc813", STDCNet(layers=(2, 2, 2)), (rand(1, h, w, 3),)),
             ("kernel-update-k3", KernelUpdateHead(KernelUpdateHeadConfig(conv_kernel_size=3)),
              (rand(1, h // 8, w // 8, 256), rand(1, 117, 9, 256) * 0.5, logits))]
    worst = {}
    for i, (tag, cpu, args) in enumerate(cases):
        gen = torch.Generator().manual_seed(i)
        init_parameters(cpu, gen)
        draw_zero_init_leaves(cpu, gen)
        cpu.eval()
        card = copy.deepcopy(cpu).to(device)

        def on(dev, a):
            return [on(dev, v) for v in a] if isinstance(a, list) else a.to(dev)

        with torch.no_grad():
            want = _leaf_tensors(cpu(*args))
            got = _leaf_tensors(card(*on(device, list(args))))
        err = max(float((got[k].cpu() - v).abs().max() / max(float(v.abs().max()), 1e-6))
                  for k, v in want.items())
        worst[tag] = err
        if set(got) != set(want) or not err <= TOL_IMAGE_CHECK:
            raise AssertionError(f"[models-check] {tag}: card vs CPU {err}")
    log(f"[models-check] modules card vs CPU, worst relative: {json.dumps(worst)}")
    return worst


def phase_models_check(device, paths: Paths) -> dict:
    """The image K-Net's check configuration (`train_check.image_check_cfg`,
    64-channel heads) over `detectors_r50` and over `swin_t_rfp`, card
    against CPU at 64x96 (weights from `image_margin_seed`, the
    zero-initialized leaves drawn): forward outputs and the panoptic decode;
    one DetectoRS train step under deterministic algorithms, the CPU
    replaying the card's ReLU decisions; then the aligned head, STDC and
    the K=3 stage alone (`_modules_vs_cpu`)."""
    from video_knet_tpu_torch.config import KNetConfig
    from video_knet_tpu_torch.tools import train_check

    worst = {"outputs": 0.0, "losses": 0.0, "grads": 0.0}
    for backbone in ("detectors_r50", "swin_t_rfp"):
        cfg = dataclasses.replace(train_check.image_check_cfg(KNetConfig(), deformable=False),
                                  backbone=backbone)
        train = backbone == "detectors_r50"
        # The DetectoRS step's backward sums some gradients with atomics in no
        # fixed order, and its SAC switch biases sum signed terms over the
        # pixels to ~1/10 of their weights' gradients, so that noise alone
        # moved one 1.09e-3 to 1.48e-3 of its scale over three runs of one
        # process on an H100; with deterministic algorithms it read 9.28e-4
        # every run. The step is compared under them, as `ckpt`'s is.
        torch.use_deterministic_algorithms(train)
        try:
            launches = _image_card_vs_cpu(device, cfg, f"models-check {backbone}", train, worst)
        finally:
            torch.use_deterministic_algorithms(False)
        if train:
            paths.launches["models-check"] = launches
    worst["modules"] = _modules_vs_cpu(device)
    return worst


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import video_knet_tpu_torch  # noqa: F401  (fails outside a checkout)
    from video_knet_tpu_torch.utils.device import card_name_and_power, set_fp32_numerics

    t0 = time.perf_counter()
    set_fp32_numerics()
    device = torch.device("cuda")
    card = card_name_and_power()
    log(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    phase_build()
    kernels = phase_kernels(device)
    held = _launched_shapes()
    paths = Paths()
    serve = phase_serve(device, paths)
    phase_mit(device, paths)
    phase_trained(device, paths)
    for rec in kernels:
        rec["launches"] = serve["launches"][rec["name"]]
        rec["launches_by_path"] = {p: c[rec["name"]] for p, c in paths.launches.items()}
    phase_check(device)
    train = phase_train(device, paths)
    for rec in kernels:
        rec["launches_by_path"]["train"] = paths.launches["train"][rec["name"]]
    hrec = train["record"]
    hrec["launches_by_path"] = {"train": paths.launches["train"]["hungarian"]}
    kernels.append(hrec)
    phase_train_check(device)
    swin_model, swin_cfg = phase_swin_vipseg(device, paths)
    phase_swin_kitti(device, paths)
    phase_swin_check(device)
    train_swin = phase_train_swin(device, paths, swin_model, swin_cfg)
    del swin_model
    for rec in kernels:
        if rec["name"] in KERNELS:
            rec["launches_by_path"].update(
                {p: c[rec["name"]] for p, c in paths.launches.items() if p.startswith("swin")})
        rec["launches_by_path"]["train-swin"] = paths.launches["train-swin"][rec["name"]]
    vis = phase_vis(device, paths)
    vis_volume = phase_vis_volume(device, paths)
    phase_vis_check(device, paths)
    vis_train = phase_vis_train(device, paths)
    hrec["vis"] = vis_train["hungarian"]
    image_pan = phase_image_pan(device, paths)
    image_inst = phase_image_inst_deform(device, paths)
    image_train = phase_image_train(device, paths)
    image_check = phase_image_check(device, paths)
    vis_deform = phase_vis_deform(device, paths)
    phase_trackers(device, paths)
    unitrack = phase_unitrack(device, paths)
    fuse = phase_track_head(device, paths, "video_knet_kitti_step_fuse_track", "fuse-track")
    roi = phase_track_head(device, paths, "video_knet_kitti_step_roi_gt_box", "roi-gt-box")
    track_check = phase_track_check(device, paths)
    import_ref = phase_import_ref(device, paths)
    score = phase_score(device, paths, import_ref.pop("results"), vis.pop("preds"))
    ckpt = phase_ckpt(device, paths)
    with tempfile.TemporaryDirectory() as tmp:
        root, golden_tree = os.path.join(tmp, "kitti_step"), os.path.join(tmp, "trained")
        data = phase_data(device, paths, root)
        eval_hook = phase_eval_hook(device, paths, root, golden_tree)
        cli_step = phase_cli_step(device, paths, root, tmp)
        tta = phase_tta(device, paths, root, tmp, cli_step["ckpt"], cli_step["tiny_ckpt"])
        cli_eval = phase_cli_eval(device, paths, root, tmp, cli_step["ckpt"])
        phase_s = {}
        t1 = time.perf_counter()
        vis_data = phase_vis_data(device, paths, tmp)
        phase_s["vis-data"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        vis_cli = phase_vis_cli(device, paths, tmp)
        phase_s["vis-cli"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        coco_data = phase_coco_data(tmp)
        phase_s["coco-data"] = time.perf_counter() - t1
        new_s = {}
        for tag, run in (("train-cli", lambda: phase_train_cli(device, paths, root, tmp)),
                         ("train-vis-cli", lambda: phase_train_vis_cli(device, paths, tmp)),
                         ("train-image-cli", lambda: phase_train_image_cli(device, paths, tmp)),
                         ("flops", lambda: phase_flops(device, paths, tmp)),
                         ("train-live-bn",
                          lambda: phase_train_live_bn(device, paths, train["median_ms"])),
                         ("train-dp", lambda: phase_train_dp(device, paths, tmp,
                                                             new_s["train-live-bn"])),
                         ("train-cli-dp", lambda: phase_train_cli_dp(device, paths, root, tmp))):
            t1 = time.perf_counter()
            new_s[tag] = run()
            phase_s[tag] = time.perf_counter() - t1
        (train_cli, train_vis_cli, train_image_cli, flops, live_bn, train_dp,
         cli_dp) = new_s.values()
    models = {}
    for tag, run in (("rfp-detectors", lambda: phase_rfp(device, paths, *RFP_PRESETS[0])),
                     ("rfp-swin", lambda: phase_rfp(device, paths, *RFP_PRESETS[1])),
                     ("upernet-align", lambda: phase_upernet_align(device, paths)),
                     ("models-check", lambda: phase_models_check(device, paths))):
        t1 = time.perf_counter()
        models[tag] = run()
        phase_s[tag] = time.perf_counter() - t1
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        model_axis = phase_train_model_axis(device, paths, tmp)
        phase_s["train-model-axis"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        model_axis.update(phase_train_model_axis_swin(device, paths, tmp))
        phase_s["train-model-axis-swin"] = time.perf_counter() - t1
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        phase_profile_train(device, paths)
        phase_s["profile-train"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        phase_kitti_prepare(device, paths, tmp)
        phase_s["kitti-prepare"] = time.perf_counter() - t1
    hrec["vis_data"] = vis_data["hungarian"]
    phase_kernel_shapes(device, kernels, held)
    for rec in kernels:
        rec["launches_by_path"].update(
            {p: c[rec["name"]] for p, c in paths.launches.items()
             if p.startswith(("vis", "image", "trackers", "trained-", "unitrack", "fuse-track",
                              "roi-gt-box", "track-check", "import-ref", "score", "ckpt",
                              "data-train", "eval-hook", "cli-", "tta", "train-cli",
                              "train-vis-cli", "train-image-cli", "train-live-bn",
                              "train-dp", "rfp-", "upernet-align", "models-check",
                              "train-model-axis", "profile-train", "kitti-prepare"))
             and rec["name"] in c})
    log(f"[train] median step {train['median_ms']:.2f} ms, peak memory "
        f"{train['peak_bytes']} bytes, host syncs a step {train['syncs']} ({card})")
    log(f"[train-swin] median step {train_swin['median_ms']:.2f} ms, peak memory "
        f"{train_swin['peak_bytes']} bytes, host syncs a step {train_swin['syncs']} ({card})")
    log(f"[vis] median clip {vis['median_ms']:.2f} ms (1x5x360x640, forward + decode), peak "
        f"memory {vis['peak_bytes']} bytes; [vis-volume] clip {vis_volume['median_ms']:.2f} "
        f"ms ({card})")
    log(f"[vis-train] median step {vis_train['median_ms']:.2f} ms, peak memory "
        f"{vis_train['peak_bytes']} bytes, host syncs a step {vis_train['syncs']} ({card})")
    log(f"[image-pan] median {image_pan['median_ms']:.2f} ms an 800x1344 image (forward + "
        f"panoptic_decode + segments_to_host), peak memory {image_pan['peak_bytes']} bytes; "
        f"[image-inst-deform] median {image_inst['median_ms']:.2f} ms (forward + "
        f"instance_decode), peak memory {image_inst['peak_bytes']} bytes, encoder "
        f"{image_inst['encoder_ms']:.3f} of {image_inst['forward_ms']:.3f} ms forward ({card})")
    log(f"[sampling] {json.dumps(image_inst['sampling'])} ({card})")
    log(f"[image-train] median step {image_train['median_ms']:.2f} ms (B=8, 512x1024), peak "
        f"memory {image_train['peak_bytes']} bytes, host syncs a step {image_train['syncs']} "
        f"({card})")
    log(f"[image-check] worst card-vs-CPU: {json.dumps(image_check)}")
    log(f"[vis-deform] median clip {vis_deform['serve']['median_ms']:.2f} ms, peak memory "
        f"{vis_deform['serve']['peak_bytes']} bytes; median step "
        f"{vis_deform['train']['median_ms']:.2f} ms, peak memory "
        f"{vis_deform['train']['peak_bytes']} bytes, host syncs a step "
        f"{vis_deform['train']['syncs']} ({card})")
    log(f"[unitrack] {json.dumps(unitrack)} ({card})")
    for tag, rec in (("fuse-track", fuse), ("roi-gt-box", roi)):
        log(f"[{tag}] frame ms {json.dumps(rec['frame_ms'])}; state width "
            f"{rec['state_width']}; median step {rec['train']['median_ms']:.2f} ms, peak memory "
            f"{rec['train']['peak_bytes']} bytes, host syncs a step {rec['train']['syncs']} "
            f"({card})")
    log(f"[roi-align] {json.dumps(roi['roi_align'])} ({card})")
    log(f"[track-check] worst card-vs-CPU: {json.dumps(track_check)}")
    log(f"[import-ref] import {import_ref['import_ms']:.1f} ms, median frame "
        f"{import_ref['median_ms']:.2f} ms ({card})")
    log(f"[score] host ms a frame {json.dumps(score['host_ms'])} ({card})")
    log(f"[ckpt] save {ckpt['save_ms']:.1f} ms, restore {ckpt['restore_ms']:.1f} ms, "
        f"{ckpt['bytes']} bytes; the next step's parameters within {ckpt['step_worst']:.2e} "
        f"({ckpt['step_differ']} tensors not bit-equal) ({card})")
    log(f"[data] decode ms {json.dumps(data['decode_ms'])}; loader ms a batch "
        f"{json.dumps({t: r['median_ms'] for t, r in data['loader_ms'].items()})}; "
        f"[data-train] median step {data['median_ms']:.2f} ms ({data['alone_median_ms']:.2f} "
        f"with no loader running), waits on the loader {json.dumps(data['wait_ms'])} ms, peak "
        f"memory {data['peak_bytes']} bytes, host syncs a step {data['syncs']} ({card})")
    log(f"[eval-hook] R-50 {eval_hook['frame_ms']:.2f} ms a frame, host ms a frame "
        f"{json.dumps(eval_hook['host_ms'])}; image K-Net {eval_hook['image_ms']:.2f} ms an "
        f"image ({card})")
    log(f"[cli-step] R-50 {cli_step['mean_ms']:.2f} ms a frame (the CLI's loop "
        f"{cli_step['loop_ms']:.2f}); [tta] {tta['mean_ms']:.2f} ms a frame (loop "
        f"{tta['loop_ms']:.2f}); [cli-eval] ms an item "
        f"{json.dumps({k: r.get('loop_ms', r['mean_ms']) if k == 'dvps' else r['mean_ms'] for k, r in cli_eval.items()})} "
        f"({card})")
    log(f"[vis-data] decode {vis_data['decode_ms']:.2f} ms a 720x1280 frame, clip_gt_arrays "
        f"{vis_data['gt_ms']:.2f} ms a clip; loader ms a batch "
        f"{json.dumps({t: r['median_ms'] for t, r in vis_data['loader_ms'].items()})}; "
        f"[vis-data-train] median step {vis_data['median_ms']:.2f} ms "
        f"({vis_data['alone_median_ms']:.2f} with no loader running), waits on the loader "
        f"{json.dumps(vis_data['wait_ms'])} ms, peak memory {vis_data['peak_bytes']} bytes, host "
        f"syncs a step {vis_data['syncs']} ({card})")
    log(f"[vis-cli] R-50 test_whole_video {vis_cli['clip_ms']:.2f} ms a clip of "
        f"{VIS_CLI_CLIP}, {vis_cli['frame_ms']:.2f} ms a frame; tiny model card vs CPU "
        f"{json.dumps(vis_cli['tiny'])}; [coco-data] load_sem_inst {coco_data['coco_ms']:.2f} ms "
        f"(480x640), {coco_data['cityscapes_ms']:.2f} ms (1024x2048) ({card})")
    log(f"[train-cli] loader-fed median step {train_cli['median_ms']:.2f} ms (R-50, B=1, "
        f"384x1248; --bf16 {train_cli['bf16']['median_ms']:.2f} ms), peak memory "
        f"{train_cli['peak_bytes']} bytes (--bf16 {train_cli['bf16']['peak_bytes']}), host syncs "
        f"a step {train_cli['syncs']}; eval {train_cli['eval_ms']:.2f} ms a frame; "
        f"--freeze-detector {train_cli['freeze']['median_ms']:.2f} ms a B={TRAIN_CLI_B} step "
        f"({card})")
    log(f"[train-vis-cli] loader-fed median step {train_vis_cli['median_ms']:.2f} ms, peak "
        f"memory {train_vis_cli['peak_bytes']} bytes; [train-image-cli] step ms "
        f"{[round(t, 2) for t in train_image_cli['step_ms']]}, peak memory "
        f"{train_image_cli['peak_bytes']} bytes ({card})")
    log(f"[flops] {json.dumps(flops['flops'])}; R-50 frame benchmark "
        f"{json.dumps(flops['bench'])} ({card})")
    log(f"[train-live-bn] median step {live_bn['median_ms']:.2f} ms (B={LIVE_BN_B}; frozen-BN "
        f"`train` {train['median_ms']:.2f} ms at B=1), peak memory {live_bn['peak_bytes']} "
        f"bytes, host syncs a step {live_bn['syncs']}; card vs CPU {json.dumps(live_bn['check'])}"
        f" ({card})")
    log(f"[train-dp] median step ms {json.dumps(train_dp['medians'])} (B=2, each alone on the "
        f"card), gloo ranks {json.dumps(train_dp['gloo_ms'])} (B=1, sharing it); worst vs one "
        f"process: gloo {json.dumps(train_dp['gloo'])} / at 64x96 "
        f"{json.dumps(train_dp['gloo_check'])}, NCCL loss {train_dp['nccl_loss']:.3e} / at "
        f"64x96 {json.dumps(train_dp['nccl_check'])} ({card})")
    log(f"[train-cli-dp] torchrun 2 ranks {cli_dp['dp_s']:.1f} s, one process "
        f"{cli_dp['one_s']:.1f} s (median step {cli_dp['one_ms']:.2f} ms); worst "
        f"{json.dumps(cli_dp['diffs'])}; steps {json.dumps(cli_dp['steps'])} ({card})")
    for tag in ("rfp-detectors", "rfp-swin"):
        rec = models[tag]
        log(f"[{tag}] {rec['params']} parameters; median {rec['serve']['median_ms']:.2f} ms a "
            f"384x1248 image (forward + panoptic_decode + segments_to_host), peak memory "
            f"{rec['serve']['peak_bytes']} bytes; median step {rec['train']['median_ms']:.2f} ms "
            f"(B={RFP_TRAIN_B}), peak memory {rec['train']['peak_bytes']} bytes, host syncs a "
            f"step {rec['train']['syncs']} ({card})")
    align = models["upernet-align"]
    log(f"[upernet-align] median frame {align['serve']['median_ms']:.2f} ms (device tracker, "
        f"384x1248), peak memory {align['serve']['peak_bytes']} bytes; median step "
        f"{align['train']['median_ms']:.2f} ms, peak memory {align['train']['peak_bytes']} bytes, "
        f"host syncs a step {align['train']['syncs']} ({card})")
    log(f"[dcn] {json.dumps(align['dcn'])} ({card})")
    log(f"[models-check] worst card-vs-CPU: {json.dumps(models['models-check'])}")
    for tag in ("vps", "vis", "vps-live", "vis-live", "vis-volume", "vps-376", "swin-b",
                "swin-b-720", "mit-b0", "mit-b0-376"):
        rec = model_axis[tag]
        path = ("train-model-axis-swin" if tag.startswith(("swin-b", "mit-b0"))
                else "train-model-axis")
        log(f"[{path}] {tag}: 1x{MODEL_AXIS_N} mesh of gloo ranks sharing the card, "
            f"step ms {json.dumps(rec['rank_ms'])} (one process {json.dumps(rec['one_ms'])}); "
            f"peak memory a rank {rec['rank_peak']} bytes against {rec['one_peak']} in one "
            f"process ({json.dumps(rec['peak_share'])} of it); bytes each rank hands to the collectives a step "
            f"{json.dumps(rec['comm'])}; worst vs one process {json.dumps(rec['worst'])}; hard "
            f"decisions the split takes apart a step {rec['apart']} ({card})")
    log(f"[phase-seconds] {json.dumps(phase_s)}: the VIS data, train CLI, data-parallel, "
        f"last model modules', model-axis, profile-train and kitti-prepare phases, "
        f"{sum(phase_s.values()):.1f} s together ({card})")
    medians = {p: statistics.median(ms[1:]) if len(ms) > 1 else ms[0]
               for p, ms in paths.frame_ms.items()}
    log(f"[paths] median ms a frame (a round for streams) {json.dumps(medians)}; "
        f"whole run {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
