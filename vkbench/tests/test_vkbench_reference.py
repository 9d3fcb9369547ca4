"""The frozen reference against the program's plain CPU path at 64x96,
part by part, on the benchmark's own seeded weights and inputs."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from conftest import tiny_cell

from vkbench import common
from vkbench.reference import model as ref
from vkbench.reference.serve import decode, serve_round
from vkbench.traffic.serve_streams import make_ring, reference_cfg
from vkbench.traffic.train_steps import make_batches, port_batch, step_generator


def _port(name):
    from video_knet_tpu_torch.models.video.knet_vps import VideoKNet

    torch.set_num_threads(4)
    cell = tiny_cell(name)
    cfg = common.port_config(cell["config"])
    net = VideoKNet(cfg, device="cpu")
    template = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    sd = common.make_weights(template, cell["config"]["weight_seed"], "cpu")
    net.load_state_dict(sd)
    return cell, cfg, net, sd


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


@pytest.fixture(scope="module")
def r50():
    return _port("r50_kitti.serve8")


@pytest.mark.parametrize("ring_seed", [0, 1, 2, 3])
def test_serving_forward_matches_the_program(r50, ring_seed):
    """Equal to rounding on inputs where no K1 binarisation lies within
    rounding of its threshold: where one does (ring seed 5 here), the two
    sides pool one pixel differently and the kernels part by ~5e-3, the
    hazard the chip check's limits take in."""
    cell, cfg, net, sd = r50
    img = torch.from_numpy(make_ring(ring_seed, 2, 2, (64, 96), [2, 3], 0.5)[1])
    prev = torch.randn(2, 117, 1, 256, generator=torch.Generator().manual_seed(1))
    first = torch.tensor([True, False])
    with torch.no_grad():
        got = net.test_step(img, prev, first)
        want = ref.test_step(img, prev, first, reference_cfg(cell["config"]), sd)
    assert _rel(got["new_obj_feats"], want["new_kernels"]) < 1e-5
    assert _rel(got["track_embeds"], want["embeds"]) < 1e-5
    last, ref_last = got["stage_outs"][-1], want["outs"][-1]
    assert _rel(last.cls_score, ref_last["cls"]) < 1e-5
    assert _rel(last.scaled_mask_preds, ref_last["scaled"]) < 1e-5
    assert _rel(got["rpn_out"].seg_preds, want["head"]["seg"]) < 1e-5


def test_decode_matches_the_program(r50):
    from video_knet_tpu_torch.models.video.knet_vps import vps_decode

    cell, cfg, net, sd = r50
    img = torch.from_numpy(make_ring(6, 1, 1, (64, 96), [2, 3], 0.5)[0])
    with torch.no_grad():
        out = net.test_step(img, torch.zeros(1, 117, 1, 256), torch.tensor([True]))
        pred = vps_decode(out["rpn_out"], out["stage_outs"], out["track_obj_feats"], cfg, None,
                          batched=True)
        last = out["stage_outs"][-1]
        res = decode(last.cls_score[0], last.scaled_mask_preds[0], out["rpn_out"].seg_preds[0],
                     reference_cfg(cell["config"]))
    assert torch.equal(pred.result.panoptic_seg[0].long(), res["pan"])
    assert torch.equal(pred.result.keep[0], res["keep"])
    assert torch.equal(pred.thing_mask_idx[0].long(), res["src"])


def test_a_served_round_matches_the_pipeline(r50):
    from video_knet_tpu_torch.models.video.inference import MultiStreamVPSPipeline

    from vkbench.reference.serve import empty_tracker

    cell, cfg, net, sd = r50
    ring = make_ring(7, 3, 2, (64, 96), [2, 3], 0.5)
    pipe = MultiStreamVPSPipeline(net, cfg, (64, 96), 2, thing_ids_in_orig=(11, 13), device="cpu")
    rc = reference_cfg(cell["config"])
    trackers = [empty_tracker(128, 100, 256)] * 2
    prev = torch.zeros(2, 117, 1, 256)
    for r, imgs in enumerate(ring):
        got = pipe.run_frames(imgs, [r == 0] * 2)
        first = torch.full((2,), r == 0)
        frames, prev, trackers = serve_round(torch.from_numpy(imgs), prev, trackers, first, rc, sd,
                                             (64, 96))
        for g, w in zip(got, frames):
            assert np.array_equal(g.panoptic_seg, w["pan"])
            assert np.array_equal(g.semantic_map, w["sem"])
            assert np.array_equal(g.track_map, w["track"])
        assert _rel(pipe.prev_obj, prev) < 1e-5
    pipe.close()


def test_the_train_step_matches_the_program():
    from video_knet_tpu_torch.train.optim import make_optimizer
    from video_knet_tpu_torch.train.train_state import create_train_state
    from video_knet_tpu_torch.train.vps import train_step

    from vkbench.reference.train import train_steps
    from vkbench.traffic.train_steps import compare

    cell, cfg, net, sd = _port("swinb_vipseg.train")
    conf = cell["config"]
    o = conf["model"]["optim"]
    opt = make_optimizer(net, o["steps_per_epoch"], base_lr=o["base_lr"],
                         weight_decay=o["weight_decay"], backbone_lr_mult=o["backbone_lr_mult"],
                         grad_clip=o["grad_clip"], warmup_iters=o["warmup_iters"])
    state = create_train_state(net, opt)
    batches = make_batches(11, cell["traffic"], conf, "cpu")[:2]
    names = {p: n for n, p in net.named_parameters()}
    losses = []
    for i, b in enumerate(batches):
        state, out = train_step(state, port_batch(b), step_generator(11, i, "cpu"))
        losses.append(float(out["total_loss"]))
        if i == 0:
            grad = {names[p]: s["exp_avg"].clone() / (1 - o["beta1"])
                    for p, s in opt.adamw.state.items()}
    after = {n: p.detach() for n, p in net.named_parameters()}
    gens = [step_generator(11, i, "cpu") for i in range(2)]
    ref_losses, ref_grad, ref_after, _ = train_steps(sd, conf["model"], batches, gens)
    gaps = compare(ref_losses, ref_grad, ref_after, sd, losses, grad, after)
    assert gaps["loss_rel"] < 1e-5 and gaps["grad_gap"] < 1e-3 and gaps["step_gap"] < 1e-3
