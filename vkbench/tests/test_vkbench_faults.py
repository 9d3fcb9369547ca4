"""The output check catches a broken timed path: each run skips the look
for a card, drives a whole run at a tiny size on the CPU with one fault
planted in the program underneath, and must come out not correct. The
control (the reference in TF32 in the program's place) is held on the card
at a small size."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from conftest import tiny_run


def _state_unchanged_serving(monkeypatch):
    from video_knet_tpu_torch.models.video.inference import MultiStreamVPSPipeline

    step = MultiStreamVPSPipeline._step

    def frozen(self, imgs, flags):
        prev, track = self.prev_obj, getattr(self, "track_state", None)
        out = step(self, imgs, flags)
        self.prev_obj, self.track_state = prev, track  # the carried state never moves
        return out

    monkeypatch.setattr(MultiStreamVPSPipeline, "_step", frozen)


def _answer_altered_serving(monkeypatch):
    from video_knet_tpu_torch.models import knet

    merge = knet.merge_joint

    def mirrored(*args, **kwargs):
        res = merge(*args, **kwargs)  # the id map mirrored where the merge makes it
        return res._replace(panoptic_seg=torch.flip(res.panoptic_seg, dims=[-1]))

    monkeypatch.setattr(knet, "merge_joint", mirrored)


def _labels_rolled_where_decoded(monkeypatch):
    from video_knet_tpu_torch.models import knet

    merge = knet.merge_joint

    def rolled(*args, **kwargs):
        res = merge(*args, **kwargs)  # each class index moved to the next of its kind
        nt, lab = kwargs["num_thing_classes"], res.labels
        ns = int((lab >= nt).sum())
        return res._replace(labels=torch.where(lab < nt, (lab + 1) % nt,
                                               nt + (lab - nt + 1) % ns).to(lab.dtype))

    monkeypatch.setattr(knet, "merge_joint", rolled)


def _dataset_label_table_rolled(monkeypatch):
    from video_knet_tpu_torch.models.video import device_tracker

    table = device_tracker.dataset_class_table
    monkeypatch.setattr(device_tracker, "dataset_class_table",
                        lambda *a, **k: np.roll(np.asarray(table(*a, **k)), 1))


def _state_unchanged_training(monkeypatch):
    from video_knet_tpu_torch.train.optim import Optimizer

    monkeypatch.setattr(Optimizer, "step", lambda self: self.scheduler.step())


def _window_step_skips_its_update(monkeypatch):
    from video_knet_tpu_torch.train.optim import Optimizer

    step, calls = Optimizer.step, []

    def after_warm_up(self):  # the set-up's steps update; the window's do not
        calls.append(1)
        return step(self) if len(calls) <= 3 else self.scheduler.step()

    monkeypatch.setattr(Optimizer, "step", after_warm_up)


def _ref_half_left_out(monkeypatch):
    from video_knet_tpu_torch.models.video import knet_vps

    loss = knet_vps.video_knet_loss

    def key_only(*args, **kwargs):
        return {k: v for k, v in loss(*args, **kwargs).items()
                if not k.endswith(("_ref", "_ref_rpn"))}

    monkeypatch.setattr("video_knet_tpu_torch.train.vps.video_knet_loss", key_only)


def _loss_altered(monkeypatch):
    from video_knet_tpu_torch.models.video import knet_vps

    loss = knet_vps.video_knet_loss

    def no_track(*args, **kwargs):
        return {k: v for k, v in loss(*args, **kwargs).items() if k != "loss_track"}

    monkeypatch.setattr("video_knet_tpu_torch.train.vps.video_knet_loss", no_track)


def _fails(name, plant, monkeypatch):
    plant(monkeypatch)
    result, _, numbers = tiny_run(name)
    assert result["correct"] is False, numbers
    return numbers["program"]


def test_serving_state_left_unchanged_is_caught(monkeypatch):
    _fails("r50_kitti.serve8", _state_unchanged_serving, monkeypatch)


def test_serving_id_map_altered_where_made_is_caught(monkeypatch):
    n = _fails("r50_kitti.serve8", _answer_altered_serving, monkeypatch)
    assert n["pan_px"] > 0


@pytest.mark.parametrize("plant", [_labels_rolled_where_decoded, _dataset_label_table_rolled])
def test_serving_labels_altered_are_caught(monkeypatch, plant):
    n = _fails("r50_kitti.serve8", plant, monkeypatch)
    assert n["sem_px"] > 0.001


def test_a_train_step_that_leaves_the_state_unchanged_is_caught(monkeypatch):
    n = _fails("swinb_vipseg.train", _state_unchanged_training, monkeypatch)
    assert n["step_gap"] > 0.99


def test_a_window_step_that_skips_its_update_is_caught(monkeypatch):
    n = _fails("swinb_vipseg.train", _window_step_skips_its_update, monkeypatch)
    assert n["step_gap"] < 0.05 and n["window_step_gap"] > 0.99


def test_a_train_step_that_leaves_out_the_ref_half_is_caught(monkeypatch):
    _fails("swinb_vipseg.train", _ref_half_left_out, monkeypatch)


def test_a_train_step_whose_loss_is_altered_is_caught(monkeypatch):
    _fails("swinb_vipseg.train", _loss_altered, monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("name, hw", [("r50_kitti.serve8", (192, 624)),
                                      ("swinb_vipseg.train", (368, 640))])
def test_the_control_fails_on_the_card(cuda_device, name, hw):
    """The reference in TF32 in the program's place, at half the cell's
    frame size, fails at least one of the cell's limits; the program on
    the same seed passes them."""
    result, _, numbers = tiny_run(name, device=cuda_device, modes=("program", "control"),
                                  seconds=5.0, hw=hw)
    assert result["correct"] is True, numbers
    limits = {k: c["limit"] for k, c in result["check"].items()}
    assert any(numbers["control"][k] > lim for k, lim in limits.items()), numbers
