"""The trained-weights serving golden through the port, on the CPU.

`video_knet_tpu_torch/tools/trained_golden.py` is the port's own copy of
`tests/trained_golden_common.py` (no JAX, no PIL). With the committed fp16
checkpoint reloaded as fp32, the port reproduces
`tests/golden/serving_trained_tiny_64x96.npz` on both tracker paths: id
maps, semantic maps, track maps and segments_info bit-equal, segment scores
within 1e-4 (the schema and tolerance of `tests/test_serving_golden.py`).
Also: the copy's frames and config equal the reference's, the tiny config
loads strictly (its head reads the neck's 256 channels, not
`rpn.in_channels`), and the test step's floats agree with JAX's.
"""

import dataclasses
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import trained_golden_common as jtg
from torch_port_common import assert_rel_close, t

from video_knet_tpu.models.video.knet_vps import VideoKNet as JVideoKNet
from video_knet_tpu_torch.tools import trained_golden as tg
from video_knet_tpu_torch.utils.convert import load_flax_variables


@pytest.fixture(scope="module")
def tiny():
    return dict(model=tg.tiny_model("cpu"), frames=tg.eval_frames())


def test_sequence_equals_reference_frames():
    with tempfile.TemporaryDirectory() as d:
        jtg.write_sequence(Path(d))
        want = [np.asarray(f) for f in jtg.eval_frames(Path(d))]
    got = tg.eval_frames()
    assert len(got) == len(want) == tg.N_FRAMES
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b, err_msg=f"frame {i}")


def test_tiny_config_copy_matches_reference():
    assert dataclasses.asdict(tg.tiny_cfg()) == dataclasses.asdict(jtg.tiny_cfg())
    assert (tg.HW, tg.N_FRAMES, tg.B_FRAMES, tg.C_FRAMES) == (
        jtg.HW, jtg.N_FRAMES, jtg.B_FRAMES, jtg.C_FRAMES)


def test_tiny_config_loads_strictly(tiny):
    """rpn.in_channels is 64 but the neck gives 256: the localization FPN
    takes 256, and every checkpoint leaf lands on one port key."""
    cfg = tg.tiny_cfg()
    assert cfg.rpn.in_channels == 64
    model = tiny["model"]
    assert model.rpn_head.localization_fpn.l1_conv0.Conv_0.weight.shape[1] == 256
    assert tuple(model.neck.lateral0.weight.shape[:2]) == (256, 32)
    weights = tg.load_weights()
    assert all(v.dtype == np.float32 for v in weights.values())
    weights.pop(next(iter(weights)))
    with pytest.raises(KeyError):
        load_flax_variables(model, weights)
    load_flax_variables(model, tg.load_weights())  # leave the fixture intact


@pytest.mark.parametrize("tracker_type", ["quasi_dense", "quasi_dense_host"])
def test_port_reproduces_trained_golden(tiny, tracker_type):
    arrs = tg.flatten_results(tg.run_pipeline(tiny["model"], tiny["frames"], tracker_type,
                                              device="cpu"))
    gold = np.load(tg.GOLDEN)
    assert set(gold.files) == set(arrs)
    for k in gold.files:
        if k.startswith("seg_score_"):
            np.testing.assert_allclose(arrs[k], gold[k], atol=1e-4, err_msg=k)
        else:
            np.testing.assert_array_equal(arrs[k], gold[k], err_msg=k)


def test_port_golden_run_exercises_release_paths(tiny):
    """The port's own outputs carry the scripted lifecycle: a long-lived
    track, one that ends early (memo expiry), a mid-sequence spawn."""
    arrs = tg.flatten_results(tg.run_pipeline(tiny["model"], tiny["frames"], device="cpu"))
    spans = tg.track_id_spans(arrs)
    assert len(spans) >= 3, spans
    assert any(n >= 8 and f0 <= 1 for f0, _, n in spans.values()), spans
    assert any(f1 <= tg.B_FRAMES[1] + 2 for _, f1, _ in spans.values()), spans
    assert any(f0 >= tg.C_FRAMES[0] - 1 for f0, _, _ in spans.values()), spans


def test_trained_test_step_matches_jax(tiny):
    jcfg = jtg.tiny_cfg()
    jm = JVideoKNet(jcfg, train=False)
    img = tiny["frames"][9]
    prev = np.random.RandomState(3).randn(1, 37, 1, 64).astype(np.float32)
    step = jax.jit(lambda v, i, p: jm.apply(v, i, p, False, method=JVideoKNet.test_step))
    want = step(jtg.load_weights(), jnp.asarray(img), jnp.asarray(prev))
    with torch.no_grad():
        got = tiny["model"].test_step(t(img), t(prev), False)
    for key in ("track_obj_feats", "track_embeds", "new_obj_feats"):
        assert_rel_close(got[key], want[key], 1e-4, key)
    for i, (a, b) in enumerate(zip(got["stage_outs"], want["stage_outs"])):
        assert_rel_close(a.cls_score, b.cls_score, 1e-4, f"stage {i} cls")
        assert_rel_close(a.scaled_mask_preds, b.scaled_mask_preds, 1e-4, f"stage {i} masks")
    assert_rel_close(got["rpn_out"].seg_preds, want["rpn_out"].seg_preds, 1e-4, "seg_preds")
