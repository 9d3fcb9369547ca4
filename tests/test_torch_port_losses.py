"""The port's losses (`ops/losses.py`) and target builders (`ops/targets.py`)
against the JAX package's, on seeded numpy inputs.

Tolerances: loss values 1e-5 relative, and their gradients (torch autograd
against `jax.grad`, with respect to the first argument) within 1e-5 of the
gradient's largest magnitude: fp32 sums in another order. Targets are
integer maps and 0/1 weights: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import assert_rel_close, t

from video_knet_tpu.ops import losses as JL
from video_knet_tpu.ops import targets as JT
from video_knet_tpu_torch.ops import losses as TL
from video_knet_tpu_torch.ops import targets as TT


def _targets3(rng, shape, p_pos=0.3, p_neg=0.5):
    u = rng.rand(*shape)
    return np.where(u < p_pos, 1, np.where(u < p_pos + p_neg, 0, -1)).astype(np.int32)


def _cases():
    """name -> (jax fn, port fn, first argument, other arguments) on seed 0."""
    rng = np.random.RandomState(0)
    f32 = np.float32
    p, h, w, c = 6, 9, 11, 19
    logits = (rng.randn(p, h, w) * 2).astype(f32)
    tgt = (rng.rand(p, h, w) > 0.6).astype(f32)
    wt = np.array([1, 0, 1, 1, 0, 1], f32)
    cls = rng.randn(p, c).astype(f32)
    labels = np.array([0, 1, 19, 5, 19, 18], np.int32)  # 19 = background
    lw2 = (rng.rand(p, c) > 0.3).astype(f32)
    seg = rng.randn(2, h, w, c).astype(f32)
    seg_t = rng.randint(0, c + 1, size=(2, h, w)).astype(np.int32)  # c = ignore
    sim = (rng.randn(7, 5) * 3).astype(f32)
    cos = np.clip(rng.randn(7, 5) * 0.5, -1, 1).astype(f32)
    tg = _targets3(rng, (7, 5))
    tg[3] = -1  # a row with no pair
    tg_many_neg = np.where(rng.rand(7, 5) < 0.1, 1, 0).astype(np.int32)
    tg_many_neg[0, 0] = 1
    rank_t = np.where(rng.rand(h, w) < 0.2, 255, rng.randint(0, p, (h, w))).astype(np.int32)
    return {
        "dice": (lambda x: JL.dice_loss(x, tgt, wt, loss_weight=4.0),
                 lambda x: TL.dice_loss(x, t(tgt), t(wt), loss_weight=4.0), logits),
        "dice_avg": (lambda x: JL.dice_loss(x, tgt, None, avg_factor=3.0),
                     lambda x: TL.dice_loss(x, t(tgt), None, avg_factor=3.0), logits),
        "focal_2d_weights": (
            lambda x: JL.sigmoid_focal_loss(x, labels, lw2, num_classes=c, loss_weight=2.0),
            lambda x: TL.sigmoid_focal_loss(x, t(labels), t(lw2), num_classes=c,
                                            loss_weight=2.0), cls),
        "focal_1d_avg": (
            lambda x: JL.sigmoid_focal_loss(x, labels, wt, num_classes=c, avg_factor=5.0),
            lambda x: TL.sigmoid_focal_loss(x, t(labels), t(wt), num_classes=c,
                                            avg_factor=5.0), cls),
        "focal_plain": (lambda x: JL.sigmoid_focal_loss(x, labels, num_classes=c),
                        lambda x: TL.sigmoid_focal_loss(x, t(labels), num_classes=c), cls),
        "bce": (lambda x: JL.binary_cross_entropy(x, tgt, wt),
                lambda x: TL.binary_cross_entropy(x, t(tgt), t(wt)), logits),
        "bce_plain": (lambda x: JL.binary_cross_entropy(x, tgt),
                      lambda x: TL.binary_cross_entropy(x, t(tgt)), logits),
        "softmax_ce": (lambda x: JL.softmax_cross_entropy(x, seg_t, ignore_index=c),
                       lambda x: TL.softmax_cross_entropy(x, t(seg_t), ignore_index=c), seg),
        "multi_pos": (lambda x: JL.multi_pos_cross_entropy(x, tg, (tg == 1).any(1) * 1.0),
                      lambda x: TL.multi_pos_cross_entropy(
                          x, t(tg), t(((tg == 1).any(1) * 1.0).astype(f32))), sim),
        "multi_pos_avg": (
            lambda x: JL.multi_pos_cross_entropy(x, tg, loss_weight=0.25, avg_factor=2.0),
            lambda x: TL.multi_pos_cross_entropy(x, t(tg), loss_weight=0.25, avg_factor=2.0),
            sim),
        "l2_aux": (lambda x: JL.l2_track_aux_loss(x, tg),
                   lambda x: TL.l2_track_aux_loss(x, t(tg)), cos),
        "l2_aux_capped": (lambda x: JL.l2_track_aux_loss(x, tg_many_neg, pos_margin=0.05),
                          lambda x: TL.l2_track_aux_loss(x, t(tg_many_neg), pos_margin=0.05),
                          cos),
        "rank_ce": (lambda x: JL.rank_cross_entropy(x, rank_t),
                    lambda x: TL.rank_cross_entropy(x, t(rank_t)), logits),
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_value_and_gradient_match_jax(name):
    jfn, tfn, x = CASES[name]
    want, want_g = jax.value_and_grad(lambda a: jfn(a))(jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    got = tfn(xt)
    got.backward()
    assert got.shape == ()
    assert abs(float(got.detach()) - float(want)) <= 1e-5 * max(abs(float(want)), 1e-6), (
        float(got.detach()), float(want))
    assert np.any(np.asarray(want_g)), "the case reaches no gradient"
    assert_rel_close(xt.grad, want_g, 1e-5, f"{name} gradient")


def test_l2_aux_hard_mining_keeps_the_hardest_negatives():
    """The capped case really caps: fewer negatives weigh in than exist."""
    _, _, cos = CASES["l2_aux_capped"]
    tg = np.zeros((7, 5), np.int32)
    tg[0, 0] = 1
    capped = float(TL.l2_track_aux_loss(t(cos), t(tg)))
    uncapped = float(TL.l2_track_aux_loss(t(cos), t(tg), neg_pos_ub=0))
    assert capped != uncapped
    assert abs(capped - float(JL.l2_track_aux_loss(cos, tg))) <= 1e-6


def _gt(rng, b=2, g=5, s=3, h=8, w=10):
    masks = (rng.rand(b, g, h, w) > 0.7).astype(np.float32)
    valid = rng.rand(b, g) > 0.3
    return [masks, rng.randint(0, 2, (b, g)).astype(np.int32), valid,
            np.where(valid, np.arange(g)[None], -1).astype(np.int32),
            (rng.rand(b, s, h, w) > 0.5).astype(np.float32), rng.rand(b, s) > 0.4]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_target_builders_match_jax(seed):
    rng = np.random.RandomState(seed)
    leaves = _gt(rng)
    jgt, tgt = JT.PanopticGT(*map(jnp.asarray, leaves)), TT.PanopticGT(*map(t, leaves))
    b, g = leaves[1].shape
    n, nt, s = 9, 2, 3
    g2p = np.full((b, n), -1, np.int32)
    for i in range(b):
        g2p[i, rng.permutation(n)[:g]] = np.arange(g)
    g2p[0, rng.permutation(n)[:2]] = -1
    kw = dict(num_thing_classes=nt, num_stuff_classes=s)

    def same(got, want):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    same(TT.pred_of_gt_from(t(g2p), g), JT.pred_of_gt_from(jnp.asarray(g2p), g))
    for got, want in zip(TT.build_stage_label_targets(t(g2p), tgt, **kw),
                         JT.build_stage_label_targets(jnp.asarray(g2p), jgt, **kw)):
        same(got, want)
    kw2 = dict(num_thing_classes=nt, num_classes=nt + s)
    same(TT.build_semantic_map(tgt, **kw2), JT.build_semantic_map(jgt, **kw2))
    rows_w = (rng.rand(b, g) > 0.3).astype(np.float32)
    orig = np.stack([rng.permutation(n)[:g] for _ in range(b)]).astype(np.int32)
    same(TT.build_rank_target_gathered(t(leaves[0]), t(rows_w), t(orig)),
         JT.build_rank_target_gathered(jnp.asarray(leaves[0]), rows_w, orig))
