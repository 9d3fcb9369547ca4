"""The port's Hungarian solve and matching costs against the JAX package's.

`hungarian_plain` (the numpy copy: the CPU route of the solve and the plain
version the CUDA kernel is held against on the card) must give JAX's
`hungarian` and `pad_and_solve` answers bit for bit on ~200 seeded
problems, most of them full of ties: integer-valued costs, and all-zero
invalid rows as `pad_and_solve` makes them. The cost functions agree within
1e-5 of the output's scale (fp32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import assert_rel_close, n, t

import video_knet_tpu.ops.hungarian as J
from video_knet_tpu_torch.ops import hungarian as T
from video_knet_tpu_torch.ops.kernels.hungarian import hungarian_plain, tie_heavy_problems


PROBLEMS = tie_heavy_problems()


@pytest.mark.parametrize("i", range(len(PROBLEMS)))
def test_numpy_solve_is_jax_solve_bit_for_bit(i):
    costs, _ = PROBLEMS[i]
    want = np.asarray(jax.jit(jax.vmap(J.hungarian))(jnp.asarray(costs)))
    got = hungarian_plain(costs)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    # every row matched, to distinct columns
    assert all(len(set(row)) == costs.shape[1] and min(row) >= 0 for row in got)


@pytest.mark.parametrize("i", range(len(PROBLEMS)))
def test_pad_and_solve_matches_jax(i):
    tcost, valid = PROBLEMS[i]
    cost = np.ascontiguousarray(tcost.transpose(0, 2, 1))  # [P, N, M] as the callers hold it
    wg2p, wp2g = jax.jit(jax.vmap(J.pad_and_solve))(jnp.asarray(cost), jnp.asarray(valid))
    g2p, p2g = T.pad_and_solve(t(cost), t(valid))
    np.testing.assert_array_equal(n(p2g), np.asarray(wp2g))
    np.testing.assert_array_equal(n(g2p), np.asarray(wg2p))


def test_problem_count_and_ties():
    assert sum(len(c) for c, _ in PROBLEMS) == 200
    tied = sum(int(np.any(np.diff(np.sort(c.reshape(len(c), -1)), axis=1) == 0, axis=1).sum())
               for c, _ in PROBLEMS)
    assert tied >= 150


def test_cost_functions_match_jax():
    rng = np.random.RandomState(3)
    b, nn, m, h, w, c = 2, 10, 4, 12, 16, 3
    logits = (rng.randn(b, nn, h, w) * 2).astype(np.float32)
    gtm = (rng.rand(b, m, h, w) > 0.6).astype(np.float32)
    cls = rng.randn(b, nn, c).astype(np.float32)
    labels = np.array([[0, 2, 1, -1], [1, 1, 0, 2]], np.int32)
    for i in range(b):
        args = (jnp.asarray(logits[i]), jnp.asarray(gtm[i]))
        assert_rel_close(T.dice_cost(t(logits[i]), t(gtm[i])), J.dice_cost(*args), 1e-5, "dice")
        assert_rel_close(T.mask_cost(t(logits[i]), t(gtm[i])), J.mask_cost(*args), 1e-5, "mask")
        assert_rel_close(T.focal_cls_cost(t(cls[i]), t(labels[i])),
                         J.focal_cls_cost(jnp.asarray(cls[i]), jnp.asarray(labels[i])),
                         1e-5, "focal")
    # batched, as the loss block calls them, against the vmapped reference
    want = jax.vmap(lambda a, g, k, l: J.hungarian_cost_matrix(a, g, k, l))(
        logits, gtm, cls, labels)
    assert_rel_close(T.hungarian_cost_matrix(t(logits), t(gtm), t(cls), t(labels)), want,
                     1e-5, "cost matrix")
    valid = np.array([True, True, False, True])
    for i in range(b):
        got = T.assign(t(logits[i]), t(gtm[i]), t(valid), t(cls[i]), t(labels[i]))
        want = J.assign(jnp.asarray(logits[i]), jnp.asarray(gtm[i]), jnp.asarray(valid),
                        jnp.asarray(cls[i]), jnp.asarray(labels[i]))
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(n(g), np.asarray(w_))


def test_solve_rejects_more_rows_than_columns():
    with pytest.raises(ValueError):
        T.pad_and_solve(torch.zeros((1, 3, 5)), torch.ones((1, 5), dtype=torch.bool))
    with pytest.raises(ValueError):
        hungarian_plain(np.zeros((5, 3), np.float32))
