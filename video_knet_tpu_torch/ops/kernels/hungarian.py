"""The Hungarian solve of the train step: CUDA kernel, plain (numpy) version,
launch counter.

`solve` replaces the solver `video_knet_tpu/ops/hungarian.py:hungarian`
(`lax.while_loop`s on the device; it has no Pallas kernel): the
Jonker-Volgenant shortest augmenting path on [L, r, c] costs, r <= c, every
row matched. For tensors on the CPU it runs `hungarian_plain`, a numpy copy
of the reference's steps; for CUDA tensors it launches `csrc/hungarian.cu`
(one warp per problem, all L problems in one launch) or raises. Both follow
the reference step for step in fp32 (`(cost - u[i0]) - v`, the u update over
used columns, `v -= delta` over all c + 1 entries, `minv -= delta` over the
unused ones, argmin ties to the lower index), so all three give the same
assignment, ties included.
"""

from __future__ import annotations

import numpy as np
import torch

LAUNCHES = {"hungarian": 0}
BYTES = {"hungarian": 0}  # a launch's costs read once and assignments written once
INF = np.float32(1e9)  # the reference's _INF: minv's start and a used column's key


def reset_launch_counts() -> None:
    LAUNCHES["hungarian"] = 0
    BYTES["hungarian"] = 0


def _solve_one(cost: np.ndarray, rounds: list) -> np.ndarray:
    r, c = cost.shape
    u = np.zeros(r, np.float32)  # row potentials
    v = np.zeros(c + 1, np.float32)  # column potentials (column c is virtual)
    p = np.full(c + 1, -1, np.int32)  # p[j] = row matched to column j
    for i in range(r):
        p[c] = i
        minv = np.full(c, INF, np.float32)
        way = np.full(c, c, np.int32)
        used = np.zeros(c + 1, bool)
        j0 = c
        for _ in range(c + 1):  # each round uses a new column
            if p[j0] == -1:
                break
            used[j0] = True
            i0 = p[j0]
            cur = (cost[i0] - u[i0]) - v[:c]
            upd = ~used[:c] & (cur < minv)
            minv = np.where(upd, cur, minv)
            way = np.where(upd, j0, way)
            masked = np.where(used[:c], INF, minv)
            j1 = int(np.argmin(masked))  # the first minimum, as jnp.argmin
            delta = masked[j1]
            u[p[used]] += delta  # distinct rows: one per used column
            v[used] -= delta
            minv[~used[:c]] -= delta
            j0 = j1
            rounds[0] += 1
        for _ in range(c + 1):  # augment back to the virtual column
            if j0 == c:
                break
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    col_of_row = np.full(r, -1, np.int32)
    cols = np.nonzero(p[:c] >= 0)[0]
    col_of_row[p[cols]] = cols
    return col_of_row


def hungarian_plain(cost: np.ndarray, rounds: list | None = None) -> np.ndarray:
    """[..., r, c] float32 costs, r <= c -> [..., r] int32 column of each row.
    `rounds`, a one-element list, gains the number of Dijkstra rounds run
    (the data-dependent work)."""
    cost = np.asarray(cost, np.float32)
    r, c = cost.shape[-2:]
    if r > c:
        raise ValueError(f"hungarian expects rows <= cols, got {r} x {c}")
    rounds = [0] if rounds is None else rounds
    flat = cost.reshape(-1, r, c)
    out = (np.stack([_solve_one(x, rounds) for x in flat]) if len(flat)
           else np.zeros((0, r), np.int32))
    return out.reshape(*cost.shape[:-2], r)


def tie_heavy_problems(seed: int = 0, shapes=((96, 32, 100), (64, 4, 100), (40, 7, 13))):
    """Seeded check problems [(costs [P, r, c] float32, valid [P, r] bool)]:
    a quarter each random, integer-valued, 0/1 and quarter-step costs (ties
    everywhere), invalid rows all zero as `pad_and_solve` makes them. The
    default shapes: the train step's transposed problem (32 GT slots x 100
    proposals), a small one, a near-square one; 200 problems."""
    rng = np.random.RandomState(seed)
    out = []
    for p, r, c in shapes:
        kind = np.arange(p) % 4
        x = rng.randn(p, r, c).astype(np.float32)
        x[kind == 1] = rng.randint(-3, 4, size=(int((kind == 1).sum()), r, c))
        x[kind == 2] = rng.randint(0, 2, size=(int((kind == 2).sum()), r, c))
        x[kind == 3] = np.round(x[kind == 3] * 4) / 4
        valid = rng.rand(p, r) < 0.6
        valid[:, 0] = True
        valid[kind == 0] = True
        out.append((np.where(valid[:, :, None], x, 0.0).astype(np.float32), valid))
    return out


def solve(cost: torch.Tensor) -> torch.Tensor:
    """[L, r, c] float32 costs (r <= c) -> [L, r] int32: the optimal column
    of each row."""
    if cost.device.type == "cpu":
        return torch.from_numpy(hungarian_plain(cost.detach().numpy()))
    if cost.device.type != "cuda":
        raise ValueError(f"unsupported device {cost.device}")
    if cost.dtype != torch.float32 or cost.dim() != 3 or not cost.is_contiguous():
        raise ValueError(f"contiguous [L, r, c] float32 costs required, got "
                         f"{cost.dtype} {tuple(cost.shape)}")
    lanes, r, c = cost.shape
    if r > c:
        raise ValueError(f"hungarian expects rows <= cols, got {r} x {c}")
    out = torch.empty((lanes, r), dtype=torch.int32, device=cost.device)
    if out.numel() == 0:
        return out
    from video_knet_tpu_torch.ops.kernels.build import load_library

    lib = load_library()
    with torch.cuda.device(cost.device):
        rc = lib.vk_hungarian(cost.data_ptr(), out.data_ptr(), lanes, r, c,
                              torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"vk_hungarian: CUDA launch failed with error {rc}")
    LAUNCHES["hungarian"] += 1
    BYTES["hungarian"] += 4 * (lanes * r * c + lanes * r)
    return out
