"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_port_*.py).

Inputs are made with numpy from a seed and handed to both the JAX function
and its port; weights go from the flax variables to the port through
`video_knet_tpu_torch.utils.convert`.
"""

from __future__ import annotations

import jax
import numpy as np
import torch
from flax import traverse_util

from video_knet_tpu_torch.utils.convert import load_flax_variables


def t(x) -> torch.Tensor:
    """numpy / jax array -> CPU torch tensor (copy)."""
    return torch.from_numpy(np.array(x))


def n(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def perturb_norms(variables, seed: int = 0):
    """Move norm scales/biases and BN statistics off their init values
    (1, 0, 0, 1), so the parity tests also check how they are carried."""
    rng = np.random.RandomState(seed)
    flat = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, variables))
    out = {}
    for k, v in flat.items():
        leaf = k[-1]
        if leaf in ("scale", "var"):
            v = (1.0 + 0.2 * np.abs(rng.randn(*v.shape))).astype(v.dtype)
        elif leaf in ("bias", "mean"):
            v = (0.1 * rng.randn(*v.shape)).astype(v.dtype)
        out[k] = v
    return traverse_util.unflatten_dict(out)


def port_of(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Load flax variables into a port module (strict) and set eval mode."""
    return load_flax_variables(module, variables).eval()


def assert_rel_close(got, want, rel: float, what: str = "") -> None:
    """max |got - want| <= rel * max |want| (fp32 sums in another order)."""
    got, want = n(got), n(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max abs err {err:.3e} > {rel} * {scale:.3e}"
