"""Carry weights from the flax variables tree to the port's `state_dict`.

Accepts the nested `variables` pytree (as numpy or anything `np.asarray`
takes) or the flat `{"params/a/b/kernel": array}` layout of
`tests/trained_golden_common.py:save_weights`. The port's module paths
mirror the flax names, so each flax path maps onto one torch key:

  params/<path>/kernel   4-D conv HWIO           -> <path>.weight  OIHW
                         2-D Dense [in, out]     -> <path>.weight  [out, in]
                         3-D MHA query/key/value [D, H, hd] -> [H*hd, D]
                         3-D MHA out [H, hd, D]             -> [D, H*hd]
  params/<path>/bias     (MHA [H, hd] flattened) -> <path>.bias
  params/<path>/scale                            -> <path>.weight
  params/<path>/<name>   (e.g. init_kernels)     -> <path>.<name>
  batch_stats/<path>/mean, var                   -> <path>.running_mean, running_var

The stuff kernels need no entry: the port reads them from `conv_seg.weight`
as the JAX head does. Loading is strict: every flax leaf is consumed and
every port parameter and buffer is filled, or it raises.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn


def flatten_variables(variables) -> dict[str, np.ndarray]:
    """Nested or flat variables -> {"collection/path/leaf": numpy array}."""
    flat: dict[str, np.ndarray] = {}

    def walk(prefix: str, node):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else str(k), v)
        else:
            flat[prefix] = np.asarray(node)

    walk("", variables)
    return flat


def _convert_leaf(collection: str, path: list[str], leaf: str, v: np.ndarray):
    key_path = ".".join(path)

    def key(name: str) -> str:
        return f"{key_path}.{name}" if key_path else name

    if collection == "batch_stats":
        names = {"mean": "running_mean", "var": "running_var"}
        if leaf not in names:
            raise KeyError(f"unknown batch_stats leaf {leaf!r} at {key_path}")
        return key(names[leaf]), v
    if collection != "params":
        raise KeyError(f"unknown variable collection {collection!r}")
    if leaf == "kernel":
        if v.ndim == 4:
            v = v.transpose(3, 2, 0, 1)
        elif v.ndim == 2:
            v = v.T
        elif v.ndim == 3 and path and path[-1] == "out":
            v = v.reshape(-1, v.shape[-1]).T
        elif v.ndim == 3:
            v = v.reshape(v.shape[0], -1).T
        else:
            raise ValueError(f"unexpected {v.ndim}-D kernel at {key_path}")
        return key("weight"), v
    if leaf == "bias":
        return key("bias"), v.reshape(-1)
    if leaf == "scale":
        return key("weight"), v
    return key(leaf), v


def flax_to_state_dict(variables) -> dict[str, torch.Tensor]:
    out: dict[str, torch.Tensor] = {}
    for name, v in flatten_variables(variables).items():
        collection, *path, leaf = name.split("/")
        key, arr = _convert_leaf(collection, path, leaf, v)
        if key in out:
            raise KeyError(f"two flax leaves map onto {key}")
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32))  # owned copy
    return out


def load_flax_variables(module: nn.Module, variables) -> nn.Module:
    """Fill every parameter and buffer of `module` from flax variables (strict)."""
    sd = flax_to_state_dict(variables)
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    if missing or unexpected:
        raise KeyError(f"flax -> torch mismatch: port keys without a flax leaf {missing}; "
                       f"flax leaves without a port key {unexpected}")
    for k, t in own.items():
        if tuple(sd[k].shape) != tuple(t.shape):
            raise ValueError(f"{k}: flax shape {tuple(sd[k].shape)} vs port {tuple(t.shape)}")
        sd[k] = sd[k].to(dtype=t.dtype, device=t.device)
    module.load_state_dict(sd, strict=True)
    return module
