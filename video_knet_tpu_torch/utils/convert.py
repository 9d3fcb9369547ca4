"""Carry weights between the flax variables tree and the port's `state_dict`.

Accepts the nested `variables` pytree (as numpy or anything `np.asarray`
takes) or the flat `{"params/a/b/kernel": array}` layout of
`tests/trained_golden_common.py:save_weights`. The port's module paths
mirror the flax names, so each flax path maps onto one torch key:

  params/<path>/kernel   4-D conv HWIO           -> <path>.weight  OIHW
                         (SAC's own kernel too; its weight_diff likewise
                         -> <path>.weight_diff OIHW)
                         3-D deformable conv [k*k, C, F] -> <path>.weight as is
                         (known by its module: `load_flax_variables`)
                         2-D Dense [in, out]     -> <path>.weight  [out, in]
                         3-D MHA query/key/value [D, H, hd] -> [H*hd, D]
                         3-D MHA out [H, hd, D]             -> [D, H*hd]
  params/<path>/bias     (MHA [H, hd] flattened) -> <path>.bias
  params/<path>/scale                            -> <path>.weight
  params/<path>/<name>   (e.g. init_kernels)     -> <path>.<name>
  batch_stats/<path>/mean, var                   -> <path>.running_mean, running_var

The stuff kernels need no entry: the port reads them from `conv_seg.weight`
as the JAX head does. Swin's stages are scanned in flax (the RFP Swin's
are not: its blocks are `stage{s}_block{b}`), so every leaf under
a `stage{s}_pairs` path carries a leading pair axis; it is unstacked into
`stage{s}_pairs.{k}.` before any layout rule sees the leaf (a stacked Dense
kernel would look like an MHA projection). Loading is strict: every flax
leaf is consumed and every port parameter and persistent buffer is filled,
or it raises.

`state_dict_to_flax` is the inverse, for parameters, buffers or parameter
gradients, so the port's gradients and updates can be held against JAX's
leaf by leaf.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from video_knet_tpu_torch.models.deform_conv import DeformConv2d
from video_knet_tpu_torch.models.layers import (
    BatchNorm,
    Conv2d,
    FastVarianceLayerNorm,
    GroupNorm,
    MultiHeadAttention,
)
from video_knet_tpu_torch.models.rfp import SAConv

_NORMS = (nn.LayerNorm, FastVarianceLayerNorm, GroupNorm, BatchNorm)
_SCANNED = re.compile(r"stage\d+_pairs")  # flax nn.scan over Swin block pairs
_UNSTACKED = re.compile(r"^(.*/stage\d+_pairs)/(\d+)/(.*)$")


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


def _convert_leaf(collection: str, path: list[str], leaf: str, v: np.ndarray,
                  dcn: bool = False):
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
    if leaf == "weight_diff":  # SAC's atrous delta, HWIO like its kernel
        return key(leaf), v.transpose(3, 2, 0, 1)
    if leaf == "kernel":
        if v.ndim == 3 and dcn:
            pass  # a deformable conv's [k*k, C, F], kept as is
        elif v.ndim == 4:
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


def _unstack(path: list[str], v: np.ndarray):
    """(path, leaf) pairs: one per scanned pair if the path has a scan axis."""
    for i, part in enumerate(path):
        if _SCANNED.fullmatch(part):
            return [(path[:i + 1] + [str(k)] + path[i + 1:], v[k]) for k in range(v.shape[0])]
    return [(path, v)]


def _is_dcn(module: nn.Module | None, path: list[str]) -> bool:
    try:
        return isinstance(module.get_submodule(".".join(path)), DeformConv2d)
    except AttributeError:  # no module, or no such path (strict loading reports it)
        return False


def flax_to_state_dict(variables, module: nn.Module | None = None) -> dict[str, torch.Tensor]:
    """`module`, when given, names the deformable convs, whose 3-D kernel
    is kept as is (without it, a 3-D kernel is an MHA projection's)."""
    out: dict[str, torch.Tensor] = {}
    for name, stacked in flatten_variables(variables).items():
        collection, *stacked_path, leaf = name.split("/")
        for path, v in _unstack(stacked_path, stacked):
            key, arr = _convert_leaf(collection, path, leaf, v, _is_dcn(module, path))
            if key in out:
                raise KeyError(f"two flax leaves map onto {key}")
            out[key] = torch.from_numpy(np.array(arr, dtype=np.float32))  # owned copy
    return out


def load_flax_variables(module: nn.Module, variables) -> nn.Module:
    """Fill every parameter and buffer of `module` from flax variables (strict)."""
    sd = flax_to_state_dict(variables, module)
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


def _flax_key(module: nn.Module, name: str) -> tuple[str, str, str]:
    """A port tensor name -> (flax key, its layout rule, the owner's path):
    the rule is "" (as is), "conv" (OIHW -> HWIO), "dense" ([out, in] ->
    [in, out]), "mha_out" / "mha_in" (an MHA projection) or "mha_bias"."""
    owner_path, _, leaf = name.rpartition(".")
    owner = module.get_submodule(owner_path)
    parent = module.get_submodule(owner_path.rpartition(".")[0])
    path = owner_path.replace(".", "/")
    if isinstance(owner, BatchNorm) and leaf in ("running_mean", "running_var"):
        return f"batch_stats/{path}/{leaf[len('running_'):]}", "", owner_path
    mha = isinstance(parent, MultiHeadAttention) and isinstance(owner, nn.Linear)
    rule = ""
    if leaf == "weight" and isinstance(owner, _NORMS):
        leaf = "scale"
    elif leaf == "weight" and isinstance(owner, (Conv2d, SAConv)):
        leaf, rule = "kernel", "conv"
    elif leaf == "weight_diff":
        rule = "conv"
    elif leaf == "weight" and isinstance(owner, DeformConv2d):
        leaf = "kernel"
    elif leaf == "weight" and mha:
        leaf, rule = "kernel", "mha_out" if owner_path.endswith("out") else "mha_in"
    elif leaf == "weight" and isinstance(owner, nn.Linear):
        leaf, rule = "kernel", "dense"
    elif leaf == "bias" and mha and not owner_path.endswith("out"):
        rule = "mha_bias"
    # a parameter of the root module itself (e.g. a head's init_query) has no path
    return "/".join(("params", path, leaf) if path else ("params", leaf)), rule, owner_path


def flax_names(module: nn.Module, names) -> dict[str, str]:
    """{port name: the flax leaf path it carries}, as `state_dict_to_flax`
    names it, Swin's block pairs under their stacked (scan) path."""
    return {name: _UNSTACKED.sub(r"\1/\3", _flax_key(module, name)[0]) for name in names}


def state_dict_to_flax(module: nn.Module,
                       tensors: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Port {name: tensor} (parameters, buffers, or parameter gradients) ->
    flat {"collection/path/leaf": numpy array} in flax's layouts, the keys of
    `flatten_variables`: OIHW -> HWIO, Dense [out, in] -> [in, out], the MHA
    projections back to [D, H, hd] / [H, hd, D] and their biases to [H, hd],
    Swin's block pairs restacked on the scan axis."""
    out: dict[str, np.ndarray] = {}
    for name, t in tensors.items():
        v = t.detach().cpu().numpy().copy()  # owned: no view of the module's storage
        key, rule, owner_path = _flax_key(module, name)
        if rule == "conv":
            v = v.transpose(2, 3, 1, 0)
        elif rule == "dense":
            v = v.T
        elif rule.startswith("mha"):
            h = module.get_submodule(owner_path.rpartition(".")[0]).num_heads
            if rule == "mha_out":
                v = v.T.reshape(h, v.shape[1] // h, -1)
            elif rule == "mha_in":
                v = v.T.reshape(v.shape[1], h, -1)
            else:
                v = v.reshape(h, -1)
        out[key] = np.ascontiguousarray(v)
    return _restack(out)


def _restack(flat: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """`.../stage{s}_pairs/{k}/rest` leaves -> one `.../stage{s}_pairs/rest`
    leaf stacked over k."""
    out: dict[str, np.ndarray] = {}
    pairs: dict[str, dict[int, np.ndarray]] = {}
    for name, v in flat.items():
        m = _UNSTACKED.match(name)
        if m:
            pairs.setdefault(f"{m.group(1)}/{m.group(3)}", {})[int(m.group(2))] = v
        else:
            out[name] = v
    for name, by_pair in pairs.items():
        if sorted(by_pair) != list(range(len(by_pair))):
            raise KeyError(f"{name}: pairs {sorted(by_pair)} do not run 0..n-1")
        out[name] = np.stack([by_pair[k] for k in range(len(by_pair))])
    return out
