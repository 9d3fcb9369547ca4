"""Mixed precision: the bf16 casts and the bf16 training forward.

Counterpart of `video_knet_tpu/utils/precision.py`. The reference ships fp16
through mmcv's Fp16OptimizerHook, which no release config enables; the JAX
package trains in bfloat16 with `bf16_train`: the forward runs on bf16
copies of the parameters and BatchNorm statistics, the fp32 masters and the
optimizer state stay fp32, and the gradients arrive fp32 through the casts.

- `cast_params` / `cast_variables` decide leaf by leaf as JAX's do, on the
  flax name each port tensor carries (`utils/convert.py:flax_names`): with
  `keep_norms_fp32`, a leaf named `scale`, `bias`, `mean` or `var` stays
  fp32 (JAX's `_NORM_KEYS`: every bias, not only a norm's); BatchNorm's
  running statistics are JAX's `batch_stats`. The names are looked up
  once a model.
- `bf16_forward(model)`: the model's forward on differentiable bf16 casts
  of its parameters and statistics (`torch.func.functional_call`), under
  `promote_like_jax`.
- `layer_dtypes(model)`: the output dtypes of the backbone's and neck's
  convolutions and dense layers while it is open; in a bf16 forward every
  one is bf16, in an fp32 forward fp32. It shows that `bf16_forward`
  computes in bf16 where the loss cannot: a bf16 loss may lie closer to
  the fp32 loss than two bf16 implementations lie to each other.
- `promote_like_jax`: jnp promotes bf16 x fp32 to fp32 in a matmul, a
  convolution or a norm (flax's `promote_dtype`), where PyTorch raises on
  mixed dtypes; inside this mode those calls cast their floating inputs to
  the promoted dtype first, so the port's dtype flow is JAX's.
"""

from __future__ import annotations

import contextlib
import weakref

import torch
import torch.nn.functional as F
from torch import nn
from torch.overrides import TorchFunctionMode

_NORM_KEYS = ("scale", "bias", "mean", "var")
_PLANS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()  # model -> _keep_fp32's sets


def _keep_fp32(model: nn.Module, keep_norms_fp32: bool) -> tuple[frozenset, frozenset]:
    """The names of `model`'s parameters that `cast_params` keeps fp32 (a
    flax name ending in a norm key, with `keep_norms_fp32`) and of its
    BatchNorm statistics (JAX's `batch_stats`). Decided once a model: the
    names do not change."""
    plans = _PLANS.setdefault(model, {})
    if keep_norms_fp32 not in plans:
        from video_knet_tpu_torch.utils.convert import flax_names

        names = flax_names(model, dict(model.named_parameters()))
        norms = frozenset(k for k, n in names.items() if n.rpartition("/")[2] in _NORM_KEYS)
        stats = flax_names(model, [k for k, _ in model.named_buffers()
                                   if k.endswith(("running_mean", "running_var"))])
        plans[keep_norms_fp32] = (norms if keep_norms_fp32 else frozenset(),
                                  frozenset(k for k, n in stats.items()
                                            if n.startswith("batch_stats/")))
    return plans[keep_norms_fp32]


def cast_params(model: nn.Module, dtype: torch.dtype = torch.bfloat16,
                keep_norms_fp32: bool = True) -> dict[str, torch.Tensor]:
    """{name: tensor} of `model`'s parameters, floating leaves cast to
    `dtype` (differentiably); with `keep_norms_fp32`, leaves whose flax name
    ends in `scale` or `bias` stay fp32."""
    norms, _ = _keep_fp32(model, keep_norms_fp32)
    out = {}
    for k, v in model.named_parameters():
        if not v.is_floating_point():
            out[k] = v
        elif k in norms:
            out[k] = v.float()
        else:
            out[k] = v.to(dtype)
    return out


def cast_variables(model: nn.Module, dtype: torch.dtype = torch.bfloat16,
                   keep_norms_fp32: bool = False) -> dict[str, torch.Tensor]:
    """The parameters and the BatchNorm statistics (JAX's `batch_stats`) of
    `model`, for a bf16 forward: by default every floating leaf in `dtype`,
    norms and statistics too (a norm kept in fp32 would promote everything
    after it back to fp32). Other buffers keep their dtype."""
    out = cast_params(model, dtype=dtype, keep_norms_fp32=keep_norms_fp32)
    _, stats = _keep_fp32(model, keep_norms_fp32)
    for k, v in model.named_buffers():
        if k in stats:
            out[k] = v if keep_norms_fp32 or not v.is_floating_point() else v.to(dtype)
    return out


# the calls of the port's models that raise on mixed dtypes
_PROMOTED = {F.linear, F.conv2d, F.layer_norm, F.batch_norm, torch.matmul, torch.einsum,
             torch.Tensor.matmul, torch.Tensor.__matmul__}


def _flat(args) -> list:
    out = []
    for a in args:
        if isinstance(a, (list, tuple)):
            out.extend(_flat(a))
        else:
            out.append(a)
    return out


def _cast(a, dtype):
    if torch.is_tensor(a) and a.is_floating_point() and a.dtype != dtype:
        return a.to(dtype)
    if isinstance(a, (list, tuple)):
        return type(a)(_cast(x, dtype) for x in a)
    return a


class promote_like_jax(TorchFunctionMode):
    """Inside: a matmul, convolution or norm call whose floating tensor
    inputs mix dtypes runs in their promoted dtype, as jnp computes it."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PROMOTED:
            floats = [a for a in _flat(list(args) + list(kwargs.values()))
                      if torch.is_tensor(a) and a.is_floating_point()]
            dtypes = {a.dtype for a in floats}
            if len(dtypes) > 1:
                dtype = dtypes.pop()
                for d in dtypes:
                    dtype = torch.promote_types(dtype, d)
                args = _cast(tuple(args), dtype)
                kwargs = {k: _cast(v, dtype) for k, v in kwargs.items()}
        return func(*args, **kwargs)


def cast_tree(tree):
    """Every bf16 tensor of a nest of tuples, lists, dicts and NamedTuples
    cast to fp32 (the model outputs before the losses)."""
    if torch.is_tensor(tree):
        return tree.float() if tree.dtype == torch.bfloat16 else tree
    if isinstance(tree, dict):
        return {k: cast_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(cast_tree(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_tree(v) for v in tree)
    return tree


class _Method(nn.Module):
    """`model.<method>` as a forward, for `functional_call`."""

    def __init__(self, model: nn.Module, method: str):
        super().__init__()
        self.model = model
        self.method = method

    def forward(self, *args, **kwargs):
        return getattr(self.model, self.method)(*args, **kwargs)


def bf16_forward(model: nn.Module, method: str, *args, **kwargs):
    """`model.<method>(*args, **kwargs)` on bf16 casts of its parameters
    and BatchNorm statistics (`cast_variables`), under `promote_like_jax`;
    the outputs' bf16 tensors come back fp32 (`cast_tree`). The caller casts
    the inputs it wants in bf16. Gradients reach the fp32 masters through
    the casts, in fp32."""
    variables = {f"model.{k}": v for k, v in cast_variables(model).items()}
    with promote_like_jax():
        out = torch.func.functional_call(_Method(model, method), variables, args, kwargs,
                                         strict=False)
    return cast_tree(out)


@contextlib.contextmanager
def layer_dtypes(model: nn.Module, parts: tuple[str, ...] = ("backbone", "neck")):
    """Inside: {layer name: set of output dtypes} of the convolutions and
    dense layers under `model.<part>` for each part the model has (an RFP
    backbone has no neck), filled as they run."""
    from video_knet_tpu_torch.models.layers import Conv2d

    seen: dict[str, set] = {}

    def record(name):
        return lambda mod, inputs, out: seen.setdefault(name, set()).add(out.dtype)

    handles = [mod.register_forward_hook(record(f"{part}.{name}"))
               for part in parts if getattr(model, part) is not None
               for name, mod in getattr(model, part).named_modules()
               if isinstance(mod, (nn.Conv2d, nn.Linear, Conv2d))]
    try:
        yield seen
    finally:
        for h in handles:
            h.remove()
