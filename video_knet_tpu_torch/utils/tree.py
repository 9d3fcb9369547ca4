"""Leaf-wise maps over the nested payloads of the serving path.

A payload is a dict, NamedTuple, tuple or list whose leaves are tensors or
numpy arrays (`jax.tree_util.tree_map` in the reference).
"""

from __future__ import annotations

from typing import Any, Callable

import torch


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` applied to the leaves of `tree` and the matching leaves of `rest`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_stack(trees: list) -> Any:
    """Stack a list of same-structure trees along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def tree_index(tree: Any, i: int) -> Any:
    return tree_map(lambda x: x[i], tree)


def to_host(tree: Any) -> Any:
    """Device tensors -> numpy; bf16 leaves cross as bf16 and are re-floated
    on the host (exact), as the reference's `np.asarray(x, np.float32)`."""
    def leaf(x):
        if not torch.is_tensor(x):
            return x
        x = x.cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()

    return tree_map(leaf, tree)

