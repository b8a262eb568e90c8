"""Nested containers of tensors ("trees"): the port's stand-in for
``jax.tree``'s leaves and map over dicts, lists and tuples.

Dict leaves come in sorted key order, as ``jax.tree.leaves`` gives them,
so a fingerprint of the same dict is taken in the same order by both
packages. An ``nn.Module`` counts as the tree of its parameters, in
registration order.
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch


def leaves(tree: Any) -> List[Any]:
    """Every leaf of ``tree`` (a tensor, array or scalar), in order."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in leaves(v)]
    if tree is None:
        return []
    return [tree]


def tensors(tree: Any) -> List[torch.Tensor]:
    """The tensor leaves of ``tree``, in order."""
    return [leaf for leaf in leaves(tree) if isinstance(leaf, torch.Tensor)]


def map_tree(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``tree`` with every leaf replaced by ``fn(leaf)``; dicts keep their
    own key order, tuples and lists their type (named tuples too)."""
    if isinstance(tree, dict):
        return type(tree)((k, map_tree(fn, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)
