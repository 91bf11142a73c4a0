"""The optimizer interface and `apply_updates` (``repro.optim.base``)."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

__all__ = ["Optimizer", "OptState", "apply_updates", "tree_map"]

Tree = Any
OptState = Any


class Optimizer(NamedTuple):
    init: Callable[[Tree], OptState]
    update: Callable[[Tree, OptState, Tree], tuple[Tree, OptState]]


def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of nested dicts/tuples/lists (and of
    the trees in ``rest``, of the same structure); None stays None."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return None if tree is None else fn(tree, *rest)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    """params + updates, each update cast to its parameter's dtype."""
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
