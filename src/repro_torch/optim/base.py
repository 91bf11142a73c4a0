"""The optimizer interface and `apply_updates` (``repro.optim.base``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

__all__ = ["Optimizer", "OptState", "apply_updates", "tree_map", "shard_like"]

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


def _children(tree):
    """(kind, keys, children) of an inner node of a state tree — a dict
    (keys sorted, as jax flattens it), a tuple, list or NamedTuple, a
    mutable dataclass instance (a state; a frozen one is metadata) — or
    None for a leaf.  None itself is an empty node (no leaves), as in
    jax."""
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return ("dict", keys, [tree[k] for k in keys])
    if isinstance(tree, (tuple, list)):
        return (type(tree), len(tree), list(tree))
    if (dataclasses.is_dataclass(tree) and not isinstance(tree, type)
            and not tree.__dataclass_params__.frozen):
        names = tuple(f.name for f in dataclasses.fields(tree))
        return (type(tree), names, [getattr(tree, n) for n in names])
    if tree is None:
        return ("none", 0, [])
    return None


def _signature(tree):
    """The structure of ``tree`` with each leaf's shape: equal signatures
    are the reference's same treedef and same leaf shapes."""
    node = _children(tree)
    if node is None:
        return tuple(getattr(tree, "shape", ()))
    kind, keys, kids = node
    return (kind, keys, tuple(_signature(k) for k in kids))


def _rebuild(tree, kids: list):
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), kids))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*kids)
    if isinstance(tree, (tuple, list)):
        return type(tree)(kids)
    return dataclasses.replace(tree, **dict(zip(
        (f.name for f in dataclasses.fields(tree)), kids)))


def shard_like(state: Tree, params: Tree, params_sharding: Any,
               scalar_sharding: Any = None) -> Tree:
    """The sharding tree of an optimizer (or training) state (the
    reference's ``optim.base.shard_like``): every subtree congruent with
    ``params`` — adam's mu and nu, momentum buffers, dsgt's tracker pair
    — gets ``params_sharding`` whole; every other tensor or number (step
    counters, scalar hyper-state) gets ``scalar_sharding``.  Congruent
    means the same structure AND the same leaf shapes, so a state node
    that merely is a dict of the same keys is never mistaken for the
    parameters.  Dicts, tuples, lists, NamedTuples and mutable dataclasses
    are inner nodes; any other object (a `kernels.FlatLayout`, the static
    metadata a jax pytree would not hold as a leaf) stays as it is."""
    want = _signature(params)

    def walk(node):
        if _signature(node) == want:
            return params_sharding
        inner = _children(node)
        if inner is None:
            return (scalar_sharding if isinstance(
                node, (torch.Tensor, int, float, bool)) else node)
        if inner[0] == "none":
            return None
        return _rebuild(node, [walk(k) for k in inner[2]])
    return walk(state)
