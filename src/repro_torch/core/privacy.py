"""Privacy randomness of the paper: the random diagonal stepsizes Lambda^k
and the column-stochastic mixing coefficients B^k (counterpart of
``repro.core.privacy``).

Keys are `prng` threefry keys, so every draw here is bit-identical to the
reference's ``jax.random`` draw from the same (key, step, agent, leaf).
Parameter trees are plain dicts; their leaves are taken in the reference's
``jax.tree.flatten`` order (sorted keys, depth first) — leaf order is part
of the randomness contract, because one key is split per leaf.
"""
from __future__ import annotations

from typing import Any

import torch

from ..kernels.build import to_device
from . import prng

__all__ = ["agent_key", "leaf_keys", "tree_leaves", "tree_unflatten",
           "obfuscated_gradient", "sample_B"]

Tree = Any


def agent_key(key: torch.Tensor, step: int, agent) -> torch.Tensor:
    """The private key of ``agent`` at ``step`` (``agent`` may be a tensor
    of agent ids, giving one key per id)."""
    return prng.fold_in(prng.fold_in(key, int(step)), agent)


def tree_leaves(tree: Tree) -> list:
    """Leaves of a nested dict in ``jax.tree.flatten`` order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like: Tree, leaves) -> Tree:
    """Rebuild a nested dict shaped like ``like`` from ``leaves`` in
    `tree_leaves` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(like)


def tree_paths(tree: Tree, prefix: str = "") -> list[str]:
    """'/'-joined key paths of the leaves, in `tree_leaves` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in tree_paths(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def leaf_keys(key: torch.Tensor, tree: Tree):
    """One key per leaf: ``(keys (n_leaves, 2), leaves)``."""
    leaves = tree_leaves(tree)
    return prng.split(key, len(leaves)), leaves


def obfuscated_gradient(key: torch.Tensor, grads: Tree,
                        lam_bar: float) -> Tree:
    """u = Lambda ∘ g for ONE agent, lambda ~ U[0, 2 lam_bar] per element,
    computed in f32 and cast back to the gradient's dtype."""
    keys, leaves = leaf_keys(key, grads)
    out = []
    for k, g in zip(keys, leaves):
        u01 = prng.uniform(k, g.shape).to(g.device)
        lam = (2.0 * torch.as_tensor(lam_bar, dtype=torch.float32).to(
            g.device)) * u01
        out.append((lam * g.float()).to(g.dtype))
    return tree_unflatten(grads, out)


def sample_B(key: torch.Tensor, support: torch.Tensor) -> torch.Tensor:
    """Random column-stochastic B^k on ``support``: Exp(1) draws on the
    support, normalized per column (a Dirichlet(1, .., 1) per neighbor
    set).  Returned on ``support``'s device."""
    support = support.float()
    e = to_device(prng.exponential(key, tuple(support.shape)), support.device)
    e = e * support
    col = e.sum(dim=0, keepdim=True)
    return e / torch.clamp_min(col, 1e-30)
