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

import numpy as np
import torch

from ..kernels.build import to_device
from . import entropy as E
from . import prng

__all__ = ["agent_key", "leaf_keys", "tree_leaves", "tree_unflatten",
           "obfuscated_gradient", "sample_B", "clip_gradients",
           "lambda_stats"]

Tree = Any


def agent_key(key: torch.Tensor, step, agent) -> torch.Tensor:
    """The private key of ``agent`` at ``step`` (``agent`` may be a tensor
    of agent ids, giving one key per id).  ``step`` is an int, or an int
    tensor on key's device (a CUDA graph's step counter: no host sync)."""
    if not isinstance(step, torch.Tensor):
        step = int(step)
    return prng.fold_in(prng.fold_in(key, step), agent)


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


def leaf_keys(key: torch.Tensor, tree: Tree, partitionable: bool = True):
    """One key per leaf: ``(keys (n_leaves, 2), leaves)``."""
    leaves = tree_leaves(tree)
    return prng.split(key, len(leaves), partitionable), leaves


def obfuscated_gradient(key: torch.Tensor, grads: Tree, lam_bar: float,
                        partitionable: bool = True) -> Tree:
    """u = Lambda ∘ g for ONE agent, lambda ~ U[0, 2 lam_bar] per element,
    computed in f32 and cast back to the gradient's dtype (``partitionable``:
    the threefry stream, `core.prng`)."""
    keys, leaves = leaf_keys(key, grads, partitionable)
    out = []
    for k, g in zip(keys, leaves):
        u01 = prng.uniform(k, g.shape, partitionable).to(g.device)
        lam = (2.0 * torch.as_tensor(lam_bar, dtype=torch.float32).to(
            g.device)) * u01
        out.append((lam * g.float()).to(g.dtype))
    return tree_unflatten(grads, out)


def sample_B(key: torch.Tensor, support: torch.Tensor,
             partitionable: bool = True) -> torch.Tensor:
    """Random column-stochastic B^k on ``support``: Exp(1) draws on the
    support, normalized per column (a Dirichlet(1, .., 1) per neighbor
    set).  Drawn on ``support``'s device (a host key is copied there
    first), so a step on the card realizes the same B whether its key was
    derived on the host or on the card."""
    support = support.float()
    e = prng.exponential(to_device(key, support.device),
                         tuple(support.shape), partitionable)
    e = e * support
    col = e.sum(dim=0, keepdim=True)
    return e / torch.clamp_min(col, 1e-30)


def clip_gradients(grads: Tree, kappa: float) -> Tree:
    """Elementwise clip to [-kappa, kappa], the bounded-gradient premise
    |g| <= kappa of Theorem 5's per-element guarantees, applied before
    obfuscation.  A tensor (the flat (m, width) gradient buffer) is
    clipped in place; a tree gets new leaves.  Rounding kappa to a
    bfloat16 leaf's dtype before the clip equals the reference's clip in
    float32 and cast after it (the leaf's values are representable)."""
    kappa = float(kappa)
    if isinstance(grads, torch.Tensor):
        return grads.clamp_(-kappa, kappa)
    return tree_unflatten(grads, [g.clamp(-kappa, kappa)
                                  for g in tree_leaves(grads)])


def lambda_stats(lam_bar: float, kappa: float | None = None) -> dict:
    """Mean, std and variance of the U[0, 2 lam_bar] stepsize; with
    ``kappa`` (the `clip_gradients` bound) also the observation envelope
    ``y_max`` = 2 lam_bar kappa, Theorem 5's ``theta`` = log(kappa) -
    gamma_EM and ``mse_bound`` = e^{2 theta} / (2 pi e)."""
    stats = {"mean": lam_bar, "std": lam_bar / np.sqrt(3.0),
             "var": lam_bar ** 2 / 3.0}
    if kappa is not None:
        theta = E.theta_closed(lam_bar, kappa)
        stats.update(y_max=2.0 * lam_bar * kappa, kappa=float(kappa),
                     theta=theta, mse_bound=E.mse_lower_bound(theta))
    return stats
