"""Plain SGD and heavy-ball momentum (``repro.optim.sgd``)."""
from __future__ import annotations

import torch

from .base import Optimizer, tree_map

__all__ = ["sgd", "momentum"]


def sgd(lr: float) -> Optimizer:
    """Plain SGD: the paper's algorithm keeps no optimizer state."""

    def init(params):
        return ()

    def update(grads, state, params=None):
        return tree_map(lambda g: -lr * g, grads), state

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9,
             nesterov: bool = False) -> Optimizer:
    def init(params):
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params=None):
        new_m = tree_map(lambda m, g: beta * m + g, state, grads)
        if nesterov:
            upd = tree_map(lambda m, g: -lr * (beta * m + g), new_m, grads)
        else:
            upd = tree_map(lambda m: -lr * m, new_m)
        return upd, new_m

    return Optimizer(init, update)
