"""AdamW (``repro.optim.adam``), in f32 whatever the gradients' dtype."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .base import Optimizer, tree_map

__all__ = ["adam", "AdamState"]


class AdamState(NamedTuple):
    mu: object
    nu: object
    count: int


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """AdamW (beyond the paper, whose algorithm is plain SGD).  The bias
    corrections 1 - b^count are float32 scalars from a float32 power, as
    the reference's (numpy's powf; XLA's may differ by an ulp)."""

    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamState(mu=tree_map(zeros, params),
                         nu=tree_map(zeros, params), count=0)

    def update(grads, state, params=None):
        count = state.count + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                      state.nu, grads)
        # float32 scalars, as the reference's 1 - b ** count in f32
        c1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        c2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))

        def upd(m, v, p=None):
            step = -lr * (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay and p is not None:
                step = step - lr * weight_decay * p.float()
            return step

        if params is None:
            updates = tree_map(upd, mu, nu)
        else:
            updates = tree_map(upd, mu, nu, params)
        return updates, AdamState(mu=mu, nu=nu, count=count)

    return Optimizer(init, update)

