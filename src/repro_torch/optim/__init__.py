"""Functional optimizers, optax-style (counterpart of ``repro.optim``):
``init(params) -> state`` and ``update(grads, state, params) -> (updates,
state)`` over a tensor or a tree of tensors; `apply_updates` adds the
updates.  The leading (m, ...) agent axis is one more batch axis, so each
agent keeps its own slice of the state.  `shard_like` gives a state the
shardings of its parameters (`dist.sharding`)."""
from .adam import adam
from .base import Optimizer, OptState, apply_updates, shard_like, tree_map
from .sgd import momentum, sgd

__all__ = ["sgd", "momentum", "adam", "Optimizer", "OptState",
           "apply_updates", "shard_like", "tree_map"]
