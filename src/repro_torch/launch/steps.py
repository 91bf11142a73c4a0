"""Step builders (counterpart of ``repro.launch.steps``): the per-step key
stream.

The mesh train step (``make_train_step`` over the agent torus, with
``torus_topology``, ``make_torus_W`` and ``dsgt_carry``) needs a device
mesh and waits for the distributed slice (ROADMAP item 7); on one card
the trainer runs `core.pdsgd.make_decentralized_step`.  The reference's
``make_prefill_step`` and ``make_decode_step`` forward to a bundle's
``prefill_fn`` and ``decode_fn``, which the port's callers use directly.
"""
from __future__ import annotations

import torch

from ..core import prng

__all__ = ["per_step_keys"]


def per_step_keys(key: torch.Tensor, start_step: int, n: int) -> torch.Tensor:
    """(n, 2) keys of the global steps [start_step, start_step + n):
    ``fold_in(key, k)`` on the absolute step, never a split of a carried
    key, so a chunk of them is the eager loop's keys bit for bit and a
    resumed run never re-issues a (key, step) pair."""
    steps = torch.arange(start_step, start_step + n, dtype=torch.int64,
                         device=key.device)
    return prng.fold_in(key, steps)
