"""Stepsize schedules lam_bar(k) (counterpart of ``repro.core.schedules``).

A schedule is evaluated on a float32 tensor step — on the device that runs
the step, with no host round-trip — and reproduces the reference's float32
device evaluation operation for operation, so lam_bar is bit-identical.
The paper's 1/k schedules are evaluated at k + 1 (k is 0-based).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = ["Schedule", "paper_experiment", "warmup_harmonic"]


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """A python number as an f32 tensor on ``like``'s device (a fill, not a
    host copy): ``number / tensor`` in torch is ``reciprocal(tensor) *
    number``, which rounds twice; dividing two tensors rounds once, as the
    reference does."""
    return torch.full((), v, dtype=torch.float32, device=like.device)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Mean stepsize schedule ``lam_bar(k)``; ``k`` is a float32 tensor."""

    name: str
    fn: Callable[[torch.Tensor], torch.Tensor]

    def __call__(self, k) -> torch.Tensor:
        return self.fn(torch.as_tensor(k, dtype=torch.float32))


def paper_experiment(base: float = 1.0) -> Schedule:
    """The mean of the paper's Sec. VII stepsize, (1 - 1/(2k))/k at k+1."""

    def fn(k):
        kk = k + 1.0
        return base * (1.0 - _const(1.0, k) / (2.0 * kk)) / kk

    return Schedule("paper_experiment", fn)


def warmup_harmonic(base: float = 1.0, hold: int = 100) -> Schedule:
    """Linear ramp 0 -> ``base`` over ``hold`` steps, then harmonic decay
    (continuous at k = hold)."""

    def fn(k):
        return torch.where(k < hold, base * (k + 1.0) / (hold + 1.0),
                           _const(base * (hold + 1.0), k) / (k + 1.0))

    return Schedule("warmup_harmonic", fn)
