"""Stepsize schedules lam_bar(k, agent) (counterpart of
``repro.core.schedules``).

Theorems 2/3 ask, for every agent i:
  (9)  sum_k lam_i^k = inf,  sum_k (lam_i^k)^2 < inf,  sum_k (sig_i^k)^2 < inf
  (10) sum_k sum_{i!=j} |lam_i^k - lam_j^k| < inf      (heterogeneity summable)

Evaluation is dual-mode, as in the reference.  A tensor step (float32 in
the training step, on the device that runs it, no host round-trip)
keeps its dtype and reproduces the reference's float32 device evaluation
operation for operation, so lam_bar is bit-identical; a numpy or Python
step evaluates in float64 on the host and returns numpy, as the
reference's host path does (`check_conditions`).  The paper's 1/k
schedules are evaluated at k + 1 (k is 0-based).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

__all__ = ["Schedule", "harmonic", "paper_experiment", "polynomial",
           "warmup_harmonic", "deviating", "check_conditions"]


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """A python number as a tensor of ``like``'s dtype and device (a fill,
    not a host copy): ``number / tensor`` in torch is ``reciprocal(tensor)
    * number``, which rounds twice; dividing two tensors rounds once, as
    the reference does."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Mean stepsize schedule ``lam_bar(k, agent)``: ``fn(k, agent)`` takes
    a floating tensor ``k`` and a host int ``agent``."""

    name: str
    fn: Callable[[torch.Tensor, int], torch.Tensor]

    def __call__(self, k, agent: int = 0):
        if isinstance(k, torch.Tensor):
            return self.fn(k, int(agent))
        k64 = torch.from_numpy(np.asarray(k, dtype=np.float64))
        return self.fn(k64, int(agent)).numpy()


def harmonic(base: float = 1.0) -> Schedule:
    """lam_bar^k = base / (k + 1), the paper's canonical choice (Remark 1);
    the same for every agent."""
    return Schedule("harmonic", lambda k, a: _const(base, k) / (k + 1.0))


def paper_experiment(base: float = 1.0) -> Schedule:
    """The mean of the paper's Sec. VII stepsize, (1 - 1/(2k))/k at k+1."""

    def fn(k, a):
        kk = k + 1.0
        return base * (1.0 - _const(1.0, k) / (2.0 * kk)) / kk

    return Schedule("paper_experiment", fn)


def polynomial(base: float = 1.0, power: float = 0.75) -> Schedule:
    """base / (k + 1)^power; satisfies (9) for power in (0.5, 1].

    XLA's float32 pow is libm's powf, rounded almost always correctly; torch's
    float32 pow is not, so the power is taken in float64 (the exponent as
    the reference's float32 constant) and rounded once to k's dtype.  That
    equals the reference's device evaluation except where powf misrounds
    (11-21 of the first 20,000 k for the powers 0.51-0.9, measured on the
    CPU; none at power 1)."""
    if not 0.5 < power <= 1.0:
        raise ValueError("power must be in (0.5, 1] for square-summability")

    def fn(k, a):
        p = float(np.float32(power)) if k.dtype == torch.float32 else power
        denom = torch.pow((k + 1.0).double(), p).to(k.dtype)
        return _const(base, k) / denom

    return Schedule(f"poly{power}", fn)


def warmup_harmonic(base: float = 1.0, hold: int = 100) -> Schedule:
    """Linear ramp 0 -> ``base`` over ``hold`` steps, then harmonic decay
    (continuous at k = hold)."""

    def fn(k, a):
        return torch.where(k < hold, base * (k + 1.0) / (hold + 1.0),
                           _const(base * (hold + 1.0), k) / (k + 1.0))

    return Schedule("warmup_harmonic", fn)


def deviating(base_schedule: Schedule, num_agents: int,
              num_deviations: int = 20, max_factor: float = 3.0,
              seed: int = 0) -> Schedule:
    """Remark 1: each agent multiplies lam_bar by a private factor in
    U[1/max_factor, max_factor] at ``num_deviations`` private iterations;
    the tables are the reference's (one ``default_rng(seed)`` draws them
    all, agent by agent).  An agent without a table follows the base."""
    rng = np.random.default_rng(seed)
    idx, fac = {}, {}
    for a in range(num_agents):
        idx[a] = rng.choice(10_000, size=num_deviations, replace=False)
        fac[a] = rng.uniform(1.0 / max_factor, max_factor,
                             size=num_deviations)

    def fn(k, a):
        lam = base_schedule.fn(k, a)
        if a not in idx:
            return lam
        mult = lam * 0.0 + 1.0  # ones in lam's dtype and device
        for i, f in zip(idx[a], fac[a]):
            mult = torch.where(k == float(i), float(f), mult)
        return lam * mult

    return Schedule(f"deviating({base_schedule.name})", fn)


def check_conditions(schedule: Schedule, num_agents: int,
                     horizon: int = 200_000,
                     sigma_of_lam: Callable[[np.ndarray], np.ndarray]
                     | None = None) -> dict:
    """Partial sums of (9) and (10) over ``horizon`` steps, evaluated on
    the host in float64, with the reference's verdicts: whether the tail
    half still carries a share of the sum (non-summable) and whether the
    squares stay bounded."""
    if sigma_of_lam is None:
        sigma_of_lam = lambda lam: lam / np.sqrt(3.0)  # Uniform[0, 2 lam]
    k = np.arange(horizon, dtype=np.float64)
    lam = np.stack([schedule(k, i) for i in range(num_agents)])  # (m, K)
    s1 = lam.sum(axis=1)
    s2 = (lam ** 2).sum(axis=1)
    s3 = (sigma_of_lam(lam) ** 2).sum(axis=1)
    het = 0.0
    for i in range(num_agents):
        for j in range(num_agents):
            if i != j:
                het += np.abs(lam[i] - lam[j]).sum()
    tail_share = lam[:, horizon // 2:].sum(axis=1) / np.maximum(s1, 1e-30)
    return {
        "sum_lam": s1,
        "sum_lam_sq": s2,
        "sum_sigma_sq": s3,
        "heterogeneity": het,
        "tail_share": tail_share,
        "nonsummable_ok": bool(np.all(tail_share > 0.05)),
        "square_summable_ok": bool(np.all(s2 < np.inf) and np.all(s2 < 1e6)),
    }
