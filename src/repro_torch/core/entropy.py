"""Information-theoretic privacy strength (Theorem 5) (counterpart of
``repro.core.entropy``; numpy only, the same formulas).

For gradient g ~ U[-kappa, kappa] and private stepsize lam ~ U[0, 2 lam_bar]
(2 lam_bar <= kappa), the adversary observes y = lam * g.  The paper derives

  h(g, y)       = log(4 lam_bar kappa^2) - 1                          (joint)
  p_y(x)        = log(2 lam_bar kappa / |x|) / (4 lam_bar kappa)      (density)
  theta         = h(g,y) - h(y) = log(4 lam_bar kappa^2) - 1 - c(...) (48)

and bounds any estimator's MSE by e^{2 theta} / (2 pi e)  (Eq. 2).

Closed form (derived here, validates the paper's numerics): with
a = 2 lam_bar kappa and the substitution t = x/a,

  h(y)       = log(2a) - (1 - gamma_EM)        [since ∫0^1 (-log t) log(-log t) dt = 1 - gamma_EM]
  h(g | y)   = log(kappa) - gamma_EM           (independent of lam_bar!)

For kappa = 5: h = log 5 - gamma_EM = 1.03222...  and the MSE bound
e^{2h}/(2 pi e) = 0.46143...  — exactly the paper's Remark 5 numbers.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "EULER_GAMMA",
    "joint_entropy",
    "product_entropy_numeric",
    "product_entropy_closed",
    "theta_numeric",
    "theta_closed",
    "conditional_entropy_closed",
    "mse_lower_bound",
]

EULER_GAMMA = 0.5772156649015328606


def joint_entropy(lam_bar: float, kappa: float) -> float:
    """h(g, lam*g) = log(4 lam_bar kappa^2) - 1 (natural log, nats)."""
    return float(np.log(4.0 * lam_bar * kappa**2) - 1.0)


def product_entropy_closed(lam_bar: float, kappa: float) -> float:
    """h(lam*g) = log(4 lam_bar kappa) - (1 - gamma_EM)."""
    return float(np.log(4.0 * lam_bar * kappa) - (1.0 - EULER_GAMMA))


def product_entropy_numeric(lam_bar: float, kappa: float, n: int = 400_000) -> float:
    """h(lam*g) by numerically integrating the paper's Eq. (49) integrand.

    c(lam_bar, kappa) = -2 int_0^{2 lam_bar kappa} p(x) log p(x) dx with
    p(x) = log(2 lam_bar kappa / x) / (4 lam_bar kappa).  The integrand has an
    integrable log-singularity at both ends; we substitute t = x / a and use
    the midpoint rule on a geometric+linear composite grid.
    """
    a = 2.0 * lam_bar * kappa
    # t-grid clustered near 0 (log singularity) and near 1 (p -> 0).
    t = np.concatenate([
        np.geomspace(1e-14, 1e-3, n // 4),
        np.linspace(1e-3, 1.0 - 1e-9, 3 * n // 4),
    ])
    mid = 0.5 * (t[1:] + t[:-1])
    dt = np.diff(t)
    p = np.log(1.0 / mid) / (2.0 * a)  # density at x = a * mid
    integrand = -p * np.log(p)
    # integral over x in (0, a): dx = a dt ; two symmetric sides -> factor 2
    return float(2.0 * np.sum(integrand * dt * a))


def theta_closed(lam_bar: float, kappa: float) -> float:
    """theta = h(g|y) in closed form: log(kappa) - gamma_EM (lam_bar-free)."""
    return float(np.log(kappa) - EULER_GAMMA)


def theta_numeric(lam_bar: float, kappa: float) -> float:
    """Eq. (48): log(4 lam_bar kappa^2) - 1 - c(lam_bar, kappa)."""
    return joint_entropy(lam_bar, kappa) - product_entropy_numeric(lam_bar, kappa)


def conditional_entropy_closed(kappa: float) -> float:
    return theta_closed(1.0, kappa)


def mse_lower_bound(theta: float) -> float:
    """Eq. (2): E[(g - g_hat)^2] >= e^{2 theta} / (2 pi e)."""
    return float(np.exp(2.0 * theta) / (2.0 * np.pi * np.e))
