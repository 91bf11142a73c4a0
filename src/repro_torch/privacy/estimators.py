"""Empirical entropy / privacy-strength estimators for Theorem 5.

`core.entropy` carries the CLOSED forms the paper derives for the
observation y = lam * g (g ~ U[-kappa, kappa], lam ~ U[0, 2 lam_bar]):
h(y), theta = h(g | y) = log(kappa) - gamma_EM, and the estimator MSE
floor e^{2 theta} / (2 pi e).  This module estimates the same quantities
FROM SAMPLES — either synthetic draws or actual Lambda∘g observations
captured off the wire (`privacy.observe`) — so the audit can check that
the system's realized randomness delivers the entropy the theory claims,
not just that the formulas integrate correctly.

Two differential-entropy estimators, chosen for complementary failure
modes:

* ``binned_entropy``  — plug-in histogram estimator: simple, fast, biased
                        DOWN near p_y's log-singularity at 0 (mass in the
                        origin bin is smeared over its width);
* ``knn_entropy``     — Kozachenko–Leonenko k-nearest-neighbor estimator
                        (the standard nonparametric h estimator; see
                        Kraskov et al. 2004): adapts to the singularity,
                        works in d dims, biased UP slightly for small N.

Agreement of both with the closed form is strong evidence none of the
three is wrong.  Pure numpy (host-side analysis of captured buffers — no
reason to trace this).
"""
from __future__ import annotations

import numpy as np

from ..core import entropy as _closed

__all__ = [
    "binned_entropy",
    "knn_entropy",
    "sample_observations",
    "estimate_h_y",
    "estimate_theta",
    "empirical_recovery_floor",
    "observations_from_capture",
]


def _digamma(x: float) -> float:
    """psi(x) for x > 0: recurrence up to 6, then the asymptotic series
    (|error| < 1e-12 there) — avoids a scipy dependency."""
    x = float(x)
    if x <= 0:
        raise ValueError(f"digamma needs x > 0, got {x}")
    r = 0.0
    while x < 6.0:
        r -= 1.0 / x
        x += 1.0
    f = 1.0 / (x * x)
    return r + np.log(x) - 0.5 / x - f * (
        1.0 / 12.0 - f * (1.0 / 120.0 - f * (1.0 / 252.0)))


def binned_entropy(samples: np.ndarray, bins: int = 512) -> float:
    """Plug-in histogram estimate of differential entropy (nats), 1-D:
    h ≈ -sum p_b log p_b + log(bin_width)."""
    x = np.asarray(samples, dtype=np.float64).ravel()
    counts, edges = np.histogram(x, bins=bins)
    p = counts[counts > 0] / x.size
    width = edges[1] - edges[0]
    return float(-(p * np.log(p)).sum() + np.log(width))


def knn_entropy(samples: np.ndarray, k: int = 4,
                max_n: int | None = None) -> float:
    """Kozachenko–Leonenko estimator in d dims (Euclidean):

        h ≈ psi(N) - psi(k) + log(c_d) + (d / N) * sum_i log(eps_i)

    with eps_i the distance to the k-th nearest neighbor and c_d the unit
    d-ball volume.  1-D uses the sorted sliding window (the k nearest
    neighbors of a sorted point lie within its 2k sorted neighbors);
    higher d falls back to chunked brute-force distances, so cap N via
    ``max_n`` for d >= 2.
    """
    x = np.asarray(samples, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    if max_n is not None and x.shape[0] > max_n:
        rng = np.random.default_rng(0)
        x = x[rng.choice(x.shape[0], max_n, replace=False)]
    n, d = x.shape
    if n <= k:
        raise ValueError(f"need more than k={k} samples, got {n}")
    if d == 1:
        xs = np.sort(x[:, 0])
        pad = np.concatenate([np.full(k, -np.inf), xs, np.full(k, np.inf)])
        # distances to the k sorted neighbors on each side: (n, 2k)
        cols = [np.abs(xs - pad[k + off:k + off + n])
                for off in range(-k, k + 1) if off != 0]
        eps = np.partition(np.stack(cols, axis=1), k - 1, axis=1)[:, k - 1]
        log_c = np.log(2.0)  # 1-ball volume
    else:
        eps = np.empty(n)
        chunk = max(1, int(2e7) // n)
        for s in range(0, n, chunk):
            block = x[s:s + chunk]
            d2 = ((block[:, None, :] - x[None, :, :]) ** 2).sum(-1)
            # k-th neighbor excluding self (self-distance 0 is column k=0)
            eps[s:s + chunk] = np.sqrt(
                np.partition(d2, k, axis=1)[:, k])
        log_c = (d / 2.0) * np.log(np.pi) - _lgamma(d / 2.0 + 1.0)
    eps = np.maximum(eps, 1e-300)  # duplicates would take log(0)
    return float(_digamma(n) - _digamma(k) + log_c
                 + d * np.mean(np.log(eps)))


def _lgamma(x: float) -> float:
    """log Gamma via log(Gamma(x)) = log Gamma(x+n) - sum log(x+i) and
    Stirling's series — again dodging scipy."""
    x = float(x)
    r = 0.0
    while x < 8.0:
        r -= np.log(x)
        x += 1.0
    f = 1.0 / (x * x)
    return r + (x - 0.5) * np.log(x) - x + 0.5 * np.log(2.0 * np.pi) + \
        (1.0 / 12.0 - f * (1.0 / 360.0 - f / 1260.0)) / x


def sample_observations(lam_bar: float, kappa: float, n: int,
                        seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Draw (g, y) from the Theorem-5 reference model: g ~ U[-kappa,
    kappa], lam ~ U[0, 2 lam_bar], y = lam * g.  The synthetic ground
    truth estimators are validated on."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(-kappa, kappa, n)
    lam = rng.uniform(0.0, 2.0 * lam_bar, n)
    return g, lam * g


def estimate_h_y(y: np.ndarray, method: str = "knn", *, k: int = 4,
                 bins: int = 512, max_n: int | None = None) -> float:
    """Empirical h(y) from observed y = lam∘g samples."""
    if method == "knn":
        return knn_entropy(y, k=k, max_n=max_n)
    if method == "binned":
        return binned_entropy(y, bins=bins)
    raise ValueError(f"unknown estimator {method!r}; have knn, binned")


def estimate_theta(y: np.ndarray, lam_bar: float, kappa: float,
                   method: str = "knn", **kw) -> float:
    """Empirical theta = h(g, y) - h(y) from observed y samples.

    h(g, y) = log(4 lam_bar kappa^2) - 1 is used in closed form — it is
    an exact property of the SAMPLING model (uniform g and lam), which
    the audit controls; what is being validated empirically is h(y), the
    term the paper evaluates by numeric integration (Eq. 48-49).  The
    result should match `entropy.theta_closed` = log(kappa) - gamma_EM
    for ANY lam_bar — the lam_bar-free-ness is itself part of the claim.
    """
    return _closed.joint_entropy(lam_bar, kappa) - estimate_h_y(
        y, method, **kw)


def empirical_recovery_floor(g: np.ndarray, y: np.ndarray,
                             bins: int = 200) -> float:
    """MSE of the best binned conditional-mean estimator of g from y —
    the strongest assumption-free adversary on scalar observations.  By
    Theorem 5 / Eq. (2) this must stay above
    `entropy.mse_lower_bound(theta)`; the audit checks exactly that."""
    edges = np.quantile(y, np.linspace(0.0, 1.0, bins + 1))
    idx = np.clip(np.searchsorted(edges, y) - 1, 0, bins - 1)
    sums = np.bincount(idx, weights=g, minlength=bins)
    counts = np.bincount(idx, minlength=bins)
    est = np.where(counts > 0, sums / np.maximum(counts, 1), 0.0)
    return float(np.mean((g - est[idx]) ** 2))


def observations_from_capture(u_stream: np.ndarray) -> np.ndarray:
    """Flatten a captured Lambda∘g buffer (any shape — e.g. the (T, m, D)
    ``u`` field of an auditor observation stream) into the scalar
    observation samples the 1-D estimators consume.  Each element IS one
    draw of y = lam * g with an independent lam (per-element keys)."""
    return np.asarray(u_stream, dtype=np.float64).ravel()
