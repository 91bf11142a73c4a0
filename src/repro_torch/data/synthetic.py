"""Deterministic synthetic datasets (copied from ``repro.data.synthetic``:
numpy only, so the same seed gives the same data in both packages).

The LM corpus is a Zipf-distributed token stream with induced bigram
structure; `estimation_problem` is the paper's Sec. VII-A workload.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SyntheticLMDataset", "estimation_problem"]


@dataclasses.dataclass
class SyntheticLMDataset:
    """An infinite deterministic token stream with bigram structure.

    tokens[t+1] depends on tokens[t] through a sparse random permutation
    mixture — enough structure that cross-entropy decreases during training.
    """

    vocab_size: int
    seed: int = 0
    zipf_a: float = 1.2

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        ranks = np.arange(1, self.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-self.zipf_a)
        self._unigram = p / p.sum()
        self._perm = rng.permutation(self.vocab_size)

    def batch(self, rng: np.random.Generator, batch: int, seq: int) -> np.ndarray:
        fresh = rng.choice(self.vocab_size, size=(batch, seq), p=self._unigram)
        # 50% of positions follow the deterministic bigram successor of the
        # *realized* previous token (sequential chain, vectorized over batch)
        follow = rng.random((batch, seq)) < 0.5
        out = np.empty((batch, seq), dtype=np.int64)
        out[:, 0] = fresh[:, 0]
        for t in range(1, seq):
            out[:, t] = np.where(follow[:, t], self._perm[out[:, t - 1]],
                                 fresh[:, t])
        return out.astype(np.int32)


def estimation_problem(m: int, d: int = 2, s: int = 3, n_per_agent: int = 100,
                       seed: int = 0):
    """The paper's Sec. VII-A decentralized estimation problem:
    z_ij = M_i theta + w_ij, w ~ U[0,1]."""
    rng = np.random.default_rng(seed)
    theta = rng.normal(size=(d,))
    M = rng.normal(size=(m, s, d))
    Z = (np.einsum("isd,d->is", M, theta)[:, None, :]
         + rng.uniform(0, 1, size=(m, n_per_agent, s)))
    # aggregate least-squares optimum (the U[0,1] noise mean shifts it)
    A = np.einsum("isd,ise->de", M, M) / m
    b = np.einsum("isd,is->d", M, Z.mean(axis=1)) / m
    theta_opt = np.linalg.solve(A, b)
    return {"theta_true": theta, "theta_opt": theta_opt, "M": M.astype(np.float32),
            "Z": Z.astype(np.float32)}
