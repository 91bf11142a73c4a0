"""Communication topologies and doubly-stochastic Metropolis mixing
matrices (counterpart of ``repro.core.topology``; numpy only)."""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Topology", "ring", "torus2d", "complete", "star", "erdos_renyi",
           "paper_fig1", "metropolis_weights", "spectral_gap",
           "make_topology"]


@dataclasses.dataclass(frozen=True)
class Topology:
    """A communication graph plus its doubly-stochastic mixing matrix."""

    name: str
    adjacency: np.ndarray  # (m, m) bool, symmetric, True diagonal
    weights: np.ndarray    # (m, m) float64, support == adjacency

    @property
    def num_agents(self) -> int:
        return int(self.adjacency.shape[0])

    @property
    def rho(self) -> float:
        return spectral_gap(self.weights)

    def validate(self) -> None:
        w = self.weights
        if not np.allclose(w.sum(0), 1.0, atol=1e-12):
            raise ValueError(f"{self.name}: W not column-stochastic")
        if not np.allclose(w.sum(1), 1.0, atol=1e-12):
            raise ValueError(f"{self.name}: W not row-stochastic")
        if np.any(np.diag(w) <= 0):
            raise ValueError(f"{self.name}: requires w_ii > 0")
        if np.any((w > 0) != self.adjacency):
            raise ValueError(f"{self.name}: W support differs from adjacency")
        if self.rho >= 1.0:
            raise ValueError(f"{self.name}: rho={self.rho} >= 1 "
                             "(disconnected?)")


def _with_self_loops(adj: np.ndarray) -> np.ndarray:
    adj = adj.astype(bool)
    adj |= adj.T
    np.fill_diagonal(adj, True)
    return adj


def metropolis_weights(adjacency: np.ndarray) -> np.ndarray:
    """w_ij = 1 / (1 + max(deg_i, deg_j)) on edges, w_ii = 1 - sum_j w_ij."""
    adj = _with_self_loops(adjacency)
    m = adj.shape[0]
    deg = adj.sum(1) - 1
    w = np.zeros((m, m), dtype=np.float64)
    for i in range(m):
        for j in range(m):
            if i != j and adj[i, j]:
                w[i, j] = 1.0 / (1.0 + max(deg[i], deg[j]))
        w[i, i] = 1.0 - w[i].sum()
    return w


def spectral_gap(w: np.ndarray) -> float:
    """rho = ||W - 11^T/m||_2 (Assumption 2)."""
    m = w.shape[0]
    return float(np.linalg.norm(w - np.ones((m, m)) / m, 2))


def ring(m: int) -> np.ndarray:
    """Each agent talks to its left and right neighbour (and itself)."""
    if m < 2:
        return np.ones((1, 1), dtype=bool)
    adj = np.zeros((m, m), dtype=bool)
    idx = np.arange(m)
    adj[idx, (idx + 1) % m] = True
    adj[idx, (idx - 1) % m] = True
    return _with_self_loops(adj)


def torus2d(rows: int, cols: int) -> np.ndarray:
    """2D torus of rows*cols agents (degenerates to a ring when rows == 1)."""
    m = rows * cols
    adj = np.zeros((m, m), dtype=bool)
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            if cols > 1:
                adj[i, r * cols + (c + 1) % cols] = True
                adj[i, r * cols + (c - 1) % cols] = True
            if rows > 1:
                adj[i, ((r + 1) % rows) * cols + c] = True
                adj[i, ((r - 1) % rows) * cols + c] = True
    return _with_self_loops(adj)


def complete(m: int) -> np.ndarray:
    return np.ones((m, m), dtype=bool)


def star(m: int) -> np.ndarray:
    adj = np.zeros((m, m), dtype=bool)
    adj[0, :] = True
    adj[:, 0] = True
    return _with_self_loops(adj)


def erdos_renyi(m: int, p: float, seed: int = 0) -> np.ndarray:
    """Random connected G(m, p) graph from ``np.random.default_rng(seed)``
    (redrawn until connected), the reference's draw for draw."""
    rng = np.random.default_rng(seed)
    for _ in range(1000):
        upper = rng.random((m, m)) < p
        adj = _with_self_loops(np.triu(upper, 1))
        if _connected(adj):
            return adj
    raise RuntimeError("could not sample a connected Erdos-Renyi graph")


def _connected(adj: np.ndarray) -> bool:
    m = adj.shape[0]
    seen = {0}
    frontier = [0]
    while frontier:
        i = frontier.pop()
        for j in np.flatnonzero(adj[i]):
            if j not in seen:
                seen.add(int(j))
                frontier.append(int(j))
    return len(seen) == m


def paper_fig1() -> np.ndarray:
    """The 5-agent graph of the paper's Fig. 1: the cycle C5 plus the
    chord (0, 2)."""
    adj = ring(5)
    adj[0, 2] = adj[2, 0] = True
    return _with_self_loops(adj)


_BUILDERS = {
    "ring": lambda m, **kw: ring(m),
    "complete": lambda m, **kw: complete(m),
    "star": lambda m, **kw: star(m),
    "erdos": lambda m, **kw: erdos_renyi(m, kw.get("p", 0.4),
                                         kw.get("seed", 0)),
    "paper_fig1": lambda m, **kw: paper_fig1(),
    "torus": lambda m, **kw: torus2d(kw["rows"], m // kw["rows"]),
}


def make_topology(name: str, m: int, **kwargs) -> Topology:
    """``kwargs``: ``p`` and ``seed`` for ``erdos``, ``rows`` for
    ``torus``; the other graphs ignore them."""
    if name not in _BUILDERS:
        raise KeyError(f"unknown topology {name!r}; have {sorted(_BUILDERS)}")
    adj = _BUILDERS[name](m, **kwargs)
    top = Topology(name=name, adjacency=adj, weights=metropolis_weights(adj))
    top.validate()
    return top
