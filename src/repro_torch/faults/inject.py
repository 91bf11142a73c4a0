"""Degradation and healing mechanics (counterpart of
``repro.faults.inject``), on (m, ...) tensors whose leading axis is the
agent.

Corruption lives at the TRANSMIT side — a corrupt sender poisons what it
puts on the wire, never its own state — and is neutralized at the RECEIVE
side by a per-link finite guard applied to each v_ij before the sum, or
out-voted by coordinate-wise trimmed-mean aggregation.  The diagonal terms
(w_ii x_i, b_ii u_i) never cross a wire and use the clean values.

These are the eager forms: `guarded_gossip_mix` materializes the (m, m,
...) per-link tensor, which is how the reference's unfused path computes
it and what the step's ``eager=True`` oracle uses; the training step runs
the guarded kernel (`kernels.guarded_gossip_update`) instead.
"""
from __future__ import annotations

import torch

from ..kernels.ref import poison_transmit

__all__ = ["poison_transmit", "finite_guard", "guarded_gossip_mix",
           "trimmed_mean_mix", "neighbor_avg_warmstart"]


def _col(vec: torch.Tensor, ndim: int) -> torch.Tensor:
    """An (m,) vector shaped to broadcast over an (m, ...) buffer."""
    return vec.reshape(vec.shape + (1,) * (ndim - 1))


def finite_guard(v: torch.Tensor, clip: float) -> torch.Tensor:
    """Non-finite contributions become exact zeros, finite ones are
    clipped to [-clip, clip].  A clamp passes nan on, so the isfinite
    choice must come first."""
    return torch.where(torch.isfinite(v), torch.clamp(v, -clip, clip),
                       torch.zeros_like(v))


def guarded_gossip_mix(W: torch.Tensor, B: torch.Tensor, x: torch.Tensor,
                       u: torch.Tensor, corrupt: torch.Tensor, *, mode: str,
                       scale: float, clip: float | None) -> torch.Tensor:
    """The eager PDSGD update with per-link receive guards, for one (m,
    ...) leaf:

        x_i' = w_ii x_i - b_ii u_i + sum_{j != i} guard(w_ij xt_j - b_ij ut_j)

    with (xt, ut) the transmits after `poison_transmit`, poisoned in f32
    (the fused path poisons in the buffer's dtype).  ``clip=None``
    disables the guard."""
    m = W.shape[0]
    dev = x.device
    W, B = W.float().to(dev), B.float().to(dev)
    corrupt = corrupt.to(dev)
    eye = torch.eye(m, device=dev)
    w_diag, b_diag = torch.diagonal(W), torch.diagonal(B)
    w_off, b_off = W * (1.0 - eye), B * (1.0 - eye)
    x32, u32 = x.float(), u.float()
    xt = poison_transmit(x32, corrupt, mode, scale)
    ut = poison_transmit(u32, corrupt, mode, scale)
    self_term = _col(w_diag, x.dim()) * x32 - _col(b_diag, x.dim()) * u32
    link = (m, m) + (1,) * (x.dim() - 1)
    v = w_off.reshape(link) * xt[None] - b_off.reshape(link) * ut[None]
    if clip is not None:
        v = finite_guard(v, clip)
    return (self_term + v.sum(dim=1)).to(x.dtype)


def trimmed_mean_mix(x: torch.Tensor, u: torch.Tensor, support: torch.Tensor,
                     corrupt: torch.Tensor, *, trim: int, mode: str,
                     scale: float) -> torch.Tensor:
    """Coordinate-wise trimmed-mean aggregation of one (m, ...) leaf:

        x_i' = TM_trim({x_i} ∪ {xt_j : j in N_i}) - u_i

    Non-neighbours and non-finite transmits are replaced by the agent's
    own value before the sort; ``trim`` entries are dropped at each end
    and the rest averaged.  The descent is the agent's own u_i.  It needs
    the neighbours' raw states on the wire (the conventional-DSGD wire),
    trading the paper's masked wire for robustness."""
    m = support.shape[0]
    if not 0 < trim or m - 2 * trim < 1:
        raise ValueError(
            f"trim must satisfy 1 <= trim and m - 2*trim >= 1; "
            f"got trim={trim}, m={m}")
    dev = x.device
    nb = support.float().to(dev) * (1.0 - torch.eye(m, device=dev))
    x32 = x.float()
    xt = poison_transmit(x32, corrupt.to(dev), mode, scale)
    link = (m, m) + (1,) * (x.dim() - 1)
    use = (nb.reshape(link) > 0) & torch.isfinite(xt)[None]
    cand = torch.where(use, xt[None].expand((m,) + tuple(x.shape)),
                       x32[:, None])
    core = torch.sort(cand, dim=1).values[:, trim:m - trim]
    return (core.mean(dim=1) - u.float()).to(x.dtype)


def neighbor_avg_warmstart(x: torch.Tensor, mask: torch.Tensor,
                           alive: torch.Tensor, alive_prev: torch.Tensor):
    """Warm-start rejoining agents from the average of their stable
    neighbours (up last step and now, over realized links); an agent with
    none holds.  Returns ``(x', rejoin)``, ``rejoin`` the (m,) 0/1
    indicator.  The stable neighbours broadcast x_j in the clear for that
    one step."""
    dev = x.device
    alive, alive_prev = alive.to(dev), alive_prev.to(dev)
    rejoin = alive * (1.0 - alive_prev)
    stable = alive * alive_prev
    recv = mask.float().to(dev) * (rejoin[:, None] * stable[None, :])
    deg = recv.sum(dim=1)
    coef = recv / torch.clamp_min(deg, 1.0)[:, None]
    use = (rejoin > 0) & (deg > 0)
    x32 = x.float()
    avg = (coef @ x32.reshape(x.shape[0], -1)).reshape(x.shape)
    return torch.where(_col(use, x.dim()), avg, x32).to(x.dtype), rejoin
