"""What a neighbour-average rejoin leaks, measured (counterpart of
``repro.faults.audit``).

The ``rejoin='neighbor-avg'`` warm start has every stable neighbour j of
a rejoining agent i send its raw state x_j in the clear for one step: the
conventional-DSGD wire of `privacy.observe.broadcast_messages` on the
rejoin links.  An eavesdropper on those links recovers each x_j exactly,
where the ordinary PDSGD wire on the same links leaves the (b_ij / w_ij)
u_j residual that Theorem 5's guarantees ride on.  This module computes
both from a realization.
"""
from __future__ import annotations

import torch

from ..privacy import observe as O

__all__ = ["rejoin_links", "rejoin_leakage_report"]


def rejoin_links(mask: torch.Tensor, alive: torch.Tensor,
                 alive_prev: torch.Tensor) -> torch.Tensor:
    """(m, m) 0/1: (i, j) is 1 iff stable neighbour j sends its state to
    rejoining agent i this step over a realized link."""
    rejoin = alive * (1.0 - alive_prev)
    stable = alive * alive_prev
    return mask * (rejoin[:, None] * stable[None, :])


def rejoin_leakage_report(*, params, u, W: torch.Tensor, B: torch.Tensor,
                          mask: torch.Tensor, alive: torch.Tensor,
                          alive_prev: torch.Tensor) -> dict:
    """The eavesdropper's recovery error of each broadcast x_j under the
    two wire models, on this step's rejoin links: ``broadcast_mse`` (the
    warm start's wire is x_j: 0) and ``pdsgd_wire_mse`` (the masked wire
    v_ij = w_ij x_j - b_ij u_j inverted by x̂_j = v_ij / w_ij), with
    ``links``, the number of broadcasts; 0-d tensors."""
    links = rejoin_links(mask, alive, alive_prev)
    x_flat = O.flatten_agents(params)
    u_flat = O.flatten_agents(u)
    n = links.sum()

    V_bc = O.broadcast_messages(x_flat, links)
    err_bc = (V_bc - links[:, :, None] * x_flat[None, :, :]) ** 2

    V_pd = O.wire_messages(W, B, x_flat, u_flat) * links[:, :, None]
    w_safe = torch.where(W > 0, W, torch.ones_like(W))
    est = V_pd / w_safe[:, :, None]
    err_pd = ((est - x_flat[None, :, :]) ** 2) * links[:, :, None]

    d = float(x_flat.shape[1])
    denom = torch.clamp_min(n, 1.0) * d
    return {"links": n, "broadcast_mse": err_bc.sum() / denom,
            "pdsgd_wire_mse": err_pd.sum() / denom}
