"""Mixture-of-Experts FFN (counterpart of ``repro.models.moe``; olmoe 64
experts top-8, granite-moe 32 experts top-8).

Train and prefill: sort-based capacity routing per sequence.  Each token
goes to its top-k experts; the (token, choice) pairs are sorted by expert
id, packed into a fixed (E, C, d) buffer (capacity C = ceil(T k / E) x
capacity_factor, at most T), run through batched expert matmuls and
written back weighted by the router's gates.  A pair past its expert's
capacity is dropped, as in GShard and Switch.  Capacity is per sequence,
so a prefill's padding tokens take capacity as any other token.

Decode (one token): the dense mixture over all experts with the top-k
gates as weights, as the reference computes it; it differs from prefill
wherever prefill drops a pair.

The routing follows the reference's order exactly: ties in the top-k take
the lower expert first (``jax.lax.top_k``'s order, which ``torch.topk``
does not promise: a stable descending sort), both argsorts are stable and
the segment starts come from ``searchsorted`` on the left.  Every index
operation is a gather or a scatter of unique rows (the dropped pairs go to
one discarded row), so forward and backward are deterministic on the card
and capture into a CUDA graph (no host sync, no data-dependent shape).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .common import ArrayDef, einsum_promoted

__all__ = ["moe_defs", "capacity", "top_k", "dispatch", "moe_ffn_train",
           "moe_ffn_decode", "aux_load_balance_loss"]


def moe_defs(L: int, cfg: ArchConfig) -> dict:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": ArrayDef((L, d, E), ("layers", "embed", "experts"),
                           scale=0.02),
        "w_gate": ArrayDef((L, E, d, ff),
                           ("layers", "experts", "embed", "expert_mlp")),
        "w_up": ArrayDef((L, E, d, ff),
                         ("layers", "experts", "embed", "expert_mlp")),
        "w_down": ArrayDef((L, E, ff, d),
                           ("layers", "experts", "expert_mlp", "embed")),
    }


def capacity(T: int, cfg: ArchConfig) -> int:
    """Each expert's slots for a group of T tokens: the reference's Python
    expression, ceil(T k / E) x capacity_factor truncated, in [1, T]."""
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    C = int(-(-T * k // E) * cfg.capacity_factor)
    return max(1, min(C, T))


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest in descending
    order, the lower index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _top_gates(probs: torch.Tensor, k: int):
    """The top k of the router's probabilities, renormalized to sum 1."""
    gates, eidx = top_k(probs, k)
    return gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9), eidx


def _gates(x: torch.Tensor, router: torch.Tensor, k: int):
    """Router softmax in f32 (the logits of x's product, cast), top k."""
    logits = einsum_promoted("bsd,de->bse", x, router).float()
    return _top_gates(torch.softmax(logits, dim=-1), k)


def dispatch(eidx: torch.Tensor, C: int, E: int):
    """Where each (token, choice) pair of B groups goes.  eidx: (B, T, k)
    expert ids.  Returns (order, buf_idx), each (B, T k): ``order`` sorts
    the pairs by expert, stably; sorted pair j of expert e, at position p
    of e's segment, goes to buffer row e C + p if p < C, and to row E C
    (dropped) otherwise."""
    B = eidx.shape[0]
    flat_e = eidx.reshape(B, -1)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(E, device=eidx.device).expand(B, E)
        .contiguous(), right=False)
    pos = torch.arange(flat_e.shape[1], device=eidx.device) - torch.gather(
        seg_start, 1, sorted_e)
    return order, torch.where(pos < C, sorted_e * C + pos, E * C)


def _experts(buf: torch.Tensor, w_gate, w_up, w_down,
             dtype: torch.dtype) -> torch.Tensor:
    """The experts' SwiGLU on (E, N, d) rows: silu in f32, cast back."""
    g = einsum_promoted("end,edf->enf", buf, w_gate)
    u = einsum_promoted("end,edf->enf", buf, w_up)
    h = F.silu(g.float()).to(dtype) * u
    return einsum_promoted("enf,efd->end", h, w_down)


def _route(x: torch.Tensor, gates: torch.Tensor, eidx: torch.Tensor,
           pl: dict, cfg: ArchConfig) -> torch.Tensor:
    """The reference's ``_route_group`` on each of B groups at once.
    x: (B, T, d); gates, eidx: (B, T, k).  Returns (B, T, d)."""
    B, T, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    C = capacity(T, cfg)
    # a dropped pair goes to row E*C, past the experts' rows, and is
    # discarded (the reference's out-of-bounds write with mode="drop")
    order, buf_idx = dispatch(eidx, C, E)
    # each token's row repeated k times, then permuted: a unique gather
    x_rep = x[:, :, None, :].expand(B, T, k, d).reshape(B, T * k, d)
    x_sorted = torch.gather(x_rep, 1, order[..., None].expand(-1, -1, d))
    buf = x.new_zeros((B, E * C + 1, d)).scatter(
        1, buf_idx[..., None].expand(-1, -1, d), x_sorted)
    buf = buf[:, :E * C].reshape(B, E, C, d).transpose(0, 1)
    y = _experts(buf.reshape(E, B * C, d), pl["w_gate"], pl["w_up"],
                 pl["w_down"], x.dtype)
    y = y.reshape(E, B, C, d).transpose(0, 1).reshape(B, E * C, d)
    # a dropped pair reads the appended zero row
    y = torch.cat([y, y.new_zeros((B, 1, d))], dim=1)
    inv = torch.argsort(order, dim=-1, stable=True)
    src = torch.gather(buf_idx, 1, inv)
    y_flat = torch.gather(y, 1, src[..., None].expand(-1, -1, d))
    return einsum_promoted("btkd,btk->btd", y_flat.reshape(B, T, k, d),
                           gates.to(x.dtype))


def _route_group(x: torch.Tensor, probs: torch.Tensor, w_gate, w_up, w_down,
                 cfg: ArchConfig) -> torch.Tensor:
    """The reference's entry for one group: x (T, d), probs (T, E)."""
    gates, eidx = _top_gates(probs, cfg.num_experts_per_tok)
    pl = {"w_gate": w_gate, "w_up": w_up, "w_down": w_down}
    return _route(x[None], gates[None], eidx[None], pl, cfg)[0]


def moe_ffn_train(pl: dict, x: torch.Tensor, cfg: ArchConfig,
                  mesh=None) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d); each sequence is a routing group.
    ``moe_impl="deferred"`` is the reference's shard_map combine over a
    mesh's tensor-parallel axis; without a mesh both impls are this
    path."""
    if cfg.moe_impl == "deferred" and mesh is not None:
        raise NotImplementedError(
            "moe_impl='deferred' over a mesh waits for the distributed port "
            "(ROADMAP item 7)")
    gates, eidx = _gates(x, pl["router"], cfg.num_experts_per_tok)
    return _route(x, gates, eidx, pl, cfg)


def moe_ffn_decode(pl: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x: (B, 1, d): every expert on every token, mixed with the top-k
    gates (zero for the other experts)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    gates, eidx = _gates(x, pl["router"], k)
    mask = (F.one_hot(eidx, E).to(gates.dtype) * gates[..., None]).sum(-2)
    xe = x.reshape(1, B * S, d).expand(E, B * S, d)
    y = _experts(xe, pl["w_gate"], pl["w_up"], pl["w_down"], x.dtype)
    y = y.reshape(E, B, S, d)
    return einsum_promoted("ebsd,bse->bsd", y, mask.to(x.dtype))


def aux_load_balance_loss(logits: torch.Tensor, eidx: torch.Tensor,
                          num_experts: int) -> torch.Tensor:
    """Switch-style load-balance auxiliary (the reference's; no trainer
    of either package adds it to the loss)."""
    probs = torch.softmax(logits.float(), dim=-1)
    me = probs.mean(dim=tuple(range(probs.ndim - 1)))
    one_hot = F.one_hot(eidx.long(), num_experts).float()
    ce = one_hot.mean(dim=tuple(range(one_hot.ndim - 1)))
    return num_experts * torch.sum(me * ce.sum(0) if ce.ndim > 1
                                   else me * ce)
