"""xLSTM-125M [arXiv:2405.04517]: alternating mLSTM / sLSTM blocks
(counterpart of ``repro.models.xlstm``).

mLSTM (matrix memory) is a per-head-decay SSD: ``ssm.ssd_chunked`` with
log-decay log sigmoid(f~) and input gate exp(min(i~, 8)), heads folded
into B11's chunk axis; the normalizer n_t is the same recurrence with
P = 1.  sLSTM (scalar memory) is a recurrence over time, a Python loop of
a few ops a token: one batched matmul over the heads, the four gates
sliced from one pre-activation tensor.

The reference's dtype promotion is kept: its einsums of f32 activations
with bf16 weights compute in f32, so from the first mLSTM block on a bf16
model carries an f32 residual stream (`_mm`).  Decode writes each block's
new state into the caller's cache IN PLACE (the reference returns a new
cache) and returns that same cache.  In training each block is
recomputed in the backward (`common.remat`; the reference's per-block
``jax.checkpoint``, full recompute under either ``remat_policy``):
values and gradients are those of the blocks run without it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .common import (ArrayDef, cross_entropy, layer_views, pad_vocab, remat,
                     rms_norm)
from .common import einsum_promoted as _mm
from .ssm import ssd_chunked
from .transformer import embed_tokens, unembed

__all__ = ["param_defs", "forward_train", "loss_fn", "forward_prefill",
           "forward_decode", "cache_spec", "mlstm_block", "slstm_block",
           "slstm_cell_step", "ICAP"]

ICAP = 8.0  # input-gate exp cap


def _dims(cfg: ArchConfig):
    din = 2 * cfg.d_model  # mLSTM up-projection factor 2
    return din, cfg.num_heads, din // cfg.num_heads


def _is_slstm(cfg: ArchConfig, i: int) -> bool:
    return i % cfg.slstm_every == 1  # blocks 1, 3, 5, ... are sLSTM


def _counts(cfg: ArchConfig) -> tuple[int, int]:
    n_m = sum(1 for i in range(cfg.num_layers) if not _is_slstm(cfg, i))
    return n_m, cfg.num_layers - n_m


def mlstm_defs(L: int, cfg: ArchConfig) -> dict:
    d = cfg.d_model
    din, H, _ = _dims(cfg)
    return {
        "norm_gamma": ArrayDef((L, d), ("layers", "embed"), init="ones"),
        "w_gate": ArrayDef((L, d, din), ("layers", "embed", "ssm_heads")),
        "w_q": ArrayDef((L, d, din), ("layers", "embed", "ssm_heads")),
        "w_k": ArrayDef((L, d, din), ("layers", "embed", "ssm_heads")),
        "w_v": ArrayDef((L, d, din), ("layers", "embed", "ssm_heads")),
        "w_i": ArrayDef((L, d, H), ("layers", "embed", "heads")),
        "w_f": ArrayDef((L, d, H), ("layers", "embed", "heads")),
        "b_f": ArrayDef((L, H), ("layers", "heads"), init="ones"),
        "out_norm": ArrayDef((L, din), ("layers", "ssm_heads"), init="ones"),
        "w_down": ArrayDef((L, din, d), ("layers", "ssm_heads", "embed")),
    }


def slstm_defs(L: int, cfg: ArchConfig) -> dict:
    d, H = cfg.d_model, cfg.num_heads
    Ph = d // H
    return {
        "norm_gamma": ArrayDef((L, d), ("layers", "embed"), init="ones"),
        "w_gates": ArrayDef((L, d, 4 * d), ("layers", "embed", "mlp")),
        "r_gates": ArrayDef((L, H, Ph, 4 * Ph),
                            ("layers", "heads", None, None), scale=0.05),
        "b_gates": ArrayDef((L, 4 * d), ("layers", "mlp"), init="zeros"),
        "w_down": ArrayDef((L, d, d), ("layers", "mlp", "embed")),
    }


def param_defs(cfg: ArchConfig) -> dict:
    n_m, n_s = _counts(cfg)
    return {
        "embed": ArrayDef((pad_vocab(cfg.vocab_size), cfg.d_model),
                          ("vocab", "embed"), scale=0.02),
        "final_norm_gamma": ArrayDef((cfg.d_model,), ("embed",),
                                     init="ones"),
        "mlstm": mlstm_defs(n_m, cfg),
        # the reference keeps one sLSTM layer of parameters when there is
        # none (-tiny); it is never used
        "slstm": slstm_defs(max(n_s, 1), cfg),
    }


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm_gates(p: dict, h: torch.Tensor):
    q = _mm("bsd,de->bse", h, p["w_q"])
    k = _mm("bsd,de->bse", h, p["w_k"])
    v = _mm("bsd,de->bse", h, p["w_v"])
    gate = _mm("bsd,de->bse", h, p["w_gate"])
    i_pre = _mm("bsd,dh->bsh", h, p["w_i"]).float()
    f_pre = _mm("bsd,dh->bsh", h, p["w_f"]).float() + p["b_f"].float()
    i_gate = torch.exp(torch.clamp_max(i_pre, ICAP))
    log_f = F.logsigmoid(f_pre)
    return q, k, v, gate, i_gate, log_f


def mlstm_block(p: dict, x: torch.Tensor, cfg: ArchConfig, state=None,
                return_state: bool = False):
    """state = (C (B, H, P, N) f32, n (B, H, 1, N) f32) or None."""
    B, S, _ = x.shape
    din, H, Ph = _dims(cfg)
    h = rms_norm(x, p["norm_gamma"])
    q, k, v, gate, i_gate, log_f = _mlstm_gates(p, h)
    qh = q.reshape(B, S, H, Ph)
    # true division by the scale rounded to k's dtype, as jnp divides by a
    # weakly typed Python float (on a CUDA tensor a Python-scalar divisor
    # would become a multiply by its reciprocal)
    kh = k.reshape(B, S, H, Ph) / torch.full((), Ph ** 0.5, dtype=k.dtype,
                                             device=k.device)
    vh = v.reshape(B, S, H, Ph)
    C0, n0 = state if state is not None else (None, None)
    y, C_f = ssd_chunked(vh, i_gate, None, kh, qh, None, C0, log_decay=log_f)
    ones = torch.ones((B, S, H, 1), dtype=vh.dtype, device=vh.device)
    nrm, n_f = ssd_chunked(ones, i_gate, None, kh, qh, None, n0,
                           log_decay=log_f)
    y = y / (nrm.abs() + 1.0)
    y = rms_norm(y.reshape(B, S, din), p["out_norm"])
    y = y * F.silu(gate.float()).to(y.dtype)
    out = x + _mm("bse,ed->bsd", y, p["w_down"])
    if return_state:
        return out, (C_f, n_f)
    return out


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_cell_step(r_gates: torch.Tensor, pre_in: torch.Tensor, hc):
    """One step in head-major layout.  r_gates (H, Ph, 4 Ph) f32; pre_in
    (H, B, 4, Ph) f32, the input's gate pre-activations; hc = (h, c, n, m)
    each (H, B, Ph) f32."""
    h, c, n, m = hc
    Hh, B, Ph = h.shape
    pre = pre_in + torch.bmm(h, r_gates).view(Hh, B, 4, Ph)
    z_pre, i_pre, f_pre, o_pre = pre.unbind(2)
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    # stabilized exponential gating
    lf_m = F.logsigmoid(f_pre) + m
    m_new = torch.maximum(lf_m, i_pre)
    i = torch.exp(i_pre - m_new)
    f = torch.exp(lf_m - m_new)
    c_new = f * c + i * z
    n_new = f * n + i
    h_new = o * c_new / torch.clamp_min(n_new.abs(), 1.0)
    return h_new, c_new, n_new, m_new


def slstm_block(p: dict, x: torch.Tensor, cfg: ArchConfig, state=None,
                return_state: bool = False):
    """state = (h, c, n, m) each (B, H, Ph) f32, or None (zeros, m = -10)."""
    B, S, d = x.shape
    H = cfg.num_heads
    Ph = d // H
    hin = rms_norm(x, p["norm_gamma"])
    wx = _mm("bsd,de->bse", hin, p["w_gates"]) + p["b_gates"]
    # (S, H, B, 4, Ph) f32 once, so a step reads one contiguous slice
    pre_in = wx.float().reshape(B, S, 4, H, Ph).permute(1, 3, 0, 2, 4)
    pre_in = pre_in.contiguous()
    if state is None:
        zeros = torch.zeros((H, B, Ph), dtype=torch.float32, device=x.device)
        hc = (zeros, zeros, zeros, zeros - 10.0)
    else:
        hc = tuple(s.transpose(0, 1) for s in state)
    r = p["r_gates"].float()
    hs = []
    for t in range(S):
        hc = slstm_cell_step(r, pre_in[t], hc)
        hs.append(hc[0])
    y = torch.stack(hs, dim=0).permute(2, 0, 1, 3).reshape(B, S, d)
    out = x + _mm("bsd,de->bse", y.to(x.dtype), p["w_down"])
    if return_state:
        return out, tuple(s.transpose(0, 1) for s in hc)
    return out


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def _blocks(params: dict, cfg: ArchConfig):
    """(kind, index within kind, layer params) for each block in order."""
    views = {"mlstm": layer_views(params["mlstm"]),
             "slstm": layer_views(params["slstm"])}
    seen = {"mlstm": 0, "slstm": 0}
    for i in range(cfg.num_layers):
        kind = "slstm" if _is_slstm(cfg, i) else "mlstm"
        idx = seen[kind]
        seen[kind] += 1
        yield kind, idx, views[kind][idx]


_BLOCK = {"mlstm": mlstm_block, "slstm": slstm_block}


def forward_train(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """Full-sequence logits (B, S, V_padded)."""
    x = embed_tokens(params, batch, cfg)
    for kind, _, p in _blocks(params, cfg):
        x = remat(_BLOCK[kind], p, x, cfg)
    return unembed(params, rms_norm(x, params["final_norm_gamma"]), cfg)


def loss_fn(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    return cross_entropy(forward_train(params, batch, cfg), batch["labels"],
                         cfg.vocab_size)


def forward_prefill(params: dict, batch: dict, cfg: ArchConfig) -> dict:
    """Process a full prompt: ``{"logits": (B, V) of the last position,
    "cache": {"mlstm_C", "mlstm_n", "slstm"}, "pos": S}`` (``pos`` a
    Python int; ``slstm`` is (n_s, 4, B, H, Ph), or (0,) without sLSTM
    blocks, as the reference's)."""
    x = embed_tokens(params, batch, cfg)
    states = {"mlstm": [], "slstm": []}
    for kind, _, p in _blocks(params, cfg):
        x, st = _BLOCK[kind](p, x, cfg, return_state=True)
        states[kind].append(st)
    logits = unembed(params, rms_norm(x[:, -1:], params["final_norm_gamma"]),
                     cfg)
    m_states, s_states = states["mlstm"], states["slstm"]
    cache = {
        "mlstm_C": torch.stack([s[0] for s in m_states]),
        "mlstm_n": torch.stack([s[1] for s in m_states]),
        "slstm": (torch.stack([torch.stack(s) for s in s_states]) if s_states
                  else torch.zeros((0,), device=x.device)),
    }
    return {"logits": logits[:, 0], "cache": cache, "pos": x.shape[1]}


def forward_decode(params: dict, token: torch.Tensor, cache: dict, pos,
                   cfg: ArchConfig) -> dict:
    """One decode step: ``token`` (B,) ids; ``pos`` (a scalar or (B,)) is
    only advanced, the recurrent states carry the position.  Writes every
    block's new state into ``cache`` in place; returns ``{"logits": (B, V),
    "cache": cache, "pos": pos + 1}``.  Nothing here waits for the
    device."""
    x = params["embed"][token.long()][:, None, :]
    for kind, idx, p in _blocks(params, cfg):
        if kind == "mlstm":
            C, n = cache["mlstm_C"][idx], cache["mlstm_n"][idx]
            x, (C_new, n_new) = mlstm_block(p, x, cfg, state=(C, n),
                                            return_state=True)
            C.copy_(C_new)
            n.copy_(n_new)
        else:
            slab = cache["slstm"][idx]
            x, st = slstm_block(p, x, cfg, state=tuple(slab.unbind(0)),
                                return_state=True)
            slab.copy_(torch.stack(st))
    logits = unembed(params, rms_norm(x, params["final_norm_gamma"]), cfg)
    return {"logits": logits[:, 0], "cache": cache, "pos": pos + 1}


def cache_spec(cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    """(shape, logical, dtype) per cache leaf; O(1) in ``seq_len``."""
    _, H, Ph = _dims(cfg)
    Ph_s = cfg.d_model // H
    n_m, n_s = _counts(cfg)
    f32 = torch.float32
    return {
        "mlstm_C": ((n_m, batch, H, Ph, Ph),
                    ("layers", "batch", "heads", None, None), f32),
        "mlstm_n": ((n_m, batch, H, 1, Ph),
                    ("layers", "batch", "heads", None, None), f32),
        "slstm": ((n_s, 4, batch, H, Ph_s),
                  ("layers", None, "batch", "heads", None), f32),
    }
