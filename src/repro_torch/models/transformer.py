"""Decoder-only transformer LM, dense family (counterpart of
``repro.models.transformer``): ``param_defs``, ``forward_train`` and
``loss_fn``.

Parameters are a nested dict with the reference's leaf names and shapes —
layer weights stacked on a leading (L,) axis, e.g. ``layers/wq`` is
(L, d, H, hd) — so the reference's weights load unchanged
(`repro_torch.convert`).  The layers run in an unrolled Python loop with
no recomputation (the reference's per-layer remat changes memory, not
values).
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from .common import (ArrayDef, apply_rope, attention, cross_entropy,
                     layer_norm, pad_vocab, rms_norm, rope_tables, swiglu)

__all__ = ["param_defs", "forward_train", "loss_fn"]


def _norm_defs(L: int, d: int, cfg: ArchConfig, name: str) -> dict:
    shape, log = (L, d), ("layers", "embed")
    out = {f"{name}_gamma": ArrayDef(shape, log, init="ones")}
    if cfg.norm == "layernorm":
        out[f"{name}_beta"] = ArrayDef(shape, log, init="zeros")
    return out


def param_defs(cfg: ArchConfig) -> dict:
    if cfg.mlp != "swiglu":
        raise ValueError(f"mlp {cfg.mlp!r} is not ported; only 'swiglu' is")
    L, d, H, KV, hd, ff = (cfg.num_layers, cfg.d_model, cfg.num_heads,
                           cfg.num_kv_heads, cfg.head_dim, cfg.d_ff)
    V = pad_vocab(cfg.vocab_size)
    layers = {}
    layers.update(_norm_defs(L, d, cfg, "attn_norm"))
    layers.update(_norm_defs(L, d, cfg, "mlp_norm"))
    layers.update({
        "wq": ArrayDef((L, d, H, hd), ("layers", "embed", "heads", "head_dim")),
        "wk": ArrayDef((L, d, KV, hd),
                       ("layers", "embed", "kv_heads", "head_dim")),
        "wv": ArrayDef((L, d, KV, hd),
                       ("layers", "embed", "kv_heads", "head_dim")),
        "wo": ArrayDef((L, H, hd, d), ("layers", "heads", "head_dim", "embed"),
                       scale=1.0 / (H * hd) ** 0.5),
        "w_gate": ArrayDef((L, d, ff), ("layers", "embed", "mlp")),
        "w_up": ArrayDef((L, d, ff), ("layers", "embed", "mlp")),
        "w_down": ArrayDef((L, ff, d), ("layers", "mlp", "embed")),
    })
    defs = {
        "embed": ArrayDef((V, d), ("vocab", "embed"), scale=0.02),
        "final_norm_gamma": ArrayDef((d,), ("embed",), init="ones"),
        "layers": layers,
    }
    if cfg.norm == "layernorm":
        defs["final_norm_beta"] = ArrayDef((d,), ("embed",), init="zeros")
    if not cfg.tie_embeddings:
        defs["unembed"] = ArrayDef((d, V), ("embed", "vocab"), scale=0.02)
    return defs


def _norm(x, gamma, beta, cfg: ArchConfig):
    if cfg.norm == "layernorm":
        return layer_norm(x, gamma, beta)
    return rms_norm(x, gamma)


def _layer_train(p: dict, x: torch.Tensor, rope, cfg: ArchConfig):
    """One layer; ``p`` holds this layer's slices of the stacked leaves,
    ``rope`` the (cos, sin) tables of the sequence."""
    h = _norm(x, p["attn_norm_gamma"], p.get("attn_norm_beta"), cfg)
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", h, p["wv"])
    q = apply_rope(q, *rope)
    k = apply_rope(k, *rope)
    o = attention(q, k, v, causal=True, window=cfg.attn_window)
    x = x + torch.einsum("bshk,hkd->bsd", o, p["wo"])
    h = _norm(x, p["mlp_norm_gamma"], p.get("mlp_norm_beta"), cfg)
    return x + swiglu(h, p["w_gate"], p["w_up"], p["w_down"])


def forward_train(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """Full-sequence logits (B, S, V_padded)."""
    x = params["embed"][batch["tokens"].long()]
    # One unbind per stacked leaf, not one index per layer: the backward of
    # ``leaf[i]`` writes a zero tensor of the whole (L, ...) leaf per layer
    # and adds them up; unbind's backward stacks the L slices once.
    layers = {name: leaf.unbind(0) for name, leaf in params["layers"].items()}
    rope = rope_tables(x.shape[1], cfg.head_dim, cfg.rotary_frac,
                       cfg.rope_theta, x.device)
    for i in range(cfg.num_layers):
        x = _layer_train({name: s[i] for name, s in layers.items()}, x,
                         rope, cfg)
    x = _norm(x, params["final_norm_gamma"], params.get("final_norm_beta"),
              cfg)
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params["embed"])
    return torch.einsum("bsd,dv->bsv", x, params["unembed"])


def loss_fn(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    logits = forward_train(params, batch, cfg)
    return cross_entropy(logits, batch["labels"], cfg.vocab_size)

