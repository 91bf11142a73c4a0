"""Zamba2-style hybrid [arXiv:2411.15242] (counterpart of
``repro.models.hybrid``): a deep Mamba2 trunk with *shared* attention
blocks applied after every ``hybrid_attn_every``-th mamba layer,
alternating between ``hybrid_num_shared`` weight-shared block instances
(site k uses block k % hybrid_num_shared).

The mamba blocks are `models.ssm`'s (the SSD through B11 on the card); a
shared block is the dense family's layer (`transformer._layer_train`,
`_layer_prefill`, `_layer_decode`), so prefill attention goes through
`transformer._attn` and B10 on the card.  Decode state: per mamba layer an
ssm state and a conv tail, and one KV cache per attention *site* (weights
are shared, caches are not); decode writes all of them into the caller's
cache IN PLACE (the reference returns a new cache) and returns that same
cache.  In training each mamba block and each shared-attention block is
recomputed in the backward (`common.remat`; the reference's
``jax.checkpoint`` of both bodies, full recompute under either
``remat_policy``): values and gradients are those of the blocks run
without it.

The reference's dtype promotion is kept: from the first mamba block on, a
bf16 model carries an f32 residual stream, so its prefill cache leaves
and logits are f32 (`models.ssm`).
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from .common import (ArrayDef, cross_entropy, decode_cache_valid,
                     decode_positions, layer_views, pad_vocab, remat,
                     rms_norm, rope_tables, rope_tables_at)
from . import ssm
from . import transformer as tfm

__all__ = ["param_defs", "forward_train", "loss_fn", "forward_prefill",
           "forward_decode", "cache_spec"]


def _attn_sites(cfg: ArchConfig) -> list[int]:
    """Mamba layer indices after which a shared attention block runs."""
    return [i for i in range(cfg.num_layers)
            if (i + 1) % cfg.hybrid_attn_every == 0]


def param_defs(cfg: ArchConfig) -> dict:
    d, S = cfg.d_model, cfg.hybrid_num_shared
    shared = {}
    shared.update(tfm._norm_defs(S, d, cfg, "attn_norm"))
    shared.update(tfm._norm_defs(S, d, cfg, "mlp_norm"))
    shared.update(tfm.attn_defs(S, cfg))
    shared.update(tfm.mlp_defs(S, cfg))
    return {
        "embed": ArrayDef((pad_vocab(cfg.vocab_size), d), ("vocab", "embed"),
                          scale=0.02),
        "final_norm_gamma": ArrayDef((d,), ("embed",), init="ones"),
        "mamba": ssm.mamba_defs(cfg.num_layers, cfg),
        "shared": shared,
    }


def _blocks(params: dict, cfg: ArchConfig):
    """(mamba layer params, (site index, shared block params) or None) for
    each mamba layer in order."""
    shared = layer_views(params["shared"])
    sites = {i: k for k, i in enumerate(_attn_sites(cfg))}
    for i, p in enumerate(layer_views(params["mamba"])):
        k = sites.get(i)
        yield p, None if k is None else (k, shared[k % len(shared)])


def _rope(cfg: ArchConfig, S: int, device):
    return rope_tables(S, cfg.head_dim, cfg.rotary_frac, cfg.rope_theta,
                       device)


def forward_train(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """Full-sequence logits (B, S, V_padded)."""
    x = tfm.embed_tokens(params, batch, cfg)
    rope = _rope(cfg, x.shape[1], x.device)
    for p, site in _blocks(params, cfg):
        x = remat(ssm.mamba_block_train, p, x, cfg)
        if site is not None:
            x = remat(tfm._layer_train, site[1], x, rope, cfg)
    return tfm.unembed(params, rms_norm(x, params["final_norm_gamma"]), cfg)


def loss_fn(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    return cross_entropy(forward_train(params, batch, cfg), batch["labels"],
                         cfg.vocab_size)


def forward_prefill(params: dict, batch: dict, cfg: ArchConfig) -> dict:
    """Process a full prompt: ``{"logits": (B, V) of the last position,
    "cache": {"ssm" (L, B, H, P, N) f32, "conv" (L, B, K-1, d_inner + 2N),
    "k", "v" (sites, B, C, KV, hd)}, "pos": S}`` (``pos`` a Python int;
    the KV caches in ring layout).  Each leaf is stacked in the promoted
    dtype of its layers', as the reference's ``jnp.stack``."""
    x = tfm.embed_tokens(params, batch, cfg)
    S = x.shape[1]
    C = tfm.cache_len_for(cfg, S)
    rope = _rope(cfg, S, x.device)
    states = {"ssm": [], "conv": [], "k": [], "v": []}
    for p, site in _blocks(params, cfg):
        x, (h, tail) = ssm.mamba_block_prefill(p, x, cfg)
        states["ssm"].append(h)
        states["conv"].append(tail)
        if site is not None:
            x, k, v = tfm._layer_prefill(site[1], x, rope, cfg, C)
            states["k"].append(k)
            states["v"].append(v)
    logits = tfm.unembed(params, rms_norm(x[:, -1:],
                                          params["final_norm_gamma"]), cfg)
    return {"logits": logits[:, 0],
            "cache": {n: torch.stack(t) for n, t in states.items()},
            "pos": S}


def forward_decode(params: dict, token: torch.Tensor, cache: dict, pos,
                   cfg: ArchConfig) -> dict:
    """One decode step: ``token`` (B,) ids, ``pos`` the absolute position
    of ``token``: a scalar or (B,) integers (continuous batching).  Writes
    every layer's new ssm state and conv tail and every site's new key and
    value into ``cache`` in place (in the cache's dtypes); returns
    ``{"logits": (B, V), "cache": cache, "pos": pos + 1}``.  Nothing here
    waits for the device."""
    x = params["embed"][token.long()][:, None, :]
    B = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device)
    cache_valid = decode_cache_valid(pos, cache["k"].shape[2])
    rope = rope_tables_at(decode_positions(pos, B), cfg.head_dim,
                          cfg.rotary_frac, cfg.rope_theta)
    for i, (p, site) in enumerate(_blocks(params, cfg)):
        h, tail = cache["ssm"][i], cache["conv"][i]
        x, (h_new, tail_new) = ssm.mamba_block_decode(p, x, (h, tail), cfg)
        h.copy_(h_new)
        tail.copy_(tail_new)
        if site is not None:
            k = site[0]
            x = tfm._layer_decode(site[1], x, cache["k"][k], cache["v"][k],
                                  pos, rope, cfg, cache_valid)
    logits = tfm.unembed(params, rms_norm(x, params["final_norm_gamma"]), cfg)
    return {"logits": logits[:, 0], "cache": cache, "pos": pos + 1}


def cache_spec(cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    """(shape, logical, dtype|None) per cache leaf (None: the model's)."""
    C = tfm.cache_len_for(cfg, seq_len)
    n_sites = len(_attn_sites(cfg))
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    kv = (n_sites, batch, C, cfg.num_kv_heads, cfg.head_dim)
    kv_logical = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    return {
        "ssm": ((cfg.num_layers, batch, H, P, N),
                ("layers", "batch", "ssm_heads", None, "state"),
                torch.float32),
        "conv": ((cfg.num_layers, batch, cfg.ssm_conv - 1,
                  cfg.d_inner + 2 * N),
                 ("layers", "batch", "conv", "ssm_heads"), None),
        "k": (kv, kv_logical, None),
        "v": (kv, kv_logical, None),
    }
