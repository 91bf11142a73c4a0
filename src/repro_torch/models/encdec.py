"""Encoder-decoder backbone, the audio family (seamless-m4t-medium
[arXiv:2308.11596]; counterpart of ``repro.models.encdec``).

The modality frontend (mel spectrogram + conv feature extractor) is a
stub: ``batch["frames"]`` carries precomputed frame embeddings (B, S_enc,
d), to which a fixed sinusoidal table is added.  The encoder
(bidirectional self-attention) and the decoder (causal self-attention,
cross-attention over the encoder's output, then the MLP) are real.

Parameters: ``embed``, the final norm, and the ``encoder`` and
``decoder`` subtrees of (L, ...) stacked leaves with the reference's
names and shapes (the decoder adds ``cross_norm_*`` and ``xq``, ``xk``,
``xv``, ``xo``), so the reference's weights load unchanged
(`repro_torch.convert`).  The layers run in an unrolled Python loop; in
training each encoder and decoder layer is recomputed in the backward
(`common.remat`; the reference's per-layer ``jax.checkpoint``, full
recompute under either ``remat_policy``): values and gradients are those
of the layers run without it.

Attention.  In a prefill on a CUDA tensor the encoder's self-attention
runs the flash-attention kernel B10 non-causal and the decoder's causal
(`transformer._attn`); on the CPU, and in training (B10 is forward-only),
the plain `attention` (`chunked_attention` under ``attn_impl =
"chunked"``).  Cross-attention is always plain: its keys are the
encoder's S_enc frames against S decoder queries, a shape B10 does not
take; with ``cross_attn_window`` set each decoder position t attends only
to the frames within ``window // 2`` of t scaled to the encoder's length
(a local monotonic window).  Decode writes the self-attention cache in
place; the cross-attention keys and values (``xk``, ``xv``), computed
once from the encoder's output in prefill, are read only.
"""
from __future__ import annotations

import math

import torch

from ..configs.base import ArchConfig
from . import transformer as tfm
from .common import (ArrayDef, attention, cross_entropy, decode_attention,
                     decode_cache_valid, decode_positions, einsum_promoted,
                     layer_views, pad_vocab, remat, ring_buffer_write,
                     rope_tables, rope_tables_at)

__all__ = ["param_defs", "encode", "forward_train", "loss_fn",
           "forward_prefill", "forward_decode", "cache_spec"]


def _cross_defs(L: int, cfg: ArchConfig) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "xq": ArrayDef((L, d, H, hd), ("layers", "embed", "heads", "head_dim")),
        "xk": ArrayDef((L, d, KV, hd),
                       ("layers", "embed", "kv_heads", "head_dim")),
        "xv": ArrayDef((L, d, KV, hd),
                       ("layers", "embed", "kv_heads", "head_dim")),
        "xo": ArrayDef((L, H, hd, d), ("layers", "heads", "head_dim", "embed"),
                       scale=1.0 / (H * hd) ** 0.5),
    }


def param_defs(cfg: ArchConfig) -> dict:
    d, Le, Ld = cfg.d_model, cfg.num_encoder_layers, cfg.num_layers
    enc = {}
    enc.update(tfm._norm_defs(Le, d, cfg, "attn_norm"))
    enc.update(tfm._norm_defs(Le, d, cfg, "mlp_norm"))
    enc.update(tfm.attn_defs(Le, cfg))
    enc.update(tfm.mlp_defs(Le, cfg))
    dec = {}
    dec.update(tfm._norm_defs(Ld, d, cfg, "attn_norm"))
    dec.update(tfm._norm_defs(Ld, d, cfg, "cross_norm"))
    dec.update(tfm._norm_defs(Ld, d, cfg, "mlp_norm"))
    dec.update(tfm.attn_defs(Ld, cfg))
    dec.update(_cross_defs(Ld, cfg))
    dec.update(tfm.mlp_defs(Ld, cfg))
    defs = {
        "embed": ArrayDef((pad_vocab(cfg.vocab_size), d), ("vocab", "embed"),
                          scale=0.02),
        "final_norm_gamma": ArrayDef((d,), ("embed",), init="ones"),
        "encoder": enc,
        "decoder": dec,
    }
    if cfg.norm == "layernorm":
        defs["final_norm_beta"] = ArrayDef((d,), ("embed",), init="zeros")
    return defs


def _norm(p: dict, x: torch.Tensor, name: str, cfg: ArchConfig):
    return tfm._norm(x, p[f"{name}_gamma"], p.get(f"{name}_beta"), cfg)


def _rope(S: int, cfg: ArchConfig, device):
    return rope_tables(S, cfg.head_dim, cfg.rotary_frac, cfg.rope_theta,
                       device)


def _sinusoidal_positions(S: int, d: int, dtype, device) -> torch.Tensor:
    """Fixed sinusoidal table (S, d), in f32 and cast to ``dtype``: the
    positional structure the stubbed conv frontend would carry (a
    position-free, feature-constant input would zero every layernorm
    variance)."""
    half = d // 2
    f32 = dict(dtype=torch.float32, device=device)
    pos = torch.arange(S, **f32)[:, None]
    freq = torch.exp(-torch.arange(half, **f32)
                     * (math.log(10000.0) / max(half - 1, 1)))
    ang = pos * freq[None, :]
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    if emb.shape[-1] < d:
        emb = torch.nn.functional.pad(emb, (0, d - emb.shape[-1]))
    return emb.to(dtype)


def _enc_layer(p: dict, x: torch.Tensor, rope, cfg: ArchConfig,
               kernel: bool) -> torch.Tensor:
    """One bidirectional encoder layer; ``kernel``: the self-attention
    through `transformer._attn` (B10 non-causal on a CUDA tensor), else
    `transformer._plain_attn` (training)."""
    h = _norm(p, x, "attn_norm", cfg)
    q, k, v = tfm._qkv(p, h, rope)
    attn = tfm._attn if kernel else tfm._plain_attn
    o = attn(q, k, v, None, cfg, causal=False)
    x = x + einsum_promoted("bshk,hkd->bsd", o, p["wo"])
    return tfm._mlp_block(p, x, cfg)


def encode(params: dict, frames: torch.Tensor, cfg: ArchConfig,
           kernel: bool = True) -> torch.Tensor:
    """The encoder's output (B, S_enc, d) for ``frames`` (B, S_enc, d)."""
    B, S, d = frames.shape
    x = frames + _sinusoidal_positions(S, d, frames.dtype,
                                       frames.device)[None]
    rope = _rope(S, cfg, x.device)
    for p in layer_views(params["encoder"]):
        x = remat(_enc_layer, p, x, rope, cfg, kernel)
    return x


def _windowed_cross(q, k, v, window: int, dtype) -> torch.Tensor:
    """Cross-attention with the local monotonic window: query t (of Sq)
    attends to the frames s (of S_enc) with |s - t S_enc / Sq| <= window
    // 2, the positions and the scale in f32 as the reference's."""
    B, Sq, H, hd = q.shape
    S_enc, KV = k.shape[1], k.shape[2]
    f32 = dict(dtype=torch.float32, device=q.device)
    qpos = (torch.arange(Sq, **f32) * torch.tensor(
        S_enc / max(Sq, 1), **f32))[:, None]
    kpos = torch.arange(S_enc, **f32)[None, :]
    mask = (kpos - qpos).abs() <= window // 2
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    logits = einsum_promoted("bqkgd,bskd->bkgqs", qg, k).float()
    logits = logits / math.sqrt(hd)
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(dtype)
    o = einsum_promoted("bkgqs,bskd->bqkgd", probs, v)
    return o.reshape(B, Sq, H, hd)


def _cross_attend(p: dict, x: torch.Tensor, enc_out: torch.Tensor,
                  cfg: ArchConfig):
    """x + cross-attention over ``enc_out``; also returns the layer's
    cross keys and values (the decode cache's ``xk``, ``xv``)."""
    h = _norm(p, x, "cross_norm", cfg)
    q = einsum_promoted("bsd,dhk->bshk", h, p["xq"])
    k = einsum_promoted("bsd,dhk->bshk", enc_out, p["xk"])
    v = einsum_promoted("bsd,dhk->bshk", enc_out, p["xv"])
    if cfg.cross_attn_window is not None:
        o = _windowed_cross(q, k, v, cfg.cross_attn_window, x.dtype)
    else:
        o = attention(q, k, v, causal=False)
    return x + einsum_promoted("bshk,hkd->bsd", o, p["xo"]), k, v


def _dec_layer(p: dict, x: torch.Tensor, enc_out: torch.Tensor, rope,
               cfg: ArchConfig, kernel: bool):
    """One decoder layer: causal self-attention (``kernel``: B10 on a CUDA
    tensor), cross-attention, MLP.  Returns (x, k, v, xk, xv)."""
    h = _norm(p, x, "attn_norm", cfg)
    q, k, v = tfm._qkv(p, h, rope)
    attn = tfm._attn if kernel else tfm._plain_attn
    o = attn(q, k, v, cfg.attn_window, cfg)
    x = x + einsum_promoted("bshk,hkd->bsd", o, p["wo"])
    x, xk, xv = _cross_attend(p, x, enc_out, cfg)
    return tfm._mlp_block(p, x, cfg), k, v, xk, xv


def _dec_layer_train(p: dict, x: torch.Tensor, enc_out: torch.Tensor, rope,
                     cfg: ArchConfig) -> torch.Tensor:
    """A training decoder layer's output (the plain self-attention)."""
    return _dec_layer(p, x, enc_out, rope, cfg, kernel=False)[0]


def forward_train(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """Full-sequence logits (B, S, V_padded) of ``batch["tokens"]`` given
    ``batch["frames"]``."""
    enc_out = encode(params, batch["frames"], cfg, kernel=False)
    x = params["embed"][batch["tokens"].long()]
    rope = _rope(x.shape[1], cfg, x.device)
    for p in layer_views(params["decoder"]):
        x = remat(_dec_layer_train, p, x, enc_out, rope, cfg)
    return tfm.unembed(params, tfm._final_norm(params, x, cfg), cfg)


def loss_fn(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    logits = forward_train(params, batch, cfg)
    return cross_entropy(logits, batch["labels"], cfg.vocab_size)


def forward_prefill(params: dict, batch: dict, cfg: ArchConfig) -> dict:
    """Encode the frames and prefill the decoder over the prompt:
    ``{"logits": (B, V) of the last position, "cache": {"k", "v"} each
    (L, B, C, KV, hd) in ring layout and {"xk", "xv"} each (L, B, S_enc,
    KV, hd), "pos": S}`` (``pos`` a Python int)."""
    enc_out = encode(params, batch["frames"], cfg)
    x = params["embed"][batch["tokens"].long()]
    B, S, _ = x.shape
    S_enc = enc_out.shape[1]
    C = tfm.cache_len_for(cfg, S)
    rope = _rope(S, cfg, x.device)
    L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    like = dict(dtype=x.dtype, device=x.device)
    cache = {"k": torch.empty((L, B, C, KV, hd), **like),
             "v": torch.empty((L, B, C, KV, hd), **like),
             "xk": torch.empty((L, B, S_enc, KV, hd), **like),
             "xv": torch.empty((L, B, S_enc, KV, hd), **like)}
    shift = S % C
    for i, p in enumerate(layer_views(params["decoder"])):
        x, k, v, cache["xk"][i], cache["xv"][i] = _dec_layer(
            p, x, enc_out, rope, cfg, kernel=True)
        if C == S:
            cache["k"][i], cache["v"][i] = k, v
        else:
            cache["k"][i] = torch.roll(k[:, -C:], shift, dims=1)
            cache["v"][i] = torch.roll(v[:, -C:], shift, dims=1)
    logits = tfm.unembed(params, tfm._final_norm(params, x[:, -1:], cfg), cfg)
    return {"logits": logits[:, 0], "cache": cache, "pos": S}


def _cross_decode_attention(q, k_cache, v_cache, valid) -> torch.Tensor:
    """One-token cross-attention (no self term).  q: (B, 1, H, hd); caches
    (B, S_enc, KV, hd); valid (S_enc,) or per-slot (B, S_enc) bool."""
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    qg = q.reshape(B, 1, KV, H // KV, hd)
    logits = einsum_promoted("bqkgd,bskd->bkgqs", qg, k_cache).float()
    logits = logits / math.sqrt(hd)
    valid = (valid[None, None, None, None, :] if valid.dim() == 1
             else valid[:, None, None, None, :])
    logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = einsum_promoted("bkgqs,bskd->bqkgd", probs, v_cache)
    return out.reshape(B, 1, H, hd)


def _cross_valid(pos: torch.Tensor, S_enc: int, C: int,
                 cfg: ArchConfig) -> torch.Tensor:
    """The frames a decode token at ``pos`` (scalar or (B,)) attends to:
    every one, or with ``cross_attn_window`` those within window // 2 of
    pos S_enc // C."""
    if cfg.cross_attn_window is None:
        return torch.ones((S_enc,), dtype=torch.bool, device=pos.device)
    kpos = torch.arange(S_enc, device=pos.device)
    center = torch.clamp((pos.long() * S_enc) // max(C, 1), 0, S_enc - 1)
    half = cfg.cross_attn_window // 2
    if pos.dim() == 0:
        return (kpos - center).abs() <= half
    return (kpos[None, :] - center[:, None]).abs() <= half


def forward_decode(params: dict, token: torch.Tensor, cache: dict, pos,
                   cfg: ArchConfig) -> dict:
    """One decode step: ``token`` (B,) ids at absolute position ``pos`` (a
    scalar, or (B,) per-slot positions).  Writes the self-attention keys
    and values into ``cache`` in place; returns ``{"logits": (B, V),
    "cache": cache, "pos": pos + 1}``."""
    x = params["embed"][token.long()][:, None, :]
    B = x.shape[0]
    C, S_enc = cache["k"].shape[2], cache["xk"].shape[2]
    pos = torch.as_tensor(pos, device=x.device)
    cache_valid = decode_cache_valid(pos, C)
    xvalid = _cross_valid(pos, S_enc, C, cfg)
    rope = rope_tables_at(decode_positions(pos, B), cfg.head_dim,
                          cfg.rotary_frac, cfg.rope_theta)
    for i, p in enumerate(layer_views(params["decoder"])):
        h = _norm(p, x, "attn_norm", cfg)
        q, k, v = tfm._qkv(p, h, rope)
        o = decode_attention(q, k, v, cache["k"][i], cache["v"][i],
                             cache_valid)
        x = x + einsum_promoted("bshk,hkd->bsd", o, p["wo"])
        qx = einsum_promoted("bsd,dhk->bshk", _norm(p, x, "cross_norm", cfg),
                             p["xq"])
        ox = _cross_decode_attention(qx, cache["xk"][i], cache["xv"][i],
                                     xvalid)
        x = x + einsum_promoted("bshk,hkd->bsd", ox, p["xo"])
        x = tfm._mlp_block(p, x, cfg, decode=True)
        ring_buffer_write(cache["k"][i], k, pos)
        ring_buffer_write(cache["v"][i], v, pos)
    logits = tfm.unembed(params, tfm._final_norm(params, x, cfg), cfg)
    return {"logits": logits[:, 0], "cache": cache, "pos": pos + 1}


def cache_spec(cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    """(shape, logical, dtype|None) per cache leaf; the encoder length
    follows the target length, capped for long contexts (the
    reference's)."""
    C = tfm.cache_len_for(cfg, seq_len)
    L = cfg.num_layers
    S_enc = min(seq_len, 32_768 if cfg.cross_attn_window is None
                else cfg.cross_attn_window * 8)
    kv = (L, batch, C, cfg.num_kv_heads, cfg.head_dim)
    xkv = (L, batch, S_enc, cfg.num_kv_heads, cfg.head_dim)
    log = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    return {"k": (kv, log, None), "v": (kv, log, None),
            "xk": (xkv, log, None), "xv": (xkv, log, None)}
