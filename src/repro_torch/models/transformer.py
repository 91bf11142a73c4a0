"""Decoder-only transformer LM, dense, MoE and VLM families (counterpart
of ``repro.models.transformer``): ``param_defs``, ``forward_train`` and
``loss_fn`` for training; ``forward_prefill``, ``forward_decode``,
``cache_len_for`` and ``cache_spec`` for serving.  A VLM batch's
``prefix_embeds`` (B, P, d) replace the first P token embeddings (a
prompt shorter than P gives a sequence of P), and its loss leaves those
positions out unless the batch brings ``loss_weights``.

Parameters are a nested dict with the reference's leaf names and shapes —
layer weights stacked on a leading (L,) axis, e.g. ``layers/wq`` is
(L, d, H, hd) — so the reference's weights load unchanged
(`repro_torch.convert`).  The layers run in an unrolled Python loop
(``scan_layers`` is accepted and changes nothing here), each layer
recomputed in the backward as the reference's per-layer
``jax.checkpoint`` (`common.remat`, `_layer_remat`): under
``remat_policy="full"`` only each layer's input is kept; under
``"save_collectives"`` also the attention's output projection
(``attn_out``), the one value the reference's
``save_only_these_names("attn_out", "ffn_out")`` keeps as a residual
(the FFN's output feeds only an addition, whose backward needs no
value).  Values and gradients are those of the layers run without it.

Prefill attention on a CUDA tensor runs the hand-written flash-attention
kernel (B10, `kernels.flash_attention`); on the CPU, and in training
(B10 is forward-only), the plain `attention`, or `chunked_attention` when
``attn_impl == "chunked"``.  With ``num_experts`` set the FFN is
`models.moe` (capacity routing in training and prefill, the dense
all-expert mixture in decode).  Decode writes each layer's
new key and value into the caller's cache IN PLACE (the reference returns
a new cache) and returns that same cache.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..kernels.flash_attention import flash_attention
from .common import (ArrayDef, apply_rope, attention, chunked_attention,
                     constrain, cross_entropy, decode_attention, decode_cache_valid,
                     decode_positions, einsum_promoted, gelu_mlp,
                     layer_norm, layer_views, pad_vocab, remat,
                     ring_buffer_write, rms_norm, rope_tables, rope_tables_at,
                     swiglu)
from .moe import moe_defs, moe_ffn_decode, moe_ffn_train

__all__ = ["param_defs", "attn_defs", "mlp_defs", "forward_train",
           "loss_fn", "embed_tokens", "unembed", "cache_len_for",
           "cache_spec", "forward_prefill", "forward_decode"]


def _norm_defs(L: int, d: int, cfg: ArchConfig, name: str) -> dict:
    shape, log = (L, d), ("layers", "embed")
    out = {f"{name}_gamma": ArrayDef(shape, log, init="ones")}
    if cfg.norm == "layernorm":
        out[f"{name}_beta"] = ArrayDef(shape, log, init="zeros")
    return out


def attn_defs(L: int, cfg: ArchConfig) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": ArrayDef((L, d, H, hd), ("layers", "embed", "heads", "head_dim")),
        "wk": ArrayDef((L, d, KV, hd),
                       ("layers", "embed", "kv_heads", "head_dim")),
        "wv": ArrayDef((L, d, KV, hd),
                       ("layers", "embed", "kv_heads", "head_dim")),
        "wo": ArrayDef((L, H, hd, d), ("layers", "heads", "head_dim", "embed"),
                       scale=1.0 / (H * hd) ** 0.5),
    }


def mlp_defs(L: int, cfg: ArchConfig) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    defs = {
        "w_up": ArrayDef((L, d, ff), ("layers", "embed", "mlp")),
        "w_down": ArrayDef((L, ff, d), ("layers", "mlp", "embed")),
    }
    if cfg.mlp == "swiglu":
        defs["w_gate"] = ArrayDef((L, d, ff), ("layers", "embed", "mlp"))
    return defs


def param_defs(cfg: ArchConfig) -> dict:
    L, d = cfg.num_layers, cfg.d_model
    V = pad_vocab(cfg.vocab_size)
    layers = {}
    layers.update(_norm_defs(L, d, cfg, "attn_norm"))
    layers.update(_norm_defs(L, d, cfg, "mlp_norm"))
    layers.update(attn_defs(L, cfg))
    if cfg.num_experts:
        layers["moe"] = moe_defs(L, cfg)
    else:
        layers.update(mlp_defs(L, cfg))
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


def _qkv(p: dict, h: torch.Tensor, rope):
    q = einsum_promoted("bsd,dhk->bshk", h, p["wq"])
    k = einsum_promoted("bsd,dhk->bshk", h, p["wk"])
    v = einsum_promoted("bsd,dhk->bshk", h, p["wv"])
    return apply_rope(q, *rope), apply_rope(k, *rope), v


def _plain_attn(q, k, v, window: int | None,
                cfg: ArchConfig | None = None,
                causal: bool = True) -> torch.Tensor:
    """The reference's ``_attn`` (and, with ``causal=False``, its
    encoder's self-attention): `chunked_attention` when ``cfg.attn_impl ==
    "chunked"``, else `attention` (also with no ``cfg``)."""
    if cfg is not None and cfg.attn_impl == "chunked":
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 chunk=cfg.attn_chunk)
    return attention(q, k, v, causal=causal, window=window)


def _attn(q, k, v, window: int | None, cfg: ArchConfig | None = None,
          causal: bool = True) -> torch.Tensor:
    """Prefill attention: B10 on a CUDA tensor (the blocked kernel, whatever
    ``attn_impl`` says), `_plain_attn` on the CPU.  B10 takes equal head
    counts, as the reference's kernel ("GQA repeat happens outside"): with
    KV < H heads, k and v are repeated along the head axis so that query
    head h reads KV head h // (H / KV), the grouping of `attention` and
    `decode_attention`."""
    if q.device.type != "cuda":
        return _plain_attn(q, k, v, window, cfg, causal)
    group = q.shape[2] // k.shape[2]
    if group > 1:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, window=window)


def _ffn(p: dict, h: torch.Tensor, cfg: ArchConfig, decode: bool):
    if cfg.num_experts:
        if decode:
            return moe_ffn_decode(p["moe"], h, cfg)
        return moe_ffn_train(p["moe"], h, cfg)
    if cfg.mlp == "swiglu":
        return swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
    return gelu_mlp(h, p["w_up"], p["w_down"])


def _mlp_block(p: dict, x: torch.Tensor, cfg: ArchConfig,
               decode: bool = False) -> torch.Tensor:
    h = _norm(x, p["mlp_norm_gamma"], p.get("mlp_norm_beta"), cfg)
    return x + _ffn(p, h, cfg, decode)


def _attn_out(p: dict, x: torch.Tensor, rope, cfg: ArchConfig):
    """A training layer's attention half up to its output projection (the
    reference's ``attn_out``)."""
    h = _norm(x, p["attn_norm_gamma"], p.get("attn_norm_beta"), cfg)
    q, k, v = _qkv(p, h, rope)
    o = _plain_attn(q, k, v, cfg.attn_window, cfg)
    return einsum_promoted("bshk,hkd->bsd", o, p["wo"])


def _ffn_residual(p: dict, x: torch.Tensor, attn_out: torch.Tensor,
                  cfg: ArchConfig):
    """The rest of a training layer: the attention's residual, then the
    MLP block."""
    return _mlp_block(p, x + attn_out, cfg)


def _layer_train(p: dict, x: torch.Tensor, rope, cfg: ArchConfig):
    """One layer; ``p`` holds this layer's slices of the stacked leaves,
    ``rope`` the (cos, sin) tables of the sequence."""
    return _ffn_residual(p, x, _attn_out(p, x, rope, cfg), cfg)


def _layer_remat(p: dict, x: torch.Tensor, rope, cfg: ArchConfig):
    """`_layer_train` recomputed in the backward by ``cfg.remat_policy``:
    one region for "full"; for "save_collectives" two, the attention half
    and the rest, so that ``attn_out`` (the second region's input) is
    kept.  The same operations in the same order either way, so the
    values and the gradients are `_layer_train`'s."""
    if cfg.remat_policy == "save_collectives":
        return remat(_ffn_residual, p, x,
                     remat(_attn_out, p, x, rope, cfg), cfg)
    return remat(_layer_train, p, x, rope, cfg)


def _layer_prefill(p: dict, x: torch.Tensor, rope, cfg: ArchConfig,
                   cache_len: int):
    """Like train (attention through `_attn`), and also the layer's KV
    cache in ring layout: the last ``cache_len`` positions, absolute
    position p at slot p % cache_len (as `ring_buffer_write` keeps it)."""
    S = x.shape[1]
    h = _norm(x, p["attn_norm_gamma"], p.get("attn_norm_beta"), cfg)
    q, k, v = _qkv(p, h, rope)
    o = _attn(q, k, v, cfg.attn_window, cfg)
    x = x + einsum_promoted("bshk,hkd->bsd", o, p["wo"])
    x = _mlp_block(p, x, cfg)
    if cache_len == S:
        return x, k, v
    shift = S % cache_len
    return (x, torch.roll(k[:, -cache_len:], shift, dims=1),
            torch.roll(v[:, -cache_len:], shift, dims=1))


def _layer_decode(p: dict, x: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, pos: torch.Tensor, rope,
                  cfg: ArchConfig, cache_valid: torch.Tensor):
    h = _norm(x, p["attn_norm_gamma"], p.get("attn_norm_beta"), cfg)
    q, k, v = _qkv(p, h, rope)
    o = decode_attention(q, k, v, k_cache, v_cache, cache_valid)
    x = x + einsum_promoted("bshk,hkd->bsd", o, p["wo"])
    x = _mlp_block(p, x, cfg, decode=True)
    ring_buffer_write(k_cache, k, pos)
    ring_buffer_write(v_cache, v, pos)
    return x


def embed_tokens(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """Token embeddings (B, S, d); with ``batch["prefix_embeds"]`` (B, P,
    d) the first P positions are those embeddings instead (the stub
    frontend's image tokens), so a prompt shorter than P gives P."""
    x = params["embed"][batch["tokens"].long()]
    prefix = batch.get("prefix_embeds")
    if prefix is not None:
        x = torch.cat([prefix.to(x.dtype), x[:, prefix.shape[1]:]], dim=1)
    return x


def unembed(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Logits in the promoted dtype of ``x`` and the weights (an xLSTM's
    f32 residual stream against bf16 embeddings gives f32 logits)."""
    if cfg.tie_embeddings:
        return einsum_promoted("bsd,vd->bsv", x, params["embed"])
    return einsum_promoted("bsd,dv->bsv", x, params["unembed"])


def _final_norm(params: dict, x: torch.Tensor, cfg: ArchConfig):
    return _norm(x, params["final_norm_gamma"],
                 params.get("final_norm_beta"), cfg)


def forward_train(params: dict, batch: dict, cfg: ArchConfig,
                  mesh=None) -> torch.Tensor:
    """Full-sequence logits (B, S, V_padded).  With ``mesh`` (DTensor
    parameters and batch on one agent's (fsdp, model) block) the
    residual stream is constrained to ("batch", "seq", None) after the
    embedding and after every layer, the reference's
    ``models.common.constrain`` points."""
    x = constrain(embed_tokens(params, batch, cfg), mesh,
                  ("batch", "seq", None))
    rope = rope_tables(x.shape[1], cfg.head_dim, cfg.rotary_frac,
                       cfg.rope_theta, x.device)
    for p in layer_views(params["layers"]):
        x = constrain(_layer_remat(p, x, rope, cfg), mesh,
                      ("batch", "seq", None))
    return unembed(params, _final_norm(params, x, cfg), cfg)


def loss_fn(params: dict, batch: dict, cfg: ArchConfig,
            mesh=None) -> torch.Tensor:
    """Mean cross-entropy; with ``batch["loss_weights"]``, or with prefix
    embeds configured (weights 0 on the first ``num_prefix_embeds``
    positions, 1 after), the weighted mean over the whole padded vocab,
    as the reference's.  With ``mesh`` the logits are constrained to
    ("batch", "seq", None) before the loss: on an fsdp x model block that
    gathers the vocab-sharded logits over "model" (DTensor's masked
    gather of the gold logit fails when the batch is sharded too)."""
    if mesh is None:
        logits = forward_train(params, batch, cfg)
    else:
        logits = constrain(forward_train(params, batch, cfg, mesh), mesh,
                           ("batch", "seq", None))
    labels = batch["labels"]
    weights = batch.get("loss_weights")
    if weights is None and cfg.num_prefix_embeds:
        S = labels.shape[-1]
        weights = (torch.arange(S, device=labels.device)
                   >= cfg.num_prefix_embeds).float().expand(labels.shape)
    if weights is None:
        return cross_entropy(logits, labels, cfg.vocab_size)
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return ((logz - gold) * weights).sum() / torch.clamp_min(weights.sum(),
                                                              1.0)


def cache_len_for(cfg: ArchConfig, seq_len: int) -> int:
    if cfg.attn_window is not None and cfg.long_context_mode == "window":
        return min(seq_len, cfg.attn_window)
    return seq_len


def cache_spec(cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    """(shape, logical, dtype|None) per cache leaf (None: the model's)."""
    C = cache_len_for(cfg, seq_len)
    shape = (cfg.num_layers, batch, C, cfg.num_kv_heads, cfg.head_dim)
    logical = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    return {"k": (shape, logical, None), "v": (shape, logical, None)}


def forward_prefill(params: dict, batch: dict, cfg: ArchConfig) -> dict:
    """Process a full prompt: ``{"logits": (B, V) of the last position,
    "cache": {"k", "v"} each (L, B, C, KV, hd) in ring layout, "pos": S}``
    (``pos`` a Python int)."""
    x = embed_tokens(params, batch, cfg)
    B, S, _ = x.shape
    C = cache_len_for(cfg, S)
    rope = rope_tables(S, cfg.head_dim, cfg.rotary_frac, cfg.rope_theta,
                       x.device)
    shape = (cfg.num_layers, B, C, cfg.num_kv_heads, cfg.head_dim)
    cache = {"k": torch.empty(shape, dtype=x.dtype, device=x.device),
             "v": torch.empty(shape, dtype=x.dtype, device=x.device)}
    for i, p in enumerate(layer_views(params["layers"])):
        x, cache["k"][i], cache["v"][i] = _layer_prefill(p, x, rope, cfg, C)
    logits = unembed(params, _final_norm(params, x[:, -1:], cfg), cfg)
    return {"logits": logits[:, 0], "cache": cache, "pos": S}


def forward_decode(params: dict, token: torch.Tensor, cache: dict, pos,
                   cfg: ArchConfig) -> dict:
    """One decode step: ``token`` (B,) ids, ``pos`` the absolute position
    of ``token``: a scalar (the whole batch in lockstep) or (B,) integers
    (per-slot positions, continuous batching).  Writes the new keys and
    values into ``cache`` in place; returns ``{"logits": (B, V), "cache":
    cache, "pos": pos + 1}``.  Nothing here waits for the device."""
    x = params["embed"][token.long()][:, None, :]
    B = x.shape[0]
    C = cache["k"].shape[2]
    pos = torch.as_tensor(pos, device=x.device)
    cache_valid = decode_cache_valid(pos, C)
    rope = rope_tables_at(decode_positions(pos, B), cfg.head_dim,
                          cfg.rotary_frac, cfg.rope_theta)
    for i, p in enumerate(layer_views(params["layers"])):
        x = _layer_decode(p, x, cache["k"][i], cache["v"][i], pos, rope,
                          cfg, cache_valid)
    logits = unembed(params, _final_norm(params, x, cfg), cfg)
    return {"logits": logits[:, 0], "cache": cache, "pos": pos + 1}
