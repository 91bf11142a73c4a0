"""Shared model machinery (counterpart of ``repro.models.common``):
parameter definitions, norms, rotary embeddings, naive and blocked
(online-softmax) causal GQA attention, ring-buffer decode attention,
SwiGLU, the GELU MLP and the padded-vocab cross-entropy.

Layouts follow the reference: activations (B, S, d), attention heads
(B, S, H, hd), weights as the reference's einsum operands.  Every function
keeps the reference's dtype discipline (norms, rotary, softmax and the loss
in f32; matmuls in the promoted dtype of their operands, as jnp.einsum:
the parameter dtype for a dense or xLSTM block, f32 where a hybrid's f32
residual stream meets bf16 weights).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.build import to_device

__all__ = ["ArrayDef", "init_params", "constrain", "rms_norm", "layer_norm", "rope_freqs",
           "rope_tables", "rope_tables_at", "apply_rope", "attention",
           "chunked_attention", "decode_attention", "ring_buffer_write",
           "decode_cache_valid", "decode_positions", "swiglu",
           "gelu_mlp", "cross_entropy", "pad_vocab", "einsum_promoted",
           "layer_views", "remat"]


@dataclasses.dataclass(frozen=True)
class ArrayDef:
    """Declarative parameter: shape + logical axis names + initializer."""

    shape: tuple[int, ...]
    logical: tuple[str | None, ...]
    init: str = "normal"  # normal | zeros | ones
    scale: float | None = None  # stddev for normal; default 1/sqrt(fan_in)

    def materialize(self, generator: torch.Generator, dtype: torch.dtype,
                    device) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        # same fan-in rule as the reference (second-to-last dim)
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        scale = self.scale if self.scale is not None else 1.0 / math.sqrt(
            fan_in)
        w = torch.randn(self.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (w * scale).to(dtype)


def init_params(generator: torch.Generator, defs: Any, dtype: torch.dtype,
                device) -> Any:
    """Materialize a nested dict of ArrayDefs, leaves in sorted-key order
    from one generator (the draws differ from the reference's; the tests
    share weights through `repro_torch.convert`)."""
    if isinstance(defs, dict):
        return {k: init_params(generator, defs[k], dtype, device)
                for k in sorted(defs)}
    return defs.materialize(generator, dtype, device)


def einsum_promoted(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` in the operands' promoted dtype, jnp.einsum's rule:
    an f32 activation times a bf16 weight computes in f32."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def constrain(x: torch.Tensor, mesh, logical: tuple, rules=None):
    """The reference's activation constraint (``with_logical_constraint``)
    as a DTensor redistribution: ``x``, a DTensor on one agent's block of
    the mesh, placed by the spec of ``logical`` (TRAIN_RULES unless
    ``rules``) resolved on its own device mesh.  Exactly ``x`` when
    ``mesh`` is None, ``x`` is a plain tensor, or every dimension
    resolves to replication, as the reference's no-op."""
    if mesh is None or not hasattr(x, "device_mesh"):
        return x
    from ..dist.sharding import TRAIN_RULES, logical_spec, placements
    sub = x.device_mesh
    spec = logical_spec(sub, x.shape, logical,
                        TRAIN_RULES if rules is None else rules)
    if not any(e is not None for e in spec):
        return x
    return x.redistribute(sub, placements(spec, sub, x.dim()))


def remat(fn, *args):
    """``fn(*args)`` recomputed in the backward (the reference's
    ``jax.checkpoint`` of a layer body): autograd keeps only the tensor
    arguments, and the backward runs ``fn`` again to get what its own
    backward needs, so the values and the graph are those of ``fn(*args)``
    run directly.  Nothing in a layer draws randomness, so the RNG state is
    not kept (reading it is illegal while a CUDA graph captures).  Without
    grad mode it is ``fn(*args)``."""
    if not torch.is_grad_enabled():
        return fn(*args)
    from torch.utils.checkpoint import checkpoint
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def layer_views(stacked: dict) -> list[dict]:
    """Per-layer views of a (nested) dict of (L, ...) stacked leaves, one
    unbind per leaf (the backward of ``leaf[i]`` would write a zero tensor
    of the whole (L, ...) leaf per layer; unbind's stacks the L slices
    once).  A sub-dict (the MoE family's ``moe``) gives per-layer
    sub-dicts."""
    sliced = {name: (layer_views(leaf) if isinstance(leaf, dict)
                     else leaf.unbind(0)) for name, leaf in stacked.items()}
    L = len(next(iter(sliced.values())))
    return [{name: s[i] for name, s in sliced.items()} for i in range(L)]


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gamma.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * gamma.float() + beta.float()).to(x.dtype)


def rope_freqs(head_dim: int, rotary_frac: float, theta: float) -> np.ndarray:
    rot_dim = int(head_dim * rotary_frac) // 2 * 2
    inv = 1.0 / (theta ** (np.arange(0, rot_dim, 2, dtype=np.float64)
                           / rot_dim))
    return inv.astype(np.float32)


_INV_FREQ: dict = {}


def rope_tables_at(positions: torch.Tensor, head_dim: int,
                   rotary_frac: float,
                   theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) at integer ``positions`` (..., seq), each (..., seq, 1,
    rot_dim/2) f32: the angle ``positions * inv_freq`` in f32, then cos and
    sin (the reference's ``apply_rope(x, positions, ...)``).  Decode gives
    per-slot positions (B, 1).  The inverse frequencies reach the card
    once per (head_dim, rotary_frac, theta, device), without a blocking
    copy, and are reused: a CUDA graph of training steps reads the same
    tensor at every replay."""
    cache_key = (head_dim, rotary_frac, theta, positions.device)
    inv = _INV_FREQ.get(cache_key)
    if inv is None:
        inv = _INV_FREQ[cache_key] = to_device(torch.from_numpy(rope_freqs(
            head_dim, rotary_frac, theta)), positions.device)
    ang = positions[..., None].float() * inv
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rope_tables(seq: int, head_dim: int, rotary_frac: float, theta: float,
                device) -> tuple[torch.Tensor, torch.Tensor]:
    """`rope_tables_at` positions 0..seq-1: each (seq, 1, rot_dim/2),
    computed once per forward and shared by every layer's q and k."""
    return rope_tables_at(torch.arange(seq, device=device), head_dim,
                          rotary_frac, theta)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, head_dim) with `rope_tables` for its seq.  Only
    the first rot_dim channels rotate (partial rotary), interleaved pairs."""
    rot_dim = cos.shape[-1] * 2
    if rot_dim == 0:
        return x
    xr = x[..., :rot_dim].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rotated = torch.stack([r1, r2], dim=-1).reshape(xr.shape)
    return torch.cat([rotated.to(x.dtype), x[..., rot_dim:]], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None) -> torch.Tensor:
    """Grouped-query attention, scores materialized (the reference's naive
    path).  q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    logits = einsum_promoted("bqkgd,bskd->bkgqs", qg, k).float() * (
        1.0 / math.sqrt(hd))
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = einsum_promoted("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, H, hd)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      chunk: int = 4096) -> torch.Tensor:
    """`attention`'s grouped-query result without the (Sq, Sk) scores: query
    blocks of ``chunk`` rows stream over key blocks with an online-softmax
    accumulator (the reference's ``chunked_attention``), in plain torch.
    Key blocks wholly above the causal diagonal or wholly behind the
    window are skipped; the query and key tails are padded to a whole
    block (padded keys masked); a row with no key yet keeps m = -inf and
    its rescale factor finite.  Training runs it when ``attn_impl ==
    "chunked"``; a prefill on a CUDA tensor runs B10 (the blocked kernel)
    whatever ``attn_impl`` says.  q: (B, Sq, H, hd); k, v: (B, Sk, KV,
    hd)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    c = min(chunk, Sq, Sk)
    pad_q, pad_k = (-Sq) % c, (-Sk) % c
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    nq, nk = (Sq + pad_q) // c, (Sk + pad_k) // c
    qg = q.reshape(B, nq, c, KV, G, hd)
    ar = torch.arange(c, device=q.device)
    f32 = dict(dtype=torch.float32, device=q.device)
    outs = []
    for qi in range(nq):
        q_blk, q0 = qg[:, qi], qi * c
        acc = torch.zeros((B, KV, G, c, hd), **f32)
        m = torch.full((B, KV, G, c, 1), -math.inf, **f32)
        l = torch.zeros((B, KV, G, c, 1), **f32)
        for ki in range(nk):
            k0 = ki * c
            if causal and k0 > q0 + c - 1:
                continue  # above the diagonal
            if window is not None and k0 + c - 1 <= q0 - window:
                continue  # wholly behind the window
            k_blk, v_blk = k[:, k0:k0 + c], v[:, k0:k0 + c]
            s = einsum_promoted("bqkgd,bskd->bkgqs", q_blk,
                                k_blk).float() * scale
            qpos, kpos = q0 + ar[:, None], k0 + ar[None, :]
            mask = kpos < Sk  # padded keys are invalid
            if causal:
                mask = mask & (kpos <= qpos)
            if window is not None:
                mask = mask & (kpos > qpos - window)
            s = torch.where(mask, s, -math.inf)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            finite = torch.isfinite(m_new)
            m_safe = torch.where(finite, m_new, 0.0)
            alpha = torch.exp(torch.where(torch.isfinite(m), m - m_safe,
                                          -math.inf))
            p = torch.exp(s - m_safe)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = alpha * acc + einsum_promoted(
                "bkgqs,bskd->bkgqd", p.to(v.dtype), v_blk).float()
            m = m_new
        out = (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, c, H, hd))
    return torch.cat(outs, dim=1)[:, :Sq]


def decode_attention(q: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_valid: torch.Tensor) -> torch.Tensor:
    """One-token grouped attention against a (ring-buffer) KV cache.

    q: (B, 1, H, hd); k_new/v_new: (B, 1, KV, hd); caches: (B, C, KV, hd);
    cache_valid: (C,) or (B, C) bool.  The new token always attends to
    itself."""
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    qg = q.reshape(B, 1, KV, G, hd)
    scale = 1.0 / math.sqrt(hd)
    lc = einsum_promoted("bqkgd,bskd->bkgqs", qg, k_cache).float() * scale
    valid = (cache_valid[None, None, None, None, :] if cache_valid.dim() == 1
             else cache_valid[:, None, None, None, :])
    lc = torch.where(valid, lc, torch.full_like(lc, -1e30))
    ls = einsum_promoted("bqkgd,bskd->bkgqs", qg, k_new).float() * scale
    probs = torch.softmax(torch.cat([lc, ls], dim=-1), dim=-1).to(q.dtype)
    pc, ps = probs[..., :-1], probs[..., -1:]
    out = einsum_promoted("bkgqs,bskd->bqkgd", pc, v_cache)
    out = out + einsum_promoted("bkgqs,bskd->bqkgd", ps, v_new)
    return out.reshape(B, 1, H, hd)


def ring_buffer_write(cache: torch.Tensor, new: torch.Tensor,
                      pos) -> torch.Tensor:
    """Write (B, 1, ...) ``new`` into slot pos % C of (B, C, ...) ``cache``
    IN PLACE and return ``cache`` (the reference returns a new array).

    ``pos`` is a scalar (an int or a 0-d tensor: every row at the same
    absolute position) or a (B,) integer tensor (continuous batching: each
    row at its own position, written with ``index_put_`` on (arange(B),
    pos % C)).  A tensor ``pos`` stays on the device: no host sync."""
    C = cache.shape[1]
    new = new.to(cache.dtype)
    pos = torch.as_tensor(pos, device=cache.device)
    if pos.dim() == 0:
        return cache.index_copy_(1, (pos % C).reshape(1).long(), new)
    rows = torch.arange(cache.shape[0], device=cache.device)
    return cache.index_put_((rows, (pos % C).long()), new[:, 0])


def decode_cache_valid(pos, C: int) -> torch.Tensor:
    """Ring-buffer validity mask for `decode_attention`: slots < min(pos, C)
    hold real entries.  Scalar pos -> (C,); per-slot (B,) pos -> (B, C)."""
    pos = torch.as_tensor(pos)
    slots = torch.arange(C, device=pos.device)
    if pos.dim() == 0:
        return slots < torch.clamp_max(pos, C)
    return slots[None, :] < torch.clamp_max(pos, C)[:, None]


def decode_positions(pos, B: int) -> torch.Tensor:
    """(B, 1) absolute rope positions of the decode token from a scalar or
    per-slot (B,) ``pos``."""
    pos = torch.as_tensor(pos)
    if pos.dim() == 0:
        return pos.reshape(1, 1).expand(B, 1).to(torch.int32)
    return pos[:, None].to(torch.int32)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = einsum_promoted("...d,df->...f", x, w_gate)
    u = einsum_promoted("...d,df->...f", x, w_up)
    h = F.silu(g.float()).to(x.dtype) * u
    return einsum_promoted("...f,fd->...d", h, w_down)


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    """up, GELU in f32 (the tanh form, ``jax.nn.gelu``'s default), down."""
    h = einsum_promoted("...d,df->...f", x, w_up)
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return einsum_promoted("...f,fd->...d", h, w_down)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int | None = None) -> torch.Tensor:
    """Mean token cross-entropy in f32; ``vocab_size`` masks padded vocab."""
    lf = logits.float()
    if vocab_size is not None and vocab_size < lf.shape[-1]:
        pad = torch.arange(lf.shape[-1], device=lf.device) >= vocab_size
        lf = lf.masked_fill(pad, -1e30)
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()


def pad_vocab(vocab: int, multiple: int = 512) -> int:
    return ((vocab + multiple - 1) // multiple) * multiple
