"""Plain PyTorch versions of the hand-written kernels.

The kernel wrappers use these for tensors on the CPU;
the tests and ``chip_smoke.py`` hold the CUDA kernels against them on the
card.  They repeat the kernels' arithmetic operation for operation (each
product and difference rounded once, in f32), which is what makes the
obfuscate kernels bitwise comparable.
"""
from __future__ import annotations

import math

import torch

from ..core import prng

__all__ = ["obfuscate_ref", "obfuscate_krng_ref", "gossip_ref",
           "metropolis_ref", "masked_gossip_ref", "mask_from_bits",
           "masked_gossip_krng_ref", "poison_transmit", "guarded_gossip_ref",
           "ring_gossip_ref", "ring_obfuscate_gossip_ref",
           "ring_obfuscate_gossip_krng_ref", "flash_attention_ref",
           "ssd_intra_chunk_ref", "CORRUPT_MODES"]

CORRUPT_MODES = ("nan", "inf", "scale")


def _f32(v, device) -> torch.Tensor:
    """v as an f32 tensor on ``device``; a python number is a fill there,
    not a host copy (legal inside a CUDA graph's capture)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((), float(v), dtype=torch.float32, device=device)


def obfuscate_ref(x: torch.Tensor, g: torch.Tensor, bits: torch.Tensor,
                  lam_bar, w_self, b_self) -> torch.Tensor:
    """v = w_self x - b_self (lambda ∘ g), lambda = 2 lam_bar U(bits)."""
    dev = x.device
    lam = (2.0 * _f32(lam_bar, dev)) * prng.bits_to_uniform(bits)
    u = lam * g.float()
    return (_f32(w_self, dev) * x.float() - _f32(b_self, dev) * u).to(x.dtype)


def obfuscate_krng_ref(x: torch.Tensor, g: torch.Tensor, keys: torch.Tensor,
                       offsets: torch.Tensor, lam_bar, w_self, b_self,
                       partitionable: bool = True):
    """`obfuscate_ref` fed the bits the in-kernel generator draws
    (`prng.leaf_bits`, in the stream ``partitionable`` names): ``(v,
    bits)``."""
    bits = prng.leaf_bits(keys, offsets, x.shape[0], x.shape[1],
                          partitionable=partitionable)
    return obfuscate_ref(x, g, bits, lam_bar, w_self, b_self), bits


def gossip_ref(W: torch.Tensor, B: torch.Tensor, X: torch.Tensor,
               U: torch.Tensor) -> torch.Tensor:
    """x' = W X - B U over the leading agent dim, accumulated in f32."""
    out = W.float() @ X.float() - B.float() @ U.float()
    return out.to(X.dtype)


def metropolis_ref(mask: torch.Tensor) -> torch.Tensor:
    """The Metropolis weights of an off-diagonal 0/1 edge mask, rounded as
    the masked kernels round them on chip: w_ij = mask_ij / (1 +
    max(deg_i, deg_j)) (one correctly rounded division), w_ii = 1 - the
    row's sum taken in ascending j, the order of the reference's
    ``metropolis_from_mask``, so W_k is its bit for bit.
    ``core.mixing.metropolis_from_mask`` is this function."""
    mask = mask.float()
    deg = mask.sum(dim=1)
    w = mask / (1.0 + torch.maximum(deg[:, None], deg[None, :]))
    total = w[:, 0].clone()
    for j in range(1, w.shape[1]):
        total = total + w[:, j]
    return w + torch.diag(1.0 - total)


def masked_gossip_ref(mask: torch.Tensor, B: torch.Tensor, X: torch.Tensor,
                      U: torch.Tensor) -> torch.Tensor:
    """x' = metropolis(mask) X - B U, accumulated in f32."""
    return gossip_ref(metropolis_ref(mask), B, X, U)


def mask_from_bits(bits: torch.Tensor, keep_prob,
                   adj: torch.Tensor) -> torch.Tensor:
    """The symmetric off-diagonal edge mask from (m, m) uint32 draws: one
    U[0, 1) per undirected edge by the mantissa trick ((bits >> 9) |
    0x3F800000, minus 1), the strict upper triangle kept where u <
    keep_prob (compared in f32), mirrored, gated by ``adj``."""
    u = prng.bits_to_uniform(bits)
    keep_prob = _f32(keep_prob, u.device)
    keep = torch.triu(u < keep_prob, diagonal=1).float()
    return (keep + keep.T) * adj.float().to(u.device)


def masked_gossip_krng_ref(key: torch.Tensor, keep_prob, adj: torch.Tensor,
                           B: torch.Tensor, X: torch.Tensor,
                           U: torch.Tensor):
    """`masked_gossip_ref` on the mask drawn from ``prng.bits(key, (m,
    m))``: ``(out, mask)``."""
    m = X.shape[0]
    bits = prng.bits(key.to(device=X.device, dtype=torch.int64), (m, m))
    mask = mask_from_bits(bits, keep_prob, adj.to(X.device))
    return masked_gossip_ref(mask, B, X, U), mask


def poison_transmit(x: torch.Tensor, corrupt: torch.Tensor, mode: str,
                    scale) -> torch.Tensor:
    """The transmit buffer of an (m, ...) buffer: the rows of corrupt
    senders (``corrupt[j] > 0``) become nan, +inf, or ``x * scale`` with
    the product taken in x's dtype (the scale rounded to it first, the
    product rounded to it after).  The guarded kernel forms the same
    values in registers."""
    c = (corrupt > 0).to(x.device).reshape((-1,) + (1,) * (x.dim() - 1))
    if mode == "nan":
        bad = torch.full_like(x, float("nan"))
    elif mode == "inf":
        bad = torch.full_like(x, float("inf"))
    elif mode == "scale":
        bad = x * torch.tensor(scale, dtype=x.dtype, device=x.device)
    else:
        raise ValueError(f"unknown corrupt mode {mode!r}; have "
                         f"{CORRUPT_MODES}")
    return torch.where(c, bad, x)


def guarded_gossip_ref(mask: torch.Tensor, B: torch.Tensor, X: torch.Tensor,
                       U: torch.Tensor, XT: torch.Tensor, UT: torch.Tensor,
                       clip) -> torch.Tensor:
    """Gossip with a per-link finite guard, in f32:

        x'_i = (w_ii x_i - b_ii u_i)
               + sum_j guard(w_ij xt_j - b_ij ut_j)   (w, b off-diagonal)

    with guard(v) = where(isfinite(v), clip(v, -clip, clip), 0) (``clip``
    None: no guard).  X, U are the agents' own buffers (self terms only);
    XT, UT what they transmit.  The sum over j runs over every j, the zero
    diagonal and non-neighbours included, as the reference's does: with
    no guard, a non-finite transmit reaches every receiver (0 * nan)."""
    m = X.shape[0]
    w = metropolis_ref(mask)
    eye = torch.eye(m, device=w.device)
    w_diag, b_diag = torch.diagonal(w), torch.diagonal(B.float())
    w_off, b_off = w * (1.0 - eye), B.float() * (1.0 - eye)
    x, u = X.float(), U.float()
    self_term = w_diag[:, None] * x - b_diag[:, None] * u
    v = (w_off[:, :, None] * XT.float()[None]
         - b_off[:, :, None] * UT.float()[None])
    if clip is not None:
        v = torch.where(torch.isfinite(v), torch.clamp(v, -clip, clip),
                        torch.zeros_like(v))
    return (self_term + v.sum(dim=1)).to(X.dtype)


def ring_gossip_ref(w_tab: torch.Tensor, b_tab: torch.Tensor,
                    perms: torch.Tensor, X: torch.Tensor, U: torch.Tensor):
    """x' = W X - B U from the ring layout's direction tables, as the
    reference's staged ring computes it, in f32:

        out = w[:, 0] x - b[:, 0] u                  (self term)
        v_d = w[:, 1 + d] x - b[:, 1 + d] u          (every direction)
        out = out + perms[d] @ v_d                   (d in order)

    ``w_tab``/``b_tab``: (m, 1 + ndirs); ``perms``: (ndirs, m, m) 0/1,
    row i selecting the sender agent i receives from.  The 0/1 product is
    a matrix product, so a non-finite v_d in a column reaches every
    receiver of that column (0 * nan = nan).  Returns ``(out, v)``: out in
    X's dtype, v the (ndirs, m, n) f32 messages, sender-major."""
    x, u = X.float(), U.float()
    w, b = w_tab.float(), b_tab.float()
    perms = perms.float().to(x.device)
    out = w[:, 0:1] * x - b[:, 0:1] * u
    vs = [w[:, d + 1:d + 2] * x - b[:, d + 1:d + 2] * u
          for d in range(perms.shape[0])]
    for d, v in enumerate(vs):
        out = out + perms[d] @ v
    v = torch.stack(vs) if vs else x.new_zeros((0,) + tuple(x.shape))
    return out.to(X.dtype), v


def ring_obfuscate_gossip_ref(w_tab, b_tab, perms, X: torch.Tensor,
                              G: torch.Tensor, bits: torch.Tensor, lam_bar):
    """u = (2 lam_bar) U(bits) ∘ g in f32 (`obfuscate_ref`'s mantissa
    rule), then `ring_gossip_ref`: ``(out, v, u)``."""
    lam = (2.0 * _f32(lam_bar, X.device)) * prng.bits_to_uniform(bits)
    u = lam * G.float()
    out, v = ring_gossip_ref(w_tab, b_tab, perms, X, u)
    return out, v, u


def ring_obfuscate_gossip_krng_ref(w_tab, b_tab, perms, X: torch.Tensor,
                                   G: torch.Tensor, keys: torch.Tensor,
                                   offsets, lam_bar):
    """`ring_obfuscate_gossip_ref` on the bits the in-kernel generator
    draws (`prng.leaf_bits` of the (m, n_leaves, 2) key table):
    ``(out, v, u, bits)``."""
    m, n = X.shape
    bits = prng.leaf_bits(keys.to(X.device), offsets, m, n)
    return (*ring_obfuscate_gossip_ref(w_tab, b_tab, perms, X, G, bits,
                                       lam_bar), bits)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        window: int | None = None) -> torch.Tensor:
    """Causal / sliding-window attention, scores materialized (the
    reference's ``ref.flash_attention_ref``).  q, k, v: (B, S, H, hd) with
    equal head counts.  Logits in q's dtype, then f32 with the 1/sqrt(hd)
    scale; masked logits -inf; softmax in f32; probabilities cast to q's
    dtype before the product with v."""
    S = q.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def ssd_intra_chunk_ref(x: torch.Tensor, dt: torch.Tensor,
                        a_cum: torch.Tensor, Bm: torch.Tensor,
                        Cm: torch.Tensor):
    """Intra-chunk SSD block (the reference's ``ref.ssd_intra_chunk_ref``):
    x (G, Q, H, P); dt and a_cum (G, Q, H) f32, a_cum the inclusive cumsum
    of the log-decay; Bm, Cm (G, Q, N).  Returns y_intra (G, Q, H, P) in
    x's dtype and the chunk's state contribution (G, H, P, N) f32.  Scores
    in x's dtype, the weights cast to x's dtype before the y product, as
    the reference.  The causal mask is applied inside the exp (an
    anti-causal exponent is positive and may overflow; its gradient would
    then be 0 * inf), which leaves the forward values unchanged."""
    Q = x.shape[1]
    scores = torch.einsum("gin,gjn->gij", Cm, Bm)[..., None]  # (G,Q,Q,1)
    causal = torch.ones((Q, Q), dtype=torch.bool,
                        device=x.device).tril()[None, :, :, None]
    diff = a_cum[:, :, None, :] - a_cum[:, None, :, :]
    Lmat = torch.where(causal, diff, float("-inf")).exp()
    w = scores * Lmat * dt[:, None, :, :]
    y = torch.einsum("gijh,gjhp->gihp", w.to(x.dtype), x)
    decay_to_end = torch.exp(a_cum[:, -1:, :] - a_cum)  # (G,Q,H)
    wx = x * (dt * decay_to_end)[..., None]
    state = torch.einsum("gqn,gqhp->ghpn", Bm.to(wx.dtype), wx)
    return y, state
