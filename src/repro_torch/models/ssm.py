"""Mamba2 (SSD) blocks and the SSD core they share with the xLSTM's mLSTM
(counterpart of ``repro.models.ssm``): the chunked state-space-duality
scan ``ssd_chunked``, its single-token recurrence ``ssd_step``, the causal
depthwise conv with its one-token step, and the Mamba2 block's parameters
and its train, prefill and decode passes (the hybrid family's trunk).

``ssd_chunked`` computes every chunk's intra-chunk output and state
contribution with `kernels.ssd_intra_chunk` (B11 on a CUDA tensor, its
plain version on the CPU, differentiable on both); the inter-chunk
recurrence h_c = decay_c h_{c-1} + S_c is a loop over the chunks.  A
per-head B and C (mLSTM's k and q) fold their heads into B11's chunk axis
(H = 1), which is exact: each head's block is an independent chunk.  A
Mamba2 block's B and C are shared by its heads: B11 takes them as they are
(G = batch x chunks, H = ssm_heads).  Decode runs ``ssd_step``, no kernel,
as the reference's.

The reference's dtype promotion is kept (`einsum_promoted`): in a bf16
model the SSD's y is f32 (its inter-chunk term is scaled by an f32
decay), so the first mamba block's output, and the residual stream from
there on, is f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.ssm_scan import ssd_intra_chunk
from .common import ArrayDef, rms_norm
from .common import einsum_promoted as _mm

__all__ = ["CHUNK", "causal_conv", "causal_conv_step", "ssd_chunked",
           "ssd_step", "mamba_defs", "mamba_block_train",
           "mamba_block_prefill", "mamba_block_decode"]

CHUNK = 64


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C); w: (K, C) depthwise causal conv + silu."""
    K = w.shape[0]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for k in range(K):
        # tap k sees x[t - (K-1-k)]: w[K-1] multiplies the current input
        out = out + pad[:, k:k + x.shape[1]] * w[k]
    out = out + b
    return F.silu(out.float()).to(x.dtype)


def causal_conv_step(x_t: torch.Tensor, tail: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor):
    """One-token conv: x_t (B, C), tail (B, K-1, C) = previous inputs.
    Returns (out (B, C), new tail)."""
    window = torch.cat([tail, x_t[:, None]], dim=1)  # (B, K, C)
    out = _mm("bkc,kc->bc", window, w) + b
    return F.silu(out.float()).to(x_t.dtype), window[:, 1:]


def _pad_steps(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad axis 1 (the sequence) by ``pad`` steps at the end."""
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))


def _intra(xc, dtc, a_cum, Bc, Cc, per_head: bool):
    """y_intra (B, nc, Q, H, P) in x's dtype and chunk states
    (B, nc, H, P, N) f32 through B11, heads folded into G when B and C are
    per head."""
    B, nc, Q, H, P = xc.shape
    N = Bc.shape[-1]
    if not per_head:
        y, s = ssd_intra_chunk(*(t.reshape(B * nc, *t.shape[2:]).contiguous()
                                 for t in (xc, dtc, a_cum, Bc, Cc)))
        return y.reshape(B, nc, Q, H, P), s.reshape(B, nc, H, P, N)
    G = B * nc * H

    def fold(t):  # (B, nc, Q, H, ...) -> (B nc H, Q, 1 | ...), contiguous
        t = t.transpose(2, 3).reshape(G, Q, *t.shape[4:])
        return (t if t.dim() > 2 else t[..., None]).contiguous()

    y, s = ssd_intra_chunk(fold(xc)[:, :, None], fold(dtc), fold(a_cum),
                           fold(Bc), fold(Cc))
    return (y.reshape(B, nc, H, Q, P).transpose(2, 3),
            s.reshape(B, nc, H, P, N))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor | None,
                Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor | None,
                h0: torch.Tensor | None = None,
                log_decay: torch.Tensor | None = None):
    """Chunked state-space-duality scan (shared by Mamba2 and mLSTM).

    x: (B, S, H, P); dt: (B, S, H) f32 input-gate scale; the per-step
    log-decay is ``dt * A`` (Mamba2, A (H,)) or ``log_decay`` (B, S, H)
    (mLSTM log f).  Bm/Cm: (B, S, N) shared across heads (Mamba2) or
    (B, S, H, N) per head (mLSTM k/q), in x's dtype.  D: (H,) skip or None.
    Returns y (B, S, H, P) and the final state (B, H, P, N) f32; y's dtype
    is the reference's promotion (f32 when x is bf16: the inter-chunk term
    is scaled by an f32 decay)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    per_head = Bm.dim() == 4
    Q = min(CHUNK, S)
    if S % Q:
        # pad with dt = 0 steps: decay exp(0) = 1, zero state contribution,
        # exactly a no-op suffix; outputs are cropped back
        pad = Q - S % Q
        y_p, h_p = ssd_chunked(
            _pad_steps(x, pad), _pad_steps(dt, pad), A, _pad_steps(Bm, pad),
            _pad_steps(Cm, pad), D, h0,
            log_decay=None if log_decay is None else _pad_steps(log_decay,
                                                                pad))
        return y_p[:, :S], h_p
    nc = S // Q
    xc = x.reshape(B, nc, Q, H, P)
    dtc = dt.reshape(B, nc, Q, H)
    shape = (B, nc, Q, H, N) if per_head else (B, nc, Q, N)
    Bc, Cc = Bm.reshape(shape), Cm.reshape(shape)
    a = dtc * A if log_decay is None else log_decay.reshape(B, nc, Q, H)
    a_cum = torch.cumsum(a, dim=2)  # within-chunk inclusive cumsum

    y_intra, chunk_states = _intra(xc, dtc, a_cum, Bc, Cc, per_head)

    # inter-chunk recurrence (tiny, elementwise), the state BEFORE each chunk
    chunk_decay = torch.exp(a_cum[:, :, -1, :])  # (B, nc, H)
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = chunk_decay[:, c, :, None, None] * h + chunk_states[:, c]
    h_prev = torch.stack(h_prevs, dim=1).to(x.dtype)  # (B, nc, H, P, N)

    # inter-chunk output: y_inter[i] = C_i . (decay(0..i) h_prev)
    eq = "bcqhn,bchpn->bcqhp" if per_head else "bcqn,bchpn->bcqhp"
    y_inter = torch.einsum(eq, Cc, h_prev) * torch.exp(a_cum)[..., None]
    y = y_inter + y_intra
    if D is not None:
        y = y + D[:, None] * xc
    return y.reshape(B, S, H, P), h


def ssd_step(x_t, dt_t, A, B_t, C_t, D, h):
    """Single-token SSD recurrence.  x_t: (B, H, P); dt_t: (B, H);
    B_t/C_t: (B, N); h: (B, H, P, N)."""
    decay = torch.exp(dt_t * A)  # (B, H)
    upd = _mm("bhp,bn->bhpn", x_t * dt_t[..., None], B_t)
    h_new = decay[..., None, None] * h + upd.to(h.dtype)
    y = _mm("bhpn,bn->bhp", h_new.to(x_t.dtype), C_t)
    return y + D[:, None] * x_t, h_new


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def mamba_defs(L: int, cfg: ArchConfig) -> dict:
    d, din, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    H, K = cfg.ssm_heads, cfg.ssm_conv
    conv_dim = din + 2 * N  # x, B and C channels go through the conv
    return {
        "norm_gamma": ArrayDef((L, d), ("layers", "embed"), init="ones"),
        "w_in_x": ArrayDef((L, d, din), ("layers", "embed", "ssm_heads")),
        "w_in_z": ArrayDef((L, d, din), ("layers", "embed", "ssm_heads")),
        "w_in_B": ArrayDef((L, d, N), ("layers", "embed", "state")),
        "w_in_C": ArrayDef((L, d, N), ("layers", "embed", "state")),
        "w_in_dt": ArrayDef((L, d, H), ("layers", "embed", "ssm_heads")),
        "dt_bias": ArrayDef((L, H), ("layers", "ssm_heads"), init="zeros"),
        "A_log": ArrayDef((L, H), ("layers", "ssm_heads"), init="zeros"),
        "D": ArrayDef((L, H), ("layers", "ssm_heads"), init="ones"),
        "conv_w": ArrayDef((L, K, conv_dim), ("layers", "conv", "ssm_heads")),
        "conv_b": ArrayDef((L, conv_dim), ("layers", "ssm_heads"),
                           init="zeros"),
        "w_out": ArrayDef((L, din, d), ("layers", "ssm_heads", "embed")),
    }


def _in_proj(p: dict, x: torch.Tensor):
    """The block's input norm and projections: (conv input x|B|C, z, dt).
    x, B and C are one (..., d_inner + 2N) tensor, the conv's channels."""
    h = rms_norm(x, p["norm_gamma"])
    conv_in = torch.cat([_mm("bsd,de->bse", h, p["w_in_x"]),
                         _mm("bsd,dn->bsn", h, p["w_in_B"]),
                         _mm("bsd,dn->bsn", h, p["w_in_C"])], dim=-1)
    return (conv_in, _mm("bsd,de->bse", h, p["w_in_z"]),
            _mm("bsd,dh->bsh", h, p["w_in_dt"]))


def _gates(p: dict, dt: torch.Tensor):
    """softplus(dt + dt_bias) and A = -exp(A_log), f32."""
    return (F.softplus(dt.float() + p["dt_bias"]),
            -torch.exp(p["A_log"].float()))


def _out(p: dict, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
         cfg: ArchConfig) -> torch.Tensor:
    """Gate y by silu(z), project back and add to the residual ``x``."""
    y = y.reshape(*y.shape[:2], cfg.d_inner)
    y = y * F.silu(z.float()).to(y.dtype)
    return x + _mm("bse,ed->bsd", y, p["w_out"])


def mamba_block_prefill(p: dict, x: torch.Tensor, cfg: ArchConfig):
    """x (B, S, d) -> (x + block(x), (ssm state (B, H, P, N) f32, conv tail
    (B, K-1, d_inner + 2N))): the train pass and the states a decode
    continues from.  The SSD runs through B11 (`ssd_chunked`)."""
    B, S, _ = x.shape
    H, P, N, din = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.d_inner
    conv_in, z, dt = _in_proj(p, x)
    conv_tail = conv_in[:, -(cfg.ssm_conv - 1):]
    xc, Bm, Cm = causal_conv(conv_in, p["conv_w"], p["conv_b"]).split(
        [din, N, N], dim=-1)
    dt, A = _gates(p, dt)
    y, h_final = ssd_chunked(xc.reshape(B, S, H, P), dt, A, Bm, Cm,
                             p["D"].float())
    return _out(p, x, y, z, cfg), (h_final, conv_tail)


def mamba_block_train(p: dict, x: torch.Tensor,
                      cfg: ArchConfig) -> torch.Tensor:
    return mamba_block_prefill(p, x, cfg)[0]


def mamba_block_decode(p: dict, x: torch.Tensor, state, cfg: ArchConfig):
    """x (B, 1, d); state = (ssm state (B, H, P, N) f32, conv tail (B, K-1,
    d_inner + 2N)).  Returns (x + block(x), (new ssm state, new tail))."""
    B = x.shape[0]
    H, P, N, din = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.d_inner
    ssm_h, conv_tail = state
    conv_in, z, dt = _in_proj(p, x)
    conv_out, new_tail = causal_conv_step(conv_in[:, 0], conv_tail,
                                          p["conv_w"], p["conv_b"])
    xc, Bm, Cm = conv_out.split([din, N, N], dim=-1)
    dt, A = _gates(p, dt[:, 0])
    y, new_h = ssd_step(xc.reshape(B, H, P), dt, A, Bm, Cm, p["D"].float(),
                        ssm_h)
    return _out(p, x, y[:, None], z, cfg), (new_h, new_tail)
