"""The SSD core shared by Mamba2 and the xLSTM's mLSTM (counterpart of the
SSD part of ``repro.models.ssm``): the chunked state-space-duality scan
``ssd_chunked``, its single-token recurrence ``ssd_step``, and the causal
depthwise conv with its one-token step.

``ssd_chunked`` computes every chunk's intra-chunk output and state
contribution with `kernels.ssd_intra_chunk` (B11 on a CUDA tensor, its
plain version on the CPU, differentiable on both); the inter-chunk
recurrence h_c = decay_c h_{c-1} + S_c is a loop over the chunks.  A
per-head B and C (mLSTM's k and q) fold their heads into B11's chunk axis
(H = 1), which is exact: each head's block is an independent chunk.  The
mamba blocks wait for the hybrid family.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ssm_scan import ssd_intra_chunk

__all__ = ["CHUNK", "causal_conv", "causal_conv_step", "ssd_chunked",
           "ssd_step"]

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
    out = torch.einsum("bkc,kc->bc", window, w) + b
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
    upd = torch.einsum("bhp,bn->bhpn", x_t * dt_t[..., None], B_t)
    h_new = decay[..., None, None] * h + upd.to(h.dtype)
    y = torch.einsum("bhpn,bn->bhp", h_new.to(x_t.dtype), C_t)
    return y + D[:, None] * x_t, h_new
