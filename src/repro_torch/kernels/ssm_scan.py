"""Mamba2 SSD intra-chunk block (counterpart of ``repro.kernels.ssm_scan``),
hand-written in CUDA in ``csrc/ssm_scan.cu`` (B11): one launch a call, no
scratch; a tensor-core (3xTF32) route for 16 <= Q <= 128 and an f32 route
bound by the states' bytes for Q < 16 (decode), chosen in the kernel's C
entry point.

For each chunk g of Q steps and head h:

    y_i = sum_{j <= i} (C_i . B_j) exp(a_i - a_j) dt_j x_j      (x's dtype)
    S   = sum_j exp(a_{Q-1} - a_j) dt_j x_j (outer) B_j        (f32)

x: (G, Q, H, P) float32 or bfloat16; dt and a_cum: (G, Q, H) float32; Bm
and Cm: (G, Q, N) in x's dtype, shared by the H heads (a per-head B and C
folds its heads into G with H = 1).  1 <= Q <= 128.  A tensor on the CPU
goes to the plain version `ref.ssd_intra_chunk_ref`; a CUDA tensor
launches the kernel (and counts the launch) or raises.

The reference has no backward for its kernel; training here goes through
`ssd_intra_chunk` too: its backward recomputes the plain version from the
saved inputs and differentiates that (`_SsdIntraChunk`).
"""
from __future__ import annotations

import torch

from . import ref
from .build import (check_status, dtype_code, launch_counts, library,
                    stream_ptr)

__all__ = ["ssd_intra_chunk", "MAX_CHUNK"]

MAX_CHUNK = 128


def _check(x, dt, a_cum, Bm, Cm) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (G, Q, H, P), got {tuple(x.shape)}")
    G, Q, H, _ = x.shape
    if dt.shape != (G, Q, H) or a_cum.shape != (G, Q, H):
        raise ValueError(f"dt and a_cum must be {(G, Q, H)}, got "
                         f"{tuple(dt.shape)}, {tuple(a_cum.shape)}")
    if Bm.dim() != 3 or Bm.shape[:2] != (G, Q) or Cm.shape != Bm.shape:
        raise ValueError(f"Bm and Cm must be equal (G, Q, N) = ({G}, {Q}, "
                         f"N), got {tuple(Bm.shape)}, {tuple(Cm.shape)}")
    if dt.dtype != torch.float32 or a_cum.dtype != torch.float32:
        raise TypeError(f"dt and a_cum must be float32, got {dt.dtype}, "
                        f"{a_cum.dtype}")
    if Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"Bm and Cm must have x's dtype {x.dtype}, got "
                        f"{Bm.dtype}, {Cm.dtype}")
    if any(t.device != x.device for t in (dt, a_cum, Bm, Cm)):
        raise ValueError("ssd_intra_chunk inputs must be on one device")


def _forward(x, dt, a_cum, Bm, Cm):
    if x.device.type == "cpu":
        return ref.ssd_intra_chunk_ref(x, dt, a_cum, Bm, Cm)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_intra_chunk runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    G, Q, H, P = x.shape
    N = Bm.shape[-1]
    if not 1 <= Q <= MAX_CHUNK:
        raise ValueError(f"chunk length must be 1..{MAX_CHUNK}, got {Q}")
    if min(G, H, P, N) < 1:
        raise ValueError(f"empty ssd_intra_chunk shape {(G, Q, H, P, N)}")
    if not all(t.is_contiguous() for t in (x, dt, a_cum, Bm, Cm)):
        raise ValueError("ssd_intra_chunk needs contiguous inputs")
    y = torch.empty_like(x)
    states = torch.empty((G, H, P, N), dtype=torch.float32, device=x.device)
    status = library("ssm_scan").ssd_intra_chunk_fwd(
        dtype_code(x.dtype), x.data_ptr(), dt.data_ptr(), a_cum.data_ptr(),
        Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), states.data_ptr(), G, Q,
        H, P, N, stream_ptr(x.device))
    check_status("ssd_intra_chunk", status)
    launch_counts["ssd_intra_chunk"] += 1
    return y, states


class _SsdIntraChunk(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU).  Backward:
    autograd through the plain version, recomputed from the saved
    inputs."""

    @staticmethod
    def forward(ctx, x, dt, a_cum, Bm, Cm):
        ctx.save_for_backward(x, dt, a_cum, Bm, Cm)
        return _forward(x, dt, a_cum, Bm, Cm)

    @staticmethod
    def backward(ctx, gy, gs):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            outs = ref.ssd_intra_chunk_ref(*inputs)
        pairs = [(o, g) for o, g in zip(outs, (gy, gs)) if g is not None]
        grads = iter(torch.autograd.grad(
            [o for o, _ in pairs], [t for t in inputs if t.requires_grad],
            [g for _, g in pairs], allow_unused=True))
        return tuple(next(grads) if t.requires_grad else None
                     for t in inputs)


def ssd_intra_chunk(x: torch.Tensor, dt: torch.Tensor, a_cum: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor):
    """Returns ``(y_intra (G, Q, H, P) in x's dtype, states (G, H, P, N)
    f32)``, differentiable in every input.  Where no gradient is wanted
    (serving) the call skips the autograd Function: one launch and one
    ctypes call, nothing else on the host."""
    _check(x, dt, a_cum, Bm, Cm)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, a_cum, Bm, Cm)):
        return _SsdIntraChunk.apply(x, dt, a_cum, Bm, Cm)
    return _forward(x, dt, a_cum, Bm, Cm)
