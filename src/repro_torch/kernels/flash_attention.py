"""Flash-attention forward (counterpart of
``repro.kernels.flash_attention``), hand-written in CUDA in
``csrc/flash_attention.cu`` (B10).

    o = softmax(q k^T / sqrt(hd) + mask) v,   mask: causal and/or a window

q, k, v: (B, S, H, hd) with equal head counts, float32 (f32 FMAs on the
CUDA cores) or bfloat16 (TMA loads into an mbarrier ring, both products on
wgmma, f32 accumulation); any S >= 1 and any hd that is a multiple of 8 up
to 128.  A tensor on the
CPU goes to the plain version `ref.flash_attention_ref`; a CUDA tensor
launches the kernel (and counts the launch) or raises.
"""
from __future__ import annotations

import torch

from . import ref
from .build import (check_status, dtype_code, launch_counts, library,
                    stream_ptr)

__all__ = ["flash_attention"]

MAX_HEAD_DIM = 128


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """Returns o (B, S, H, hd) in q's dtype.  ``window`` masks keys more
    than ``window`` positions behind the query (None: no window)."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be equal (B, S, H, hd) tensors, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must be on one device")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    B, S, H, hd = q.shape
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must be a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}, got {hd}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v)):
        raise ValueError("flash_attention needs contiguous q, k, v aligned "
                         "to 16 bytes")
    out = torch.empty_like(q)
    status = library("flash_attention").flash_attention_fwd(
        dtype_code(q.dtype), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, S, H, hd, int(causal),
        0 if window is None else int(window), stream_ptr(q.device))
    check_status("flash_attention", status)
    launch_counts["flash_attention"] += 1
    return out
