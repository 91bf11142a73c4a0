"""Gossip kernel (counterpart of ``repro.kernels.gossip.gossip_update``),
hand-written in CUDA in ``csrc/gossip.cu``: x' = W X - B U over the agent
axis, f32 accumulation, output in X's dtype.

A tensor on the CPU goes to the plain version in `ref`; a CUDA tensor
launches the kernel (and counts the launch) or raises.  ``out`` may be
``X`` itself: the step writes x' over the parameters in place.
"""
from __future__ import annotations

import torch

from . import ref
from .build import check_status, dtype_code, launch_counts, library, stream_ptr

__all__ = ["gossip_update", "MAX_AGENTS"]

MAX_AGENTS = 32


def gossip_update(W: torch.Tensor, B: torch.Tensor, X: torch.Tensor,
                  U: torch.Tensor,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """W, B: (m, m) float32; X, U: (m, n) float32/bfloat16, m <= 32."""
    if X.dim() != 2 or U.shape != X.shape or U.dtype != X.dtype:
        raise ValueError(f"X and U must be equal (m, n) matrices of one "
                         f"dtype, got {tuple(X.shape)} {X.dtype} and "
                         f"{tuple(U.shape)} {U.dtype}")
    m, n = X.shape
    if W.shape != (m, m) or B.shape != (m, m):
        raise ValueError(f"W and B must be ({m}, {m})")
    if not 1 <= m <= MAX_AGENTS:
        raise ValueError(f"gossip_update takes 1..{MAX_AGENTS} agents, "
                         f"got {m}")
    if out is not None and (out.shape != X.shape or out.dtype != X.dtype
                            or out.device != X.device):
        raise ValueError("out must match X in shape, dtype and device")
    devices = {t.device for t in (W, B, X, U)}
    if devices == {torch.device("cpu")}:
        v = ref.gossip_ref(W, B, X, U)
        return v if out is None else out.copy_(v)
    if len(devices) != 1 or X.device.type != "cuda":
        raise ValueError(f"gossip_update runs on CUDA or CPU tensors on one "
                         f"device, got {sorted(map(str, devices))}")
    if W.dtype != torch.float32 or B.dtype != torch.float32:
        raise TypeError("W and B must be float32")
    if out is None:
        out = torch.empty_like(X)
    vec_bytes = 8 * X.element_size()
    if n % 8 or not all(t.is_contiguous() and t.data_ptr() % vec_bytes == 0
                        for t in (X, U, out)):
        raise ValueError("gossip_update needs contiguous X, U, out with n a "
                         "multiple of 8 and rows aligned to 8 elements")
    W = W.contiguous()
    B = B.contiguous()
    lib = library("gossip")
    status = lib.gossip_update(
        dtype_code(X.dtype), W.data_ptr(), B.data_ptr(), X.data_ptr(),
        U.data_ptr(), out.data_ptr(), m, n, stream_ptr(X.device))
    check_status("gossip_update", status)
    launch_counts["gossip_update"] += 1
    return out
