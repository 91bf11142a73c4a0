"""Gossip kernels (counterparts of ``repro.kernels.gossip``), hand-written in
CUDA in ``csrc/gossip.cu``; each accumulates in f32 and writes its output
in X's dtype:

* `gossip_update` (B2): x' = W X - B U;
* `masked_gossip_update` (B4): W_k = Metropolis(mask) computed on chip,
  then W_k X - B U;
* `masked_gossip_update_krng` (B5): B4 with the edge mask drawn in the
  kernel from a threefry key, the mask exported;
* `guarded_gossip_update` (B6): B4 with every off-diagonal link passed
  through a finite guard, the transmits of corrupt senders poisoned.

A tensor on the CPU goes to the plain version in `ref`; a CUDA tensor
launches the kernel (and counts the launch) or raises.  ``out`` may be
``X`` itself: the step writes x' over the parameters in place.
"""
from __future__ import annotations

import torch

from . import ref
from .build import (check_status, dtype_code, launch_counts, library,
                    stream_ptr, to_device)

__all__ = ["gossip_update", "masked_gossip_update",
           "masked_gossip_update_krng", "guarded_gossip_update",
           "MAX_AGENTS"]

MAX_AGENTS = 32


def _check(name: str, X: torch.Tensor, U: torch.Tensor, out,
           mats: dict) -> bool:
    """Validate the shared arguments; True when every tensor lies on the
    CPU (the plain version's case), False for one CUDA device."""
    if X.dim() != 2 or U.shape != X.shape or U.dtype != X.dtype:
        raise ValueError(f"X and U must be equal (m, n) matrices of one "
                         f"dtype, got {tuple(X.shape)} {X.dtype} and "
                         f"{tuple(U.shape)} {U.dtype}")
    m = X.shape[0]
    for label, t in mats.items():
        if t.shape != (m, m):
            raise ValueError(f"{label} must be ({m}, {m}), got "
                             f"{tuple(t.shape)}")
    if not 1 <= m <= MAX_AGENTS:
        raise ValueError(f"{name} takes 1..{MAX_AGENTS} agents, got {m}")
    if out is not None and (out.shape != X.shape or out.dtype != X.dtype
                            or out.device != X.device):
        raise ValueError("out must match X in shape, dtype and device")
    devices = {t.device for t in (X, U, *mats.values())}
    if devices == {torch.device("cpu")}:
        return True
    if len(devices) != 1 or X.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors on one "
                         f"device, got {sorted(map(str, devices))}")
    if any(t.dtype != torch.float32 for t in mats.values()):
        raise TypeError(f"{name}: {', '.join(mats)} must be float32")
    return False


def _columns(name: str, *bufs: torch.Tensor) -> None:
    """The kernels' layout: contiguous rows, n a multiple of 8, rows
    aligned to 8 elements."""
    n = bufs[0].shape[1]
    vec_bytes = 8 * bufs[0].element_size()
    if n % 8 or not all(t.is_contiguous() and t.data_ptr() % vec_bytes == 0
                        for t in bufs):
        raise ValueError(f"{name} needs contiguous buffers with n a "
                         f"multiple of 8 and rows aligned to 8 elements")


def _plain_out(v: torch.Tensor, out):
    return v if out is None else out.copy_(v)


def gossip_update(W: torch.Tensor, B: torch.Tensor, X: torch.Tensor,
                  U: torch.Tensor,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """W, B: (m, m) float32; X, U: (m, n) float32/bfloat16, m <= 32."""
    if _check("gossip_update", X, U, out, {"W": W, "B": B}):
        return _plain_out(ref.gossip_ref(W, B, X, U), out)
    if out is None:
        out = torch.empty_like(X)
    _columns("gossip_update", X, U, out)
    W, B = W.contiguous(), B.contiguous()
    status = library("gossip").gossip_update(
        dtype_code(X.dtype), W.data_ptr(), B.data_ptr(), X.data_ptr(),
        U.data_ptr(), out.data_ptr(), X.shape[0], X.shape[1],
        stream_ptr(X.device))
    check_status("gossip_update", status)
    launch_counts["gossip_update"] += 1
    return out


def masked_gossip_update(mask: torch.Tensor, B: torch.Tensor,
                         X: torch.Tensor, U: torch.Tensor,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """x' = metropolis(mask) X - B U.  ``mask``: (m, m) float32 symmetric
    0/1 with a zero diagonal (`core.mixing.MixingProcess.realize`); the
    kernel computes W_k from it, bit for bit `ref.metropolis_ref`."""
    if _check("masked_gossip_update", X, U, out, {"mask": mask, "B": B}):
        return _plain_out(ref.masked_gossip_ref(mask, B, X, U), out)
    if out is None:
        out = torch.empty_like(X)
    _columns("masked_gossip_update", X, U, out)
    mask, B = mask.contiguous(), B.contiguous()
    status = library("gossip").masked_gossip_update(
        dtype_code(X.dtype), mask.data_ptr(), B.data_ptr(), X.data_ptr(),
        U.data_ptr(), out.data_ptr(), X.shape[0], X.shape[1],
        stream_ptr(X.device))
    check_status("masked_gossip_update", status)
    launch_counts["masked_gossip_update"] += 1
    return out


def masked_gossip_update_krng(key: torch.Tensor, keep_prob,
                              adj: torch.Tensor, B: torch.Tensor,
                              X: torch.Tensor, U: torch.Tensor,
                              out: torch.Tensor | None = None):
    """`masked_gossip_update` on the mask drawn in the kernel: returns
    ``(out, mask)``.

    ``key``: a (2,) threefry key (int64 words, on the CPU) — the mask is
    that of ``prng.bits(key, (m, m))``: one U[0, 1) per undirected edge,
    kept if below ``keep_prob`` (a float, compared in float32) and if
    ``adj`` (m, m off-diagonal 0/1) has the edge.  With
    ``MixingProcess.mask_key(step)``, ``keep_prob`` and ``mask_adj()`` it
    is that process's realized mask bit for bit."""
    key = torch.as_tensor(key)
    if key.shape != (2,):
        raise ValueError(f"key must be a (2,) threefry key, got "
                         f"{tuple(key.shape)}")
    keep_prob = float(keep_prob)
    if _check("masked_gossip_update_krng", X, U, out, {"adj": adj, "B": B}):
        v, mask = ref.masked_gossip_krng_ref(key, keep_prob, adj, B, X, U)
        return _plain_out(v, out), mask
    if out is None:
        out = torch.empty_like(X)
    _columns("masked_gossip_update_krng", X, U, out)
    m = X.shape[0]
    k0, k1 = (int(w) & 0xFFFFFFFF for w in key.to(torch.int64).tolist())
    mask = torch.empty((m, m), dtype=torch.float32, device=X.device)
    adj, B = adj.contiguous(), B.contiguous()
    status = library("gossip").masked_gossip_update_krng(
        dtype_code(X.dtype), k0, k1, keep_prob, adj.data_ptr(),
        B.data_ptr(), X.data_ptr(), U.data_ptr(), out.data_ptr(),
        mask.data_ptr(), m, X.shape[1], stream_ptr(X.device))
    check_status("masked_gossip_update_krng", status)
    launch_counts["masked_gossip_update_krng"] += 1
    return out, mask


_MODE_CODES = {"nan": 0, "inf": 1, "scale": 2}


def guarded_gossip_update(mask: torch.Tensor, B: torch.Tensor,
                          X: torch.Tensor, U: torch.Tensor,
                          XT: torch.Tensor | None = None,
                          UT: torch.Tensor | None = None,
                          clip: float | None = 1e3, *,
                          corrupt: torch.Tensor | None = None,
                          mode: str = "nan", scale: float = 1e4,
                          out: torch.Tensor | None = None) -> torch.Tensor:
    """Gossip with a per-link finite guard (`ref.guarded_gossip_ref`):
    Metropolis weights from ``mask`` as `masked_gossip_update`, self terms
    from the clean X, U, and every off-diagonal link w_ij xt_j - b_ij ut_j
    passed through ``where(isfinite(v), clip(v, ±clip), 0)`` before the sum
    (``clip=None``: no guard).

    The transmit buffers are either given (``XT``, ``UT``, the reference's
    form) or formed from X, U and the (m,) 0/1 ``corrupt`` vector by
    ``mode``/``scale`` (`ref.poison_transmit`) — on the card in registers,
    so the step stages no transmit buffer."""
    if (XT is None) != (UT is None):
        raise ValueError("pass both XT and UT, or neither")
    if XT is not None and corrupt is not None:
        raise ValueError("pass the transmit buffers or corrupt, not both")
    if mode not in _MODE_CODES:
        raise ValueError(f"unknown corrupt mode {mode!r}; have "
                         f"{tuple(_MODE_CODES)}")
    if XT is not None and (XT.shape != X.shape or UT.shape != X.shape
                           or XT.dtype != X.dtype or UT.dtype != X.dtype
                           or XT.device != X.device
                           or UT.device != X.device):
        raise ValueError("XT and UT must match X in shape, dtype and device")
    m = X.shape[0]
    if corrupt is not None and corrupt.shape != (m,):
        raise ValueError(f"corrupt must be ({m},), got "
                         f"{tuple(corrupt.shape)}")
    if _check("guarded_gossip_update", X, U, out, {"mask": mask, "B": B}):
        if XT is None:
            c = corrupt if corrupt is not None else torch.zeros(m)
            XT = ref.poison_transmit(X, c, mode, scale)
            UT = ref.poison_transmit(U, c, mode, scale)
        return _plain_out(ref.guarded_gossip_ref(mask, B, X, U, XT, UT,
                                                 clip), out)
    if out is None:
        out = torch.empty_like(X)
    staged = XT is not None
    _columns("guarded_gossip_update", X, U, out,
             *((XT, UT) if staged else ()))
    corrupt_dev = (to_device(corrupt.to(torch.float32).contiguous(),
                             X.device) if corrupt is not None else None)
    # the scale as the buffer's dtype holds it (bf16: 1e4 -> 9984)
    scale_t = float(torch.tensor(scale, dtype=X.dtype))
    mask, B = mask.contiguous(), B.contiguous()
    status = library("gossip").guarded_gossip_update(
        dtype_code(X.dtype), mask.data_ptr(), B.data_ptr(), X.data_ptr(),
        U.data_ptr(), XT.data_ptr() if staged else None,
        UT.data_ptr() if staged else None,
        corrupt_dev.data_ptr() if corrupt_dev is not None else None,
        _MODE_CODES[mode], scale_t, 0.0 if clip is None else float(clip),
        int(clip is not None), out.data_ptr(), m, X.shape[1],
        stream_ptr(X.device))
    check_status("guarded_gossip_update", status)
    launch_counts["guarded_gossip_update"] += 1
    return out
