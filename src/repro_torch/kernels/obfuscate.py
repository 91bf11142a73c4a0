"""Gradient-obfuscation kernels (counterparts of
``repro.kernels.obfuscate``), hand-written in CUDA in ``csrc/obfuscate.cu``.

    v = w_self * x - b_self * (lambda ∘ g),   lambda = 2 lam_bar U(bits)

`obfuscate_update` takes the uint32 bits as an input (B1);
`obfuscate_update_krng` draws them in the kernel with threefry2x32 from a
per-(row, leaf) key table (B3), so the realized Lambda equals the
reference's ``jax.random`` counter stream bit for bit, in the stream its
``partitionable`` argument names (`core.prng`).

A tensor on the CPU goes to the plain version in `ref`; a CUDA tensor
launches the kernel (and counts the launch) or raises.  ``out`` may be
``g`` itself: the step writes u over the gradients in place.
"""
from __future__ import annotations

import torch

from . import ref
from .build import (check_status, dtype_code, launch_counts, library,
                    stream_ptr, to_device)

__all__ = ["obfuscate_update", "obfuscate_update_krng"]


def _scalars(lam_bar, w_self, b_self, device) -> torch.Tensor:
    """[lam_bar, w_self, b_self] as a (3,) f32 tensor on ``device``; python
    numbers become device fills, not host-to-device copies."""
    def one(v):
        if isinstance(v, torch.Tensor):
            return v.to(device=device, dtype=torch.float32).reshape(())
        return torch.full((), float(v), dtype=torch.float32, device=device)
    return torch.stack([one(v) for v in (lam_bar, w_self, b_self)])


def _check_xg(x: torch.Tensor, g: torch.Tensor, out):
    if x.dim() != 2 or x.shape != g.shape:
        raise ValueError(f"x and g must be equal (R, C) matrices, got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    if x.dtype != g.dtype:
        raise TypeError(f"x and g must share a dtype, got {x.dtype}, "
                        f"{g.dtype}")
    if x.device != g.device:
        raise ValueError("x and g must be on one device")
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype
                            or out.device != x.device):
        raise ValueError("out must match x in shape, dtype and device")


def _aligned(t: torch.Tensor, nbytes: int) -> bool:
    return t.data_ptr() % nbytes == 0


def row_stride(name: str, *bufs: torch.Tensor) -> int:
    """The common row stride of (R, n) buffers whose rows are contiguous:
    n for contiguous buffers, the flat buffer's width for one leaf's
    columns of it (the leafwise layout reads them in place)."""
    lds = {t.stride(0) if t.shape[0] > 1 else t.shape[1] for t in bufs}
    if (any(t.shape[1] > 1 and t.stride(1) != 1 for t in bufs)
            or len(lds) != 1):
        raise ValueError(f"{name} needs buffers with contiguous rows and one "
                         f"row stride, got strides "
                         f"{[tuple(t.stride()) for t in bufs]}")
    ld = lds.pop()
    if ld < bufs[0].shape[1]:
        raise ValueError(f"{name}: row stride {ld} below the row length "
                         f"{bufs[0].shape[1]}")
    return ld


def obfuscate_update(x: torch.Tensor, g: torch.Tensor, bits: torch.Tensor,
                     lam_bar, w_self, b_self,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """x, g: (R, C) float32/bfloat16; bits: (R, C) ``torch.uint32``.
    Returns v (R, C) in x's dtype (written into ``out`` when given).  On
    the card the four may be column ranges of wider buffers (rows
    contiguous, one row stride): the leafwise layout's per-leaf call."""
    _check_xg(x, g, out)
    if bits.shape != x.shape or bits.dtype != torch.uint32:
        raise ValueError("bits must be a torch.uint32 tensor shaped like x")
    if x.device.type == "cpu":
        v = ref.obfuscate_ref(x, g, bits, lam_bar, w_self, b_self)
        return v if out is None else out.copy_(v)
    if x.device.type != "cuda" or bits.device != x.device:
        raise ValueError(f"obfuscate_update runs on CUDA or CPU tensors, got "
                         f"{x.device} / {bits.device}")
    if out is None:
        out = torch.empty_like(x)
    ld = row_stride("obfuscate_update", x, g, bits, out)
    scal = _scalars(lam_bar, w_self, b_self, x.device)
    lib = library("obfuscate")
    status = lib.obfuscate_update(
        dtype_code(x.dtype), x.data_ptr(), g.data_ptr(), bits.data_ptr(),
        scal.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], ld,
        stream_ptr(x.device))
    check_status("obfuscate_update", status)
    launch_counts["obfuscate_update"] += 1
    return out


def obfuscate_update_krng(x: torch.Tensor, g: torch.Tensor,
                          keys: torch.Tensor, offsets: torch.Tensor,
                          lam_bar, w_self, b_self,
                          out: torch.Tensor | None = None,
                          return_bits: bool = False,
                          partitionable: bool = True):
    """`obfuscate_update` with the bits drawn in the kernel.

    ``keys``: (R, n_leaves, 2) uint32 words (as ``torch.uint32`` or int64
    holding uint32 values, on the host or on x's device) — row a's key
    for leaf l; ``offsets``:
    (n_leaves + 1,) int64 column offsets of the leaves, ``offsets[0] == 0``
    and ``offsets[-1] <= C`` (the columns past it are padding and draw
    bits 0).  ``partitionable=False`` draws jax's earlier threefry
    stream (`core.prng`; a second instance of the kernel).  Returns v, or
    ``(v, bits)`` with ``return_bits`` (the parity check; the training
    step never asks for the bits).
    """
    _check_xg(x, g, out)
    R, C = x.shape
    offsets = torch.as_tensor(offsets, dtype=torch.int64)
    n_leaves = offsets.numel() - 1
    if keys.shape != (R, n_leaves, 2):
        raise ValueError(f"keys must be (R, n_leaves, 2) = "
                         f"{(R, n_leaves, 2)}, got {tuple(keys.shape)}")
    if x.device.type == "cpu":
        v, bits = ref.obfuscate_krng_ref(x, g, keys, offsets, lam_bar,
                                         w_self, b_self, partitionable)
        if out is not None:
            v = out.copy_(v)
        return (v, bits) if return_bits else v
    if x.device.type != "cuda":
        raise ValueError(f"obfuscate_update_krng runs on CUDA or CPU tensors, "
                         f"got {x.device}")
    if C % 8 or not 1 <= n_leaves <= 1024:
        raise ValueError(f"needs C % 8 == 0 and 1..1024 leaves, got C={C}, "
                         f"{n_leaves} leaves")
    if out is None:
        out = torch.empty_like(x)
    if not all(t.is_contiguous() and _aligned(t, 8 * t.element_size())
               for t in (x, g, out)):
        raise ValueError("obfuscate_update_krng needs contiguous tensors "
                         "aligned to 8 elements")
    # a uint32 table and offsets already on the card are used as they
    # are (a CUDA graph's step derives them there); host ones are copied
    if keys.dtype != torch.uint32:
        keys = keys.to(torch.int64).to(torch.uint32)
    keys32 = to_device(keys.contiguous(), x.device)
    offsets = to_device(offsets, x.device)
    bits = (torch.empty((R, C), dtype=torch.uint32, device=x.device)
            if return_bits else None)
    scal = _scalars(lam_bar, w_self, b_self, x.device)
    lib = library("obfuscate")
    status = lib.obfuscate_update_krng(
        dtype_code(x.dtype), x.data_ptr(), g.data_ptr(), keys32.data_ptr(),
        offsets.data_ptr(), n_leaves, R, C, scal.data_ptr(), out.data_ptr(),
        bits.data_ptr() if bits is not None else None,
        int(not partitionable), stream_ptr(x.device))
    check_status("obfuscate_update_krng", status)
    launch_counts["obfuscate_update_krng"] += 1
    return (out, bits) if return_bits else out
