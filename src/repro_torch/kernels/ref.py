"""Plain PyTorch versions of the hand-written kernels.

The wrappers in `obfuscate` and `gossip` use these for tensors on the CPU;
the tests and ``chip_smoke.py`` hold the CUDA kernels against them on the
card.  They repeat the kernels' arithmetic operation for operation (each
product and difference rounded once, in f32), which is what makes the
obfuscate kernels bitwise comparable.
"""
from __future__ import annotations

import torch

from ..core import prng

__all__ = ["obfuscate_ref", "obfuscate_krng_ref", "gossip_ref"]


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32).to(device)


def obfuscate_ref(x: torch.Tensor, g: torch.Tensor, bits: torch.Tensor,
                  lam_bar, w_self, b_self) -> torch.Tensor:
    """v = w_self x - b_self (lambda ∘ g), lambda = 2 lam_bar U(bits)."""
    dev = x.device
    lam = (2.0 * _f32(lam_bar, dev)) * prng.bits_to_uniform(bits)
    u = lam * g.float()
    return (_f32(w_self, dev) * x.float() - _f32(b_self, dev) * u).to(x.dtype)


def obfuscate_krng_ref(x: torch.Tensor, g: torch.Tensor, keys: torch.Tensor,
                       offsets: torch.Tensor, lam_bar, w_self, b_self):
    """`obfuscate_ref` fed the bits the in-kernel generator draws
    (`prng.leaf_bits`): ``(v, bits)``."""
    bits = prng.leaf_bits(keys, offsets, x.shape[0], x.shape[1])
    return obfuscate_ref(x, g, bits, lam_bar, w_self, b_self), bits


def gossip_ref(W: torch.Tensor, B: torch.Tensor, X: torch.Tensor,
               U: torch.Tensor) -> torch.Tensor:
    """x' = W X - B U over the leading agent dim, accumulated in f32."""
    out = W.float() @ X.float() - B.float() @ U.float()
    return out.to(X.dtype)
