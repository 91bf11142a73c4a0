"""Share weights with the reference: ``params_from_numpy`` turns a JAX
parameter pytree, converted leaf by leaf to numpy (``jax.tree.map(
np.asarray, params)``), into the port's parameter tree with the same leaf
names, order, shapes and dtypes.  bfloat16 leaves (numpy's ``ml_dtypes``
type) are carried over bit for bit."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_numpy"]


def _leaf(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_numpy(tree, device=None):
    """Nested dict (or single array) of numpy arrays -> torch tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(tree[k], device) for k in sorted(tree)}
    t = _leaf(tree)
    return t if device is None else t.to(device)

