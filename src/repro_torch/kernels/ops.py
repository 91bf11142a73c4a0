"""The fused Eq. (4) update over a flat agent buffer (counterpart of
``repro.kernels.ops.fused_pdsgd_tree``, concat layout):

    u  = Lambda ∘ g        (obfuscate kernel, w_self = 0, b_self = -1)
    x' = W X - B U         (gossip kernel)

The reference flattens each agent's leaves, concatenates them in tree
order and pads the columns to a multiple of 512 on every step.  The port
keeps the agents' parameters as views into one such (m, D_pad) buffer
for the whole run (PyTorch's flat-parameter idiom), so flatten/concat is
free; `FlatLayout` records the column order — the same as
``ops.py::_flatten_concat``/``_pad_cols`` — and hands out the views.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..core.privacy import tree_leaves, tree_paths, tree_unflatten
from .gossip import gossip_update
from .obfuscate import obfuscate_update, obfuscate_update_krng

__all__ = ["FlatLayout", "fused_pdsgd_flat", "fused_pdsgd_tree", "PAD"]

PAD = 512


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Column layout of one agent's parameter tree in a flat row: leaf l
    (in ``jax.tree.flatten`` order) occupies columns
    ``[offsets[l], offsets[l+1])``, row-major; columns from ``offsets[-1]``
    to ``width`` are zero padding up to a multiple of 512."""

    paths: tuple[str, ...]
    shapes: tuple[tuple[int, ...], ...]
    offsets: tuple[int, ...]
    width: int
    template: object  # the tree, for rebuilding its structure

    @classmethod
    def of(cls, tree) -> "FlatLayout":
        """Layout of a single-agent tree (leaves without the agent axis)."""
        leaves = tree_leaves(tree)
        shapes = tuple(tuple(int(s) for s in l.shape) for l in leaves)
        offsets = [0]
        for s in shapes:
            offsets.append(offsets[-1] + math.prod(s))
        width = -(-offsets[-1] // PAD) * PAD
        skeleton = tree_unflatten(tree, [None] * len(leaves))
        return cls(tuple(tree_paths(tree)), shapes, tuple(offsets), width,
                   skeleton)

    @property
    def n_leaves(self) -> int:
        return len(self.shapes)

    @property
    def size(self) -> int:
        """Parameters per agent, without padding."""
        return self.offsets[-1]

    def leaf_views(self, row: torch.Tensor) -> list[torch.Tensor]:
        """Views of one agent's (width,) row as its leaves (or, for an
        (m, width) buffer, as (m, ...) leaves)."""
        lead = tuple(row.shape[:-1])
        return [row[..., o:o + math.prod(s)].view(lead + s)
                for o, s in zip(self.offsets, self.shapes)]

    def tree(self, row: torch.Tensor):
        """`leaf_views` rebuilt into the tree's structure."""
        return tree_unflatten(self.template, self.leaf_views(row))

    def flatten(self, tree, m: int) -> torch.Tensor:
        """Copy a tree of (m, ...) leaves into a fresh zero-padded (m, width)
        buffer."""
        leaves = tree_leaves(tree)
        buf = torch.zeros((m, self.width), dtype=leaves[0].dtype,
                          device=leaves[0].device)
        for view, leaf in zip(self.leaf_views(buf), leaves):
            view.copy_(leaf)
        return buf


def fused_pdsgd_flat(W: torch.Tensor, B: torch.Tensor, X: torch.Tensor,
                     G: torch.Tensor, lam_bar, *,
                     keys: torch.Tensor | None = None,
                     offsets: torch.Tensor | None = None,
                     bits: torch.Tensor | None = None,
                     in_place: bool = False):
    """Eq. (4) on flat (m, width) buffers.  Returns ``(x', u)``.

    With ``keys`` (m, n_leaves, 2) and ``offsets`` the obfuscate stage
    draws Lambda in the kernel (`obfuscate_update_krng`); with ``bits``
    (m, width) uint32 it reads them (`obfuscate_update`).  ``in_place``
    writes u over G and x' over X — safe because both kernels read every
    element they write before writing it — which is how the training step
    runs (no (m, width) buffer is allocated per step).
    """
    if (keys is None) == (bits is None):
        raise ValueError("pass exactly one of keys (in-kernel Lambda) or "
                         "bits")
    u_out = G if in_place else None
    if keys is not None:
        U = obfuscate_update_krng(X, G, keys, offsets, lam_bar, 0.0, -1.0,
                                  out=u_out)
    else:
        U = obfuscate_update(X, G, bits, lam_bar, 0.0, -1.0, out=u_out)
    out = gossip_update(W, B, X, U, out=X if in_place else None)
    return out, U


def fused_pdsgd_tree(W, B, x_tree, g_tree, lam_bar, *, keys):
    """Tree-level form of `fused_pdsgd_flat` with the in-kernel Lambda
    (leaves with a leading (m,) agent axis), for callers that hold trees:
    flattens into fresh buffers, returns ``(x'_tree, {"x": (m, D), "u": (m, D)})`` — the
    padding stripped, like the reference's ``observe=True`` flats."""
    m = tree_leaves(x_tree)[0].shape[0]
    layout = FlatLayout.of(tree_unflatten(
        x_tree, [l[0] for l in tree_leaves(x_tree)]))
    X = layout.flatten(x_tree, m)
    G = layout.flatten(g_tree, m)
    offsets = torch.tensor(layout.offsets, dtype=torch.int64)
    out, U = fused_pdsgd_flat(W, B, X, G, lam_bar, keys=keys,
                              offsets=offsets)
    D = layout.size
    return layout.tree(out), {"x": X[:, :D].float(), "u": U[:, :D].float()}
