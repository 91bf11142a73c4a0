"""The fused Eq. (4) update over a flat agent buffer (counterpart of
``repro.kernels.ops.fused_pdsgd_tree``, concat layout):

    u  = Lambda ∘ g        (obfuscate kernel, w_self = 0, b_self = -1)
    x' = W X - B U         (a gossip kernel: static W, an edge mask, a mask
                            drawn in-kernel, or the guarded fault path)

and of ``ring_pdsgd_tree`` (the ring layout): both in ONE kernel from the
per-direction tables, u never stored.

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
from .build import to_device
from .gossip import (gossip_update, guarded_gossip_update,
                     masked_gossip_update, masked_gossip_update_krng,
                     ring_obfuscate_gossip, ring_obfuscate_gossip_krng)
from .obfuscate import obfuscate_update, obfuscate_update_krng

__all__ = ["FlatLayout", "fused_pdsgd_flat", "fused_pdsgd_tree",
           "ring_pdsgd_flat", "ring_pdsgd_tree", "PAD"]

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
                     in_place: bool = False,
                     mask: torch.Tensor | None = None,
                     mask_key: torch.Tensor | None = None,
                     mask_keep_prob=None,
                     mask_adj: torch.Tensor | None = None,
                     corrupt: torch.Tensor | None = None,
                     corrupt_mode: str = "nan",
                     corrupt_scale: float = 1e4,
                     guard_clip: float | None = 1e3,
                     partitionable: bool = True):
    """Eq. (4) on flat (m, width) buffers.  Returns ``(x', u)``.

    With ``keys`` (m, n_leaves, 2) and ``offsets`` the obfuscate stage
    draws Lambda in the kernel (`obfuscate_update_krng`, in the threefry
    stream ``partitionable`` names, `core.prng`); with ``bits``
    (m, width) uint32 it reads them (`obfuscate_update`).  ``in_place``
    writes u over G and x' over X — safe because every kernel reads each
    element it writes before writing it — which is how the training step
    runs (no (m, width) buffer is allocated per step).

    The gossip stage, as the reference routes it (``ops.py:159-207``):

    * ``corrupt`` (an (m,) 0/1 vector of corrupt senders) -> the guarded
      kernel over ``mask``, the transmits poisoned by ``corrupt_mode``/
      ``corrupt_scale`` and each link guarded at ``guard_clip`` (None: no
      guard).  Needs ``mask``;
    * ``mask_key`` (a (2,) threefry key) -> the mask drawn in the kernel
      with ``mask_keep_prob`` (required) over the off-diagonal adjacency
      ``mask_adj`` (None: the complete graph); ``mask`` is ignored;
    * ``mask`` -> W_k computed on chip from the edge mask (``W`` ignored);
    * otherwise W X - B U with the given W.
    """
    if (keys is None) == (bits is None):
        raise ValueError("pass exactly one of keys (in-kernel Lambda) or "
                         "bits")
    if mask_key is not None and mask_keep_prob is None:
        raise ValueError("mask_key needs mask_keep_prob (the per-edge keep "
                         "probability, 1 - dropout rate)")
    if mask_key is not None and corrupt is not None:
        raise ValueError("in-kernel mask draw does not compose with corrupt "
                         "injection; pass the realized mask")
    if corrupt is not None and mask is None:
        raise ValueError("corrupt injection needs the realized edge mask; "
                         "compose faults through faults.realize_coupling")
    if mask_key is not None and not partitionable:
        raise ValueError("the in-kernel mask draw is jax's partitionable "
                         "threefry stream only")
    u_out = G if in_place else None
    if keys is not None:
        U = obfuscate_update_krng(X, G, keys, offsets, lam_bar, 0.0, -1.0,
                                  out=u_out, partitionable=partitionable)
    else:
        U = obfuscate_update(X, G, bits, lam_bar, 0.0, -1.0, out=u_out)
    x_out = X if in_place else None
    if corrupt is not None:
        out = guarded_gossip_update(mask, B, X, U, clip=guard_clip,
                                    corrupt=corrupt, mode=corrupt_mode,
                                    scale=corrupt_scale, out=x_out)
    elif mask_key is not None:
        m = X.shape[0]
        adj = mask_adj if mask_adj is not None else 1.0 - torch.eye(m)
        out, _ = masked_gossip_update_krng(mask_key, mask_keep_prob,
                                           to_device(adj, X.device), B, X,
                                           U, out=x_out)
    elif mask is not None:
        out = masked_gossip_update(mask, B, X, U, out=x_out)
    else:
        out = gossip_update(W, B, X, U, out=x_out)
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


def ring_pdsgd_flat(w_tab: torch.Tensor, b_tab: torch.Tensor,
                    perms: torch.Tensor, X: torch.Tensor, G: torch.Tensor,
                    lam_bar, *, keys: torch.Tensor | None = None,
                    offsets: torch.Tensor | None = None,
                    bits: torch.Tensor | None = None,
                    in_place: bool = False, observe: bool = False):
    """Eq. (4) on flat (m, width) buffers through ONE ring kernel: Lambda
    drawn in it from ``keys``/``offsets`` (`ring_obfuscate_gossip_krng`) or
    read from ``bits`` (`ring_obfuscate_gossip`), the obfuscation and the
    per-direction exchange of the tables ``w_tab``/``b_tab`` (m, 1 + ndirs)
    over the shifts ``perms``.  A dropped link is a zero table slot and
    sends an exactly-zero v.  ``in_place`` writes x' over X (the kernel
    reads every row of a column before it writes one); G is only read.

    Returns x', or with ``observe`` ``(x', {"x", "u", "v"})``: the f32
    input x (copied before an in-place write), the kernel's own u (m,
    width) and v (ndirs, m, width), the wire messages sender-major."""
    if (keys is None) == (bits is None):
        raise ValueError("pass exactly one of keys (in-kernel Lambda) or "
                         "bits")
    x_obs = X.to(torch.float32, copy=True) if observe else None
    out = X if in_place else None
    if keys is not None:
        res = ring_obfuscate_gossip_krng(w_tab, b_tab, perms, X, G, keys,
                                         offsets, lam_bar, capture=observe,
                                         out=out)
    else:
        res = ring_obfuscate_gossip(w_tab, b_tab, perms, X, G, bits, lam_bar,
                                    capture=observe, out=out)
    if not observe:
        return res
    x_new, v, u = res
    return x_new, {"x": x_obs, "u": u, "v": v}


def ring_pdsgd_tree(w_tab, b_tab, perms, x_tree, g_tree, lam_bar, *,
                    keys: torch.Tensor | None = None, bits_tree=None,
                    observe: bool = False):
    """Tree-level form of `ring_pdsgd_flat` (leaves with a leading (m,)
    agent axis): flattens into fresh padded buffers, Lambda from ``keys``
    (m, n_leaves, 2) or from ``bits_tree`` (uint32 leaves shaped like the
    gradients).  Returns x'_tree, or ``(x'_tree, {"x", "u", "v"})`` with
    the padding stripped, like the reference's ``observe=True`` flats."""
    m = tree_leaves(x_tree)[0].shape[0]
    layout = FlatLayout.of(tree_unflatten(
        x_tree, [l[0] for l in tree_leaves(x_tree)]))
    X = layout.flatten(x_tree, m)
    G = layout.flatten(g_tree, m)
    bits = layout.flatten(bits_tree, m) if bits_tree is not None else None
    res = ring_pdsgd_flat(w_tab, b_tab, perms, X, G, lam_bar, keys=keys,
                          offsets=torch.tensor(layout.offsets,
                                               dtype=torch.int64),
                          bits=bits, in_place=True, observe=observe)
    if not observe:
        return layout.tree(res)
    out, flats = res
    D = layout.size
    return layout.tree(out), {"x": flats["x"][:, :D], "u": flats["u"][:, :D],
                              "v": flats["v"][:, :, :D]}
