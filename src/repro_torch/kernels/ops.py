"""The fused Eq. (4) update over a flat agent buffer (counterpart of
``repro.kernels.ops.fused_pdsgd_tree``, concat layout):

    u  = Lambda ∘ g        (obfuscate kernel, w_self = 0, b_self = -1)
    x' = W X - B U         (a gossip kernel: static W, an edge mask, a mask
                            drawn in-kernel, or the guarded fault path)

and of ``ring_pdsgd_tree`` (the ring layout): both in ONE kernel from the
per-direction tables, u never stored.  Also the reference's two-pass tree
forms (`obfuscate_tree`, `gossip_tree`: one kernel each over the
concatenated buffer) and its leafwise layout (`sharded_pdsgd_tree`, and
`leafwise_pdsgd_flat` on the flat buffers): the same two kernels once
per leaf, on the leaf's own columns.

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

from ..core import prng
from ..core.privacy import tree_leaves, tree_paths, tree_unflatten
from .build import to_device
from .gossip import (gossip_update, guarded_gossip_update,
                     masked_gossip_update, masked_gossip_update_krng,
                     ring_obfuscate_gossip, ring_obfuscate_gossip_krng)
from .obfuscate import obfuscate_update, obfuscate_update_krng

__all__ = ["FlatLayout", "fused_pdsgd_flat", "fused_pdsgd_tree",
           "ring_pdsgd_flat", "ring_pdsgd_tree", "obfuscate_tree",
           "gossip_tree", "leafwise_pdsgd_flat", "sharded_pdsgd_tree", "PAD"]

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
                     partitionable: bool = True, tap=None):
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

    ``tap(U)``, when given, is called between the two kernels, X still
    x^k and U the obfuscate kernel's u: the wire-tap capture of
    `core.pdsgd.pdsgd_update` forms the messages there.
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
    if tap is not None:
        tap(U)
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
                    in_place: bool = False, observe: bool = False,
                    observe_fields: tuple = ("x", "u", "v")):
    """Eq. (4) on flat (m, width) buffers through ONE ring kernel: Lambda
    drawn in it from ``keys``/``offsets`` (`ring_obfuscate_gossip_krng`) or
    read from ``bits`` (`ring_obfuscate_gossip`), the obfuscation and the
    per-direction exchange of the tables ``w_tab``/``b_tab`` (m, 1 + ndirs)
    over the shifts ``perms``.  A dropped link is a zero table slot and
    sends an exactly-zero v.  ``in_place`` writes x' over X (the kernel
    reads every row of a column before it writes one); G is only read.

    Returns x', or with ``observe`` ``(x', {"x", "u", "v"})``: the f32
    input x (copied before an in-place write), the kernel's own u (m,
    width) and v (ndirs, m, width), the wire messages sender-major; only
    the ``observe_fields`` among them (v always: the kernel writes no u
    without "u")."""
    if (keys is None) == (bits is None):
        raise ValueError("pass exactly one of keys (in-kernel Lambda) or "
                         "bits")
    x_obs = (X.to(torch.float32, copy=True)
             if observe and "x" in observe_fields else None)
    capture = (False if not observe
               else True if "u" in observe_fields else "v")
    out = X if in_place else None
    if keys is not None:
        res = ring_obfuscate_gossip_krng(w_tab, b_tab, perms, X, G, keys,
                                         offsets, lam_bar, capture=capture,
                                         out=out)
    else:
        res = ring_obfuscate_gossip(w_tab, b_tab, perms, X, G, bits, lam_bar,
                                    capture=capture, out=out)
    if not observe:
        return res
    x_new, v, u = res
    flats = {"x": x_obs, "u": u, "v": v}
    return x_new, {k: t for k, t in flats.items()
                   if k in observe_fields or k == "v"}


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


def _layout_of(x_tree) -> tuple[FlatLayout, int]:
    """The `FlatLayout` of one agent of a tree of (m, ...) leaves, and m."""
    leaves = tree_leaves(x_tree)
    return (FlatLayout.of(tree_unflatten(x_tree, [l[0] for l in leaves])),
            leaves[0].shape[0])


def tree_bits(key: torch.Tensor, m: int, layout: FlatLayout,
              pad: int = 256, chunk: int = 1 << 22) -> torch.Tensor:
    """``jax.random.bits(key, (m, D_pad))`` over the concatenated buffer
    padded to a multiple of ``pad`` columns (the reference's
    `obfuscate_tree` draw), laid into an (m, width) uint32 buffer on
    key's device: its first D columns, the rest 0.  Drawn ``chunk``
    columns at a time."""
    D = layout.size
    n_cols = -(-D // pad) * pad
    out = torch.zeros((m, layout.width), dtype=torch.uint32,
                      device=key.device)
    rows = torch.arange(m, dtype=torch.int64, device=key.device)[:, None]
    for c in range(0, D, chunk):
        c1 = min(D, c + chunk)
        idx = rows * n_cols + torch.arange(c, c1, dtype=torch.int64,
                                           device=key.device)[None, :]
        out[:, c:c1] = prng.bits_at(key, idx, m * n_cols).to(torch.uint32)
    return out


def obfuscate_tree(key: torch.Tensor, x_tree, g_tree, lam_bar, w_self,
                   b_self):
    """``v = w_self x - b_self (Lambda ∘ g)`` over a tree of (m, ...)
    leaves in ONE obfuscate kernel (B1) on the concatenated buffer, the
    reference's ``ops.py::obfuscate_tree``: the bits are
    ``jax.random.bits(key, ...)`` over that buffer padded to 256 columns
    (`tree_bits`, drawn on key's device).  Returns the v tree."""
    layout, m = _layout_of(x_tree)
    X = layout.flatten(x_tree, m)
    G = layout.flatten(g_tree, m)
    bits = tree_bits(to_device(key, X.device), m, layout)
    return layout.tree(obfuscate_update(X, G, bits, lam_bar, w_self,
                                        b_self, out=G))


def gossip_tree(W: torch.Tensor, B: torch.Tensor, x_tree, u_tree):
    """``x' = W X - B U`` over a tree of (m, ...) leaves in ONE gossip
    kernel (B2) on the concatenated buffer, the reference's
    ``ops.py::gossip_tree``.  Returns the x' tree."""
    layout, m = _layout_of(x_tree)
    X = layout.flatten(x_tree, m)
    U = layout.flatten(u_tree, m)
    dev = X.device
    return layout.tree(gossip_update(to_device(W, dev), to_device(B, dev),
                                     X, U, out=X))


def _leaf_pdsgd(W, B, x, g, bits, lam_bar, mask, corrupt, corrupt_mode,
                corrupt_scale, guard_clip, u_out, out):
    """One leaf of the leafwise layout, x/g/bits (m, n) (columns of the flat
    buffers, read in place on the card): u = Lambda ∘ g by the obfuscate
    kernel (B1), then the gossip kernel the coupling asks for — the
    guarded one (B6) with ``corrupt``, the masked one (B4) with ``mask``,
    else W X - B U (B2).  The kernels treat columns independently, so
    every column is the concat path's bit for bit."""
    u = obfuscate_update(x, g, bits, lam_bar, 0.0, -1.0, out=u_out)
    if corrupt is not None:
        return guarded_gossip_update(mask, B, x, u, clip=guard_clip,
                                     corrupt=corrupt, mode=corrupt_mode,
                                     scale=corrupt_scale, out=out)
    if mask is not None:
        return masked_gossip_update(mask, B, x, u, out=out)
    return gossip_update(W, B, x, u, out=out)


def leafwise_pdsgd_flat(W: torch.Tensor, B: torch.Tensor, X: torch.Tensor,
                        G: torch.Tensor, bits: torch.Tensor,
                        layout: FlatLayout, lam_bar, *,
                        mask: torch.Tensor | None = None,
                        corrupt: torch.Tensor | None = None,
                        corrupt_mode: str = "nan",
                        corrupt_scale: float = 1e4,
                        guard_clip: float | None = 1e3) -> torch.Tensor:
    """The leafwise layout on the flat (m, width) buffers, in place: per
    leaf of ``layout``, `_leaf_pdsgd` on its columns, u written over G and
    x' over X (two kernel calls a leaf).  ``bits`` (m, width) uint32 laid like
    the buffer (`core.pdsgd.per_agent_bits`), so the realized Lambda is
    the concat path's.  Returns X."""
    if corrupt is not None and mask is None:
        raise ValueError("corrupt injection needs the realized edge mask; "
                         "compose faults through faults.realize_coupling")
    for o, o1 in zip(layout.offsets[:-1], layout.offsets[1:]):
        cols = slice(o, o1)
        _leaf_pdsgd(W, B, X[:, cols], G[:, cols], bits[:, cols], lam_bar,
                    mask, corrupt, corrupt_mode, corrupt_scale, guard_clip,
                    u_out=G[:, cols], out=X[:, cols])
    return X


def sharded_pdsgd_tree(W: torch.Tensor, B: torch.Tensor, x_tree, g_tree,
                       bits_tree, lam_bar, *,
                       mask: torch.Tensor | None = None,
                       corrupt: torch.Tensor | None = None,
                       corrupt_mode: str = "nan",
                       corrupt_scale: float = 1e4,
                       guard_clip: float | None = 1e3):
    """The leafwise Eq. (4) update over a tree of (m, ...) leaves (the
    reference's ``ops.py::sharded_pdsgd_tree`` without a mesh);
    ``bits_tree`` holds the uint32 draws per leaf.  The trees are copied
    into fresh flat buffers and `leafwise_pdsgd_flat` runs B1, then B2
    (B4 with ``mask``, B6 with ``corrupt``) on each leaf's columns, bit
    for bit the concat path's.  Returns a new tree.  The mesh form
    (DTensor leaves) is `dist.sharding.mesh_pdsgd_tree`."""
    layout, m = _layout_of(x_tree)
    X, G, bits = (layout.flatten(t, m) for t in (x_tree, g_tree, bits_tree))
    return layout.tree(leafwise_pdsgd_flat(
        W, B, X, G, bits, layout, lam_bar, mask=mask, corrupt=corrupt,
        corrupt_mode=corrupt_mode, corrupt_scale=corrupt_scale,
        guard_clip=guard_clip))
