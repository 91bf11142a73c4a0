"""Slot-paged decode cache for continuous batching (counterpart of
``repro.serve.cache``).

The engine keeps ONE fixed-capacity cache slab per model cache leaf,
shaped by ``bundle.cache_spec(slots, max_seq_len)``; each request owns a
*page*, its batch-row slice across every leaf.  Admission writes a freshly
prefilled page into a free slot IN PLACE, by slice assignment along that
leaf's batch axis: the slab is never reallocated and the other slots' live
state is untouched.  Retirement only marks the slot free; the next
admission overwrites the stale page.

The layout is derived from each leaf's *logical* axis names: the batch
axis is the ``"batch"`` entry, the ring axis the ``"kv_seq"`` one.  A KV
ring leaf is written from the request's prompt-length ring into the first
positions of the slab's capacity C and the rest of the page is zeroed;
that is exact because for prompt length Lp <= C the ring layout is the
identity on positions 0..Lp-1, and slots >= Lp stay masked by
``decode_cache_valid`` until decode writes them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["LeafLayout", "SlotCacheLayout", "make_layout", "write_slot",
           "read_slot"]


@dataclasses.dataclass(frozen=True)
class LeafLayout:
    shape: tuple[int, ...]
    logical: tuple[str | None, ...]
    dtype: torch.dtype
    batch_axis: int | None   # None => static leaf (no per-slot page)
    seq_axis: int | None     # index of the "kv_seq" dim, if any


@dataclasses.dataclass(frozen=True)
class SlotCacheLayout:
    """Per-leaf slab layouts for a ``slots``-wide decode batch."""

    slots: int
    max_seq_len: int
    leaves: dict[str, LeafLayout]

    def init(self, device="cpu") -> dict[str, torch.Tensor]:
        """Zero-initialized cache slab (every slot free/invalid)."""
        return {name: torch.zeros(l.shape, dtype=l.dtype, device=device)
                for name, l in self.leaves.items()}


def make_layout(bundle, slots: int, max_seq_len: int) -> SlotCacheLayout:
    leaves = {}
    for name, entry in bundle.cache_spec(slots, max_seq_len).items():
        shape, logical, dt = entry if len(entry) == 3 else (*entry, None)
        dtype = dt if dt is not None else bundle.dtype
        # zero-sized leaves carry no state: no paging
        batch_axis = (logical.index("batch")
                      if "batch" in logical and 0 not in shape else None)
        seq_axis = logical.index("kv_seq") if "kv_seq" in logical else None
        leaves[name] = LeafLayout(tuple(shape), tuple(logical), dtype,
                                  batch_axis, seq_axis)
    return SlotCacheLayout(slots=slots, max_seq_len=max_seq_len,
                           leaves=leaves)


def write_slot(layout: SlotCacheLayout, cache: dict, page: dict,
               slot: int) -> dict:
    """Write a B=1 prefill cache (``page``) into batch row ``slot`` of the
    slab ``cache`` in place, and return ``cache``.  A KV-ring leaf shorter
    than the slab's capacity fills the first positions of the row; the
    rest of the row is zeroed (see the module docstring for why that is
    exact)."""
    slot = int(slot)
    for name, l in layout.leaves.items():
        if l.batch_axis is None:
            continue
        p = page[name]
        row = cache[name].narrow(l.batch_axis, slot, 1)
        if l.seq_axis is None:
            row.copy_(p)
            continue
        have, want = p.shape[l.seq_axis], l.shape[l.seq_axis]
        if have > want:
            raise ValueError(f"cache leaf {name!r}: request ring length "
                             f"{have} exceeds slab capacity {want}")
        row.narrow(l.seq_axis, 0, have).copy_(p)
        if have < want:
            row.narrow(l.seq_axis, have, want - have).zero_()
    return cache


def read_slot(layout: SlotCacheLayout, cache: dict, slot: int) -> dict:
    """Batch row ``slot`` copied back out as a B=1 page (round trip of
    `write_slot` up to the kv_seq zero padding)."""
    slot = int(slot)
    return {name: (cache[name] if l.batch_axis is None else
                   cache[name].narrow(l.batch_axis, slot, 1).clone())
            for name, l in layout.leaves.items()}
