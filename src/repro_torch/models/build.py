"""Family dispatch: ArchConfig -> ModelBundle (counterpart of
``repro.models.build``; the dense, MoE, VLM, xLSTM, hybrid and enc-dec
(audio) families)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..configs.base import ArchConfig
from . import encdec, hybrid, transformer, xlstm
from .common import init_params

__all__ = ["ModelBundle", "build_model"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_FAMILIES = {"dense": transformer, "moe": transformer, "vlm": transformer,
             "xlstm": xlstm, "hybrid": hybrid, "audio": encdec}


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    param_defs: Any
    loss_fn: Callable     # (params, batch) -> scalar
    prefill_fn: Callable  # (params, batch) -> {logits, cache, pos}
    decode_fn: Callable   # (params, token, cache, pos) -> {logits, cache,
                          # pos}; pos a scalar (lockstep batch) or (B,)
                          # (per-slot continuous batching); cache in place
    cache_spec: Callable  # (batch, seq_len) -> {name: (shape, logical,
                          # dtype|None)}

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.cfg.dtype]

    def init(self, generator: torch.Generator, device) -> Any:
        """Random parameters from ``generator``, materialized on ``device``
        (the generator must live on that device)."""
        return init_params(generator, self.param_defs, self.dtype, device)

    def abstract(self) -> Any:
        """The parameter tree as ``meta`` tensors: shapes and dtypes, no
        storage (the reference's ShapeDtypeStructs)."""
        return _map_defs(lambda d: torch.empty(d.shape, dtype=self.dtype,
                                               device="meta"),
                         self.param_defs)

    def logical_axes(self) -> Any:
        """The parameter tree's logical axis names, one tuple per leaf
        (``ArrayDef.logical``), for `dist.sharding`."""
        return _map_defs(lambda d: tuple(d.logical), self.param_defs)


def _map_defs(fn, defs):
    if isinstance(defs, dict):
        return {k: _map_defs(fn, defs[k]) for k in sorted(defs)}
    return fn(defs)


SHARDED_FAMILIES = ("dense",)


def build_model(cfg: ArchConfig, mesh=None) -> ModelBundle:
    """The family's bundle.  ``mesh`` (a `DeviceMesh` of agents x fsdp x
    tensor) turns on the activation constraints of the sharded execution
    in the training loss (`models.common.constrain`); the dense
    transformer family takes it, the others refuse it."""
    if cfg.family not in _FAMILIES:
        raise KeyError(f"unknown family {cfg.family!r}; have "
                       f"{sorted(_FAMILIES)}")
    if mesh is not None and cfg.family not in SHARDED_FAMILIES:
        raise ValueError(
            f"the sharded execution (--mesh-fsdp/--mesh-tensor > 1) runs "
            f"the {SHARDED_FAMILIES} family; {cfg.family!r} waits for the "
            "rest of ROADMAP 7b (7c: the other families' sharded route, "
            "moe_impl='deferred')")
    mod = _FAMILIES[cfg.family]
    if mesh is not None:
        loss = lambda params, batch: mod.loss_fn(params, batch, cfg,
                                                 mesh=mesh)
    else:
        loss = lambda params, batch: mod.loss_fn(params, batch, cfg)
    return ModelBundle(
        cfg=cfg, param_defs=mod.param_defs(cfg),
        loss_fn=loss,
        prefill_fn=lambda params, batch: mod.forward_prefill(params, batch,
                                                             cfg),
        decode_fn=lambda params, token, cache, pos: mod.forward_decode(
            params, token, cache, pos, cfg),
        cache_spec=lambda batch, seq_len: mod.cache_spec(cfg, batch,
                                                         seq_len))
