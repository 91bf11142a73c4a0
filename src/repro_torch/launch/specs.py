"""Input specs and their shardings for every (arch x input shape x mode)
(counterpart of ``repro.launch.specs``): arrays on the ``meta`` device,
which hold shapes and dtypes and allocate nothing, and a
`dist.sharding.MeshSharding` per array from the rule tables.  ``mesh``
is a `DeviceMesh`, or any object whose ``.shape`` maps axis names to
sizes (the specs need no devices)."""
from __future__ import annotations

from typing import Any

import torch

from ..configs import InputShape
from ..dist.sharding import (DECODE_RULES, SERVE_RULES, TRAIN_RULES,
                             MeshSharding, logical_spec, sharding_tree)
from ..core.privacy import tree_leaves, tree_unflatten
from ..models.build import ModelBundle

__all__ = ["with_agent_axis", "train_specs", "serve_params_specs",
           "prefill_specs", "decode_specs"]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _shard_dict(mesh, abstract: dict, logical: dict, table) -> dict:
    return {k: MeshSharding(mesh, logical_spec(mesh, a.shape, logical[k],
                                               table))
            for k, a in abstract.items()}


def with_agent_axis(abstract: Any, logical: Any, m: int):
    """Prepend the decentralized agent dimension to every parameter leaf
    (logical axis "agents")."""
    abs_m = tree_unflatten(abstract, [_meta((m,) + tuple(a.shape), a.dtype)
                                      for a in tree_leaves(abstract)])
    log_m = tree_unflatten(logical, [("agents",) + tuple(l)
                                     for l in tree_leaves(logical)])
    return abs_m, log_m


def _modality(cfg, abstract: dict, logical: dict, lead: tuple,
              lead_log: tuple, S: int, dtype) -> None:
    """The enc-dec family's frames and a VLM's prefix embeddings."""
    if cfg.family == "audio":
        abstract["frames"] = _meta(lead + (S, cfg.d_model), dtype)
        logical["frames"] = lead_log + ("seq", "embed")
    if cfg.num_prefix_embeds:
        abstract["prefix_embeds"] = _meta(
            lead + (cfg.num_prefix_embeds, cfg.d_model), dtype)
        logical["prefix_embeds"] = lead_log + ("seq", "embed")


def train_specs(bundle: ModelBundle, shape: InputShape, mesh, m: int):
    """``(params_abs, params_sh, batch_abs, batch_sh)`` of the
    decentralized train step: m agents, each ``global_batch / m``
    sequences."""
    cfg = bundle.cfg
    assert shape.global_batch % m == 0, (shape.global_batch, m)
    per_agent = shape.global_batch // m
    S = shape.seq_len
    params_abs, params_log = with_agent_axis(bundle.abstract(),
                                             bundle.logical_axes(), m)
    params_sh = sharding_tree(mesh, params_abs, params_log, TRAIN_RULES)
    lead, lead_log = (m, per_agent), ("agents", "batch")
    batch_abs = {"tokens": _meta(lead + (S,), torch.int32),
                 "labels": _meta(lead + (S,), torch.int32)}
    batch_log = {"tokens": lead_log + ("seq",),
                 "labels": lead_log + ("seq",)}
    _modality(cfg, batch_abs, batch_log, lead, lead_log, S, bundle.dtype)
    return (params_abs, params_sh, batch_abs,
            _shard_dict(mesh, batch_abs, batch_log, TRAIN_RULES))


def serve_params_specs(bundle: ModelBundle, mesh):
    params_abs = bundle.abstract()
    return params_abs, sharding_tree(mesh, params_abs,
                                     bundle.logical_axes(), SERVE_RULES)


def prefill_specs(bundle: ModelBundle, shape: InputShape, mesh):
    """``(params_abs, params_sh, batch_abs, batch_sh)`` of a prefill of
    ``global_batch`` prompts of ``seq_len`` tokens."""
    cfg = bundle.cfg
    B, S = shape.global_batch, shape.seq_len
    params_abs, params_sh = serve_params_specs(bundle, mesh)
    batch_abs = {"tokens": _meta((B, S), torch.int32)}
    batch_log = {"tokens": ("batch", "seq")}
    _modality(cfg, batch_abs, batch_log, (B,), ("batch",), S, bundle.dtype)
    return (params_abs, params_sh, batch_abs,
            _shard_dict(mesh, batch_abs, batch_log, SERVE_RULES))


def decode_specs(bundle: ModelBundle, shape: InputShape, mesh, rules=None):
    """The decode step's inputs: ``(params_abs, params_sh, token_abs,
    token_sh, cache_abs, cache_sh, pos_abs, pos_sh)`` — the parameters,
    the (B,) tokens, the cache of ``seq_len`` positions and the scalar
    position.  ``rules`` defaults to SERVE_RULES; DECODE_RULES is the
    head_dim fallback layout."""
    table = rules if rules is not None else SERVE_RULES
    B, S = shape.global_batch, shape.seq_len
    params_abs = bundle.abstract()
    params_sh = sharding_tree(mesh, params_abs, bundle.logical_axes(), table)
    cache_abs, cache_sh = {}, {}
    for name, (shp, log, dt) in bundle.cache_spec(B, S).items():
        cache_abs[name] = _meta(shp, dt or bundle.dtype)
        cache_sh[name] = MeshSharding(mesh, logical_spec(mesh, shp, log,
                                                         table))
    token_abs = _meta((B,), torch.int32)
    token_sh = MeshSharding(mesh, logical_spec(mesh, (B,), ("batch",),
                                               table))
    pos_abs = _meta((), torch.int32)
    return (params_abs, params_sh, token_abs, token_sh, cache_abs, cache_sh,
            pos_abs, MeshSharding(mesh, ()))
