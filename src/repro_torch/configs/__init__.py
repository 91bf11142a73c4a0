"""Config registry: ``get_config("<arch-id>")`` with the ``-smoke`` and
``-tiny`` suffixes, and the input-shape table with `config_for_shape`
(counterpart of ``repro.configs``)."""
from __future__ import annotations

import dataclasses
import importlib

from .base import (INPUT_SHAPES, ArchConfig, InputShape, reduced_variant,
                   tiny_variant)

_ARCHS = {"stablelm-3b": "stablelm_3b", "xlstm-125m": "xlstm_125m",
          "zamba2-7b": "zamba2_7b", "granite-8b": "granite_8b",
          "mistral-nemo-12b": "mistral_nemo_12b",
          "chatglm3-6b": "chatglm3_6b",
          "granite-moe-1b-a400m": "granite_moe_1b_a400m",
          "olmoe-1b-7b": "olmoe_1b_7b",
          "seamless-m4t-medium": "seamless_m4t_medium",
          "llava-next-34b": "llava_next_34b"}

ARCH_NAMES = tuple(_ARCHS)

LONG_WINDOW = 4096  # the sliding window long_500k applies to windowed archs


def get_config(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return reduced_variant(get_config(name[: -len("-smoke")]))
    if name.endswith("-tiny"):
        return tiny_variant(get_config(name[: -len("-tiny")]))
    if name not in _ARCHS:
        raise KeyError(f"unknown or not yet ported arch {name!r}; have "
                       f"{sorted(_ARCHS)}")
    return importlib.import_module(f".{_ARCHS[name]}", __package__).CONFIG


def config_for_shape(cfg: ArchConfig, shape: InputShape) -> ArchConfig:
    """The config a shape runs: long_500k turns on the sub-quadratic
    paths, a sliding window of LONG_WINDOW on the attention (on the
    enc-dec family's cross-attention too), except for the xLSTM
    (recurrent) and a ``long_context_mode="full_kv"`` config outside the
    hybrid family (it keeps every position)."""
    if shape.name != "long_500k" or cfg.family == "xlstm" \
            or (cfg.family != "hybrid"
                and cfg.long_context_mode == "full_kv"):
        return cfg
    if cfg.family == "audio":
        return dataclasses.replace(cfg, attn_window=LONG_WINDOW,
                                   cross_attn_window=LONG_WINDOW)
    return dataclasses.replace(cfg, attn_window=LONG_WINDOW)


__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "ARCH_NAMES",
           "LONG_WINDOW", "get_config", "config_for_shape", "reduced_variant",
           "tiny_variant"]
