"""Config registry: ``get_config("<arch-id>")`` with the ``-smoke`` and
``-tiny`` suffixes.  Only the architectures the port runs are listed."""
from __future__ import annotations

import importlib

from .base import ArchConfig, reduced_variant, tiny_variant

_ARCHS = {"stablelm-3b": "stablelm_3b", "xlstm-125m": "xlstm_125m",
          "zamba2-7b": "zamba2_7b", "granite-8b": "granite_8b",
          "mistral-nemo-12b": "mistral_nemo_12b",
          "chatglm3-6b": "chatglm3_6b",
          "granite-moe-1b-a400m": "granite_moe_1b_a400m",
          "olmoe-1b-7b": "olmoe_1b_7b",
          "seamless-m4t-medium": "seamless_m4t_medium",
          "llava-next-34b": "llava_next_34b"}

ARCH_NAMES = tuple(_ARCHS)


def get_config(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return reduced_variant(get_config(name[: -len("-smoke")]))
    if name.endswith("-tiny"):
        return tiny_variant(get_config(name[: -len("-tiny")]))
    if name not in _ARCHS:
        raise KeyError(f"unknown or not yet ported arch {name!r}; have "
                       f"{sorted(_ARCHS)}")
    return importlib.import_module(f".{_ARCHS[name]}", __package__).CONFIG


__all__ = ["ArchConfig", "ARCH_NAMES", "get_config", "reduced_variant",
           "tiny_variant"]
