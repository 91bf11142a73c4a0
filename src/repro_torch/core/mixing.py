"""The coupling process W_k (counterpart of ``repro.core.mixing``).

Only the ``static`` mode is ported: every step realizes the base
Metropolis matrix, cast once from float64 to float32 exactly as the
reference does.  Link dropout and graph resampling come with the masked
gossip kernels (B4/B5) in a later slice.
"""
from __future__ import annotations

import dataclasses

import torch

from .topology import Topology

__all__ = ["MixingProcess", "make_mixing", "as_process"]


@dataclasses.dataclass(frozen=True, eq=False)
class MixingProcess:
    """``realize(step) -> (W, support, None)`` for a static topology."""

    topology: Topology

    def __post_init__(self):
        # device -> (W, support): copied once, not on every step
        object.__setattr__(self, "_on_device", {})

    @property
    def num_agents(self) -> int:
        return self.topology.num_agents

    def realize(self, step, device=None):
        """(W, support, mask) on ``device``; a static process has no mask.
        The tensors are shared between calls: do not write to them."""
        device = torch.device(device or "cpu")
        if device not in self._on_device:
            W = torch.as_tensor(self.topology.weights).to(torch.float32)
            support = torch.as_tensor(self.topology.adjacency).to(
                torch.float32)
            self._on_device[device] = (W.to(device), support.to(device))
        return (*self._on_device[device], None)


def make_mixing(topology: Topology) -> MixingProcess:
    """The static process of ``topology`` (the only mode ported)."""
    return MixingProcess(topology)


def as_process(topology_or_process) -> MixingProcess:
    if isinstance(topology_or_process, MixingProcess):
        return topology_or_process
    if isinstance(topology_or_process, Topology):
        return MixingProcess(topology_or_process)
    raise TypeError(f"expected Topology or MixingProcess, got "
                    f"{type(topology_or_process).__name__}")
