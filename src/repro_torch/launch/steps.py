"""Step builders (counterpart of ``repro.launch.steps``): the per-step key
stream, and the mesh's agent torus (`torus_topology`, `make_torus_W`) and
DSGT's initial carry (`dsgt_carry`).

The mesh train step (``make_train_step``, the decentralized step over a
device mesh's agent torus, with the dense and ring gossip schedules) waits
for the sharded execution (ROADMAP 7b); on one card the trainer runs
`core.pdsgd.make_decentralized_step`.  The reference's
``make_prefill_step`` and ``make_decode_step`` wait for the dry-run
(ROADMAP 9), their only caller there; the port's serving calls a
bundle's ``prefill_fn`` and ``decode_fn`` directly.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import prng, topology
from ..dist.sharding import mesh_shape

__all__ = ["per_step_keys", "torus_topology", "make_torus_W", "dsgt_carry"]


def per_step_keys(key: torch.Tensor, start_step: int, n: int) -> torch.Tensor:
    """(n, 2) keys of the global steps [start_step, start_step + n):
    ``fold_in(key, k)`` on the absolute step, never a split of a carried
    key, so a chunk of them is the eager loop's keys bit for bit and a
    resumed run never re-issues a (key, step) pair."""
    steps = torch.arange(start_step, start_step + n, dtype=torch.int64,
                         device=key.device)
    return prng.fold_in(key, steps)


def torus_topology(mesh) -> topology.Topology:
    """The mesh's agent torus as a `Topology` (pod ring x data ring),
    agent id = pod * n_data + data.  ``mesh`` is a `DeviceMesh` or any
    object whose ``.shape`` maps axis names to sizes."""
    shape = mesh_shape(mesh)
    adj = topology.torus2d(shape.get("pod", 1), shape.get("data", 1))
    return topology.Topology(name="mesh_torus", adjacency=adj,
                             weights=topology.metropolis_weights(adj))


def make_torus_W(mesh) -> np.ndarray:
    """The doubly stochastic W on the mesh's agent torus."""
    return torus_topology(mesh).weights


def dsgt_carry(params):
    """DSGT's initial carry: ``(params, (y, g))`` with the tracker pair two
    separate zero trees shaped like ``params`` (leaves with the agent
    axis), so the first fresh tracker is exactly g^0, the convention of
    `core.pdsgd.make_decentralized_step`'s dsgt branch."""
    from ..optim.base import tree_map
    return (params, (tree_map(torch.zeros_like, params),
                     tree_map(torch.zeros_like, params)))
