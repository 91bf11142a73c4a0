"""Device meshes for one process or many (counterpart of
``repro.launch.mesh``), over
`torch.distributed.device_mesh.init_device_mesh` with the reference's axis
names.

Every mesh function here needs the default process group (each rank one device,
``torch.distributed.init_process_group``; one process: a
``torch.distributed.HashStore``, rank 0, world size 1) and builds the
mesh over its ranks on ``device_type`` ("cuda" unless the caller asks for
"cpu"; the gloo backend serves CPU meshes).  The reference's
``jax.process_count()`` is the number of hosts here, ``WORLD_SIZE /
LOCAL_WORLD_SIZE``, and its devices are the ranks.  Nothing runs at
import.

`validate_agent_tiling`, `agent_axes` and `num_agents` also take any
object whose ``.shape`` maps axis names to sizes (a stand-in for a mesh
the process does not have), as the reference's do.
"""
from __future__ import annotations

import os

from ..dist.sharding import mesh_shape

__all__ = ["make_production_mesh", "make_global_mesh", "make_sharded_mesh",
           "validate_agent_tiling", "agent_axes", "num_agents"]


def _world_size() -> int:
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError(
            "no default process group: call "
            "torch.distributed.init_process_group first (one process: a "
            "HashStore, rank 0, world size 1)")
    return dist.get_world_size()


def _hosts(world: int) -> int:
    """Processes of the job over processes per host: the hosts."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return max(1, world // max(1, local))


def _mesh(device_type: str, shape: tuple[int, ...], axes: tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """One pod: 256 devices, 16 data x 16 model.  Two pods: 512, with a
    leading "pod" axis.  The job must have that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, axes)


def make_global_mesh(*, model_parallel: int = 1, agents: int | None = None,
                     device_type: str = "cuda"):
    """The agent mesh over every rank of the job.

    With P > 1 hosts the leading "pod" axis has extent P, so one host owns
    one pod row of the agent torus (its Lambda keys stay on it); one host
    gets a flat ("data", "model") mesh.  ``model_parallel`` carves a
    trailing "model" axis out of the ranks; the rest host the agents.
    With ``agents`` the tiling is checked at once
    (`validate_agent_tiling`)."""
    n = _world_size()
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(
            f"model_parallel={model_parallel} does not divide the "
            f"{n} visible devices")
    slots = n // model_parallel
    procs = _hosts(n)
    if procs > 1:
        if slots % procs:
            raise ValueError(
                f"{slots} agent slots do not split over {procs} processes; "
                f"each controller must own the same number of agents")
        shape = (procs, slots // procs, model_parallel)
        axes = ("pod", "data", "model")
    else:
        shape = (slots, model_parallel)
        axes = ("data", "model")
    mesh = _mesh(device_type, shape, axes)
    if agents is not None:
        validate_agent_tiling(mesh, agents)
    return mesh


def make_sharded_mesh(*, agents: int | None = None, fsdp: int = 1,
                      tensor: int = 1, device_type: str = "cuda"):
    """Agents x fsdp x tensor: ("data", "fsdp", "model").

    The leading "data" axis hosts the agents (`agent_axes`); each agent
    owns an fsdp x tensor block of ranks, inside which parameters shard
    FSDP-style over "fsdp" and tensor-parallel over "model"
    (`dist.sharding.TRAIN_RULES`).  The group must divide the ranks; the
    rest become agent slots.  A (1, 1, 1) mesh on one rank is the
    trivially sharded case, held against the dense path."""
    if fsdp < 1 or tensor < 1:
        raise ValueError(f"fsdp={fsdp} and tensor={tensor} must be >= 1")
    n = _world_size()
    group = fsdp * tensor
    if n % group:
        raise ValueError(
            f"per-agent group fsdp*tensor={group} does not divide the "
            f"{n} visible devices")
    mesh = _mesh(device_type, (n // group, fsdp, tensor),
                 ("data", "fsdp", "model"))
    if agents is not None:
        validate_agent_tiling(mesh, agents)
    return mesh


def validate_agent_tiling(mesh, agents: int) -> int:
    """Require ``agents`` to tile the mesh's agent axes exactly; returns
    the agents per slot (above 1: each slot time-multiplexes that many
    agents).  Raises ValueError naming the counts that fit otherwise."""
    slots = num_agents(mesh)
    shape = mesh_shape(mesh)
    if agents < 1:
        raise ValueError(f"agent count must be positive, got {agents}")
    if agents % slots:
        fits = sorted({slots * k for k in (1, 2, 4, 8)})
        raise ValueError(
            f"{agents} agents do not tile the {shape} mesh: its agent axes "
            f"{agent_axes(mesh)} provide {slots} slots, so the agent count "
            f"must be a multiple of {slots} (e.g. {fits})")
    return agents // slots


def agent_axes(mesh) -> tuple[str, ...]:
    """The mesh axes that host the decentralized agents (the paper's m)."""
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def num_agents(mesh) -> int:
    shape = mesh_shape(mesh)
    n = 1
    for a in agent_axes(mesh):
        n *= shape[a]
    return n
