"""Logical-axis sharding rules for every launch mode (counterpart of
``repro.dist.sharding``).

A rule table maps each *logical* axis name (the names the models attach
to their parameters through ``ArrayDef.logical``, and to activations and
caches) to an ordered tuple of *mesh-axis candidates*.  `logical_spec`
resolves one array's partition spec by walking its logical axes and
taking, per axis, the first candidate whose mesh axes

  * all exist on the mesh (missing axes are dropped from the candidate, so
    a ("pod", "data", "model") rule degrades to ("data", "model") on a
    single-pod mesh),
  * are not already taken by an earlier dimension of the same array, and
  * have a combined size above 1 that divides the dimension (an
    indivisible dimension falls through to replication).

A partition spec here is the port's own: a tuple with one entry per
dimension, ``None`` (replicated), a mesh axis name, or a tuple of names
(the dimension split over those axes, the first outermost), trailing
``None`` entries trimmed — the entries of the reference's
``PartitionSpec``.  `placements` turns one into DTensor placements on a
`torch.distributed.device_mesh.DeviceMesh`.  Tables are data, not code:
the tests compare them with the reference's, and `launch.specs` builds
every input's spec from them.  `mesh_pdsgd_tree` is the leafwise update
over leaves placed by such specs (the reference's
``kernels.ops.sharded_pdsgd_tree`` with a mesh).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import torch

# the kernels package first: core.privacy imports kernels.build, whose
# package imports core.privacy back
from ..kernels.obfuscate import obfuscate_update
from ..core.privacy import tree_leaves, tree_paths, tree_unflatten

__all__ = ["TRAIN_RULES", "SERVE_RULES", "DECODE_RULES", "RuleTable",
           "Spec", "MeshSharding", "mesh_shape", "logical_spec",
           "placements", "sharding_tree", "audit_rules", "keystr",
           "local_block", "mesh_pdsgd_tree"]

# Each value is a tuple of candidates; each candidate a tuple of mesh axes.
RuleTable = Mapping[str, tuple[tuple[str, ...], ...]]
Spec = tuple

# Axes that are always replicated (explicit, so the tables list every
# logical axis the models use).
_REPLICATED = {
    "layers": (), "seq": (), "head_dim": (), "experts": (), "conv": (),
    "state": (), "window": (), "audio": (), "embed": (),
}

TRAIN_RULES: RuleTable = dict(
    _REPLICATED,
    # the decentralized agents on the ("pod", "data") torus, one agent per
    # coordinate (`launch.mesh.agent_axes`)
    agents=(("pod", "data"),),
    # inside an agent's device group (`launch.mesh.make_sharded_mesh`) the
    # embedding dim shards FSDP-style over "fsdp" and the wide matmul dims
    # take the tensor-parallel "model" axis; a mesh without "fsdp"
    # replicates them
    embed=(("fsdp",),),
    batch=(("fsdp",),), kv_seq=(),
    mlp=(("model",),), expert_mlp=(("model",),),
    heads=(("model",),), kv_heads=(("model",),),
    ssm_heads=(("model",),),
    vocab=(("model",),),
)

SERVE_RULES: RuleTable = dict(
    _REPLICATED,
    agents=(("pod", "data"),),
    batch=(("data",),),
    # a long-context KV cache takes every free axis it divides by: batch
    # usually owns "data", so kv_seq falls through to "model"; at batch 1
    # it takes ("pod", "data", "model")
    kv_seq=(("pod", "data", "model"), ("data", "model"), ("model",)),
    mlp=(("model",),), expert_mlp=(("model",),),
    heads=(("model",),), kv_heads=(("model",),),
    ssm_heads=(("model",),),
    vocab=(("model",),),
)

# decode's head_dim fallback: where heads % model != 0 (llava's 56 query
# heads on a 16-way model axis) the head axis replicates and head_dim
# takes "model", keeping the attention weights sharded
DECODE_RULES: RuleTable = dict(SERVE_RULES, head_dim=(("model",),))


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name -> size: a `DeviceMesh`'s ``mesh_dim_names`` with its
    shape, or any object whose ``.shape`` is such a mapping (a stand-in
    for a mesh the process does not have)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def logical_spec(mesh, shape: Sequence[int],
                 logical: Sequence[str | None], table: RuleTable) -> Spec:
    """The partition spec of one array of ``shape`` with ``logical`` axes
    on ``mesh`` (see the module docstring)."""
    if len(shape) != len(logical):
        raise ValueError(
            f"rank mismatch: shape {tuple(shape)} vs logical {tuple(logical)}")
    sizes = mesh_shape(mesh)
    used: set[str] = set()
    entries: list = []
    for dim, name in zip(shape, logical):
        chosen = None
        for cand in (table.get(name, ()) if name is not None else ()):
            axes = tuple(a for a in cand if a in sizes)
            if not axes or any(a in used for a in axes):
                continue
            size = 1
            for a in axes:
                size *= sizes[a]
            if size <= 1 or dim % size != 0:
                continue
            chosen = axes
            break
        if chosen is not None:
            used.update(chosen)
            entries.append(chosen[0] if len(chosen) == 1 else chosen)
        else:
            entries.append(None)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def placements(spec: Spec, mesh, ndim: int | None = None) -> list:
    """DTensor placements of ``spec`` on a `DeviceMesh` with named axes:
    per mesh axis ``Shard(d)`` for the dimension d whose entry names it,
    else ``Replicate()``; a dimension over two axes is ``Shard(d)`` on
    both.  Its axes must come in the mesh's order (DTensor splits a
    dimension over its mesh axes outermost first, in mesh order).
    ``ndim`` checks the spec's rank against the array's."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names or ())
    if ndim is not None and len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the array's "
                         f"{ndim} dimensions")
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, not on the "
                                 f"mesh {names}")
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec entry {axes} is not in the mesh's axis "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(d)
    return out


@dataclasses.dataclass(frozen=True)
class MeshSharding:
    """One array's placement: its mesh and partition spec (the
    reference's ``NamedSharding``)."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> list:
        return placements(self.spec, self.mesh)


def keystr(path: str) -> str:
    """A '/'-joined tree path as jax's ``keystr`` spells a dict path:
    ``layers/wq`` -> ``['layers']['wq']``."""
    return "".join(f"[{k!r}]" for k in path.split("/")) if path else ""


def _pairs(abstract, logical) -> list:
    leaves = tree_leaves(abstract)
    logs = tree_leaves(logical)
    if len(logs) != len(leaves):
        raise ValueError("abstract/logical trees do not match: "
                         f"{len(leaves)} leaves vs {len(logs)} axis tuples")
    return list(zip(tree_paths(abstract), leaves, logs))


def sharding_tree(mesh, abstract: Any, logical: Any,
                  table: RuleTable) -> Any:
    """A `MeshSharding` per leaf of an (abstract, logical) tree pair —
    the one resolver every placement shares (`launch.specs`)."""
    return tree_unflatten(abstract, [
        MeshSharding(mesh, logical_spec(mesh, leaf.shape, log, table))
        for _, leaf, log in _pairs(abstract, logical)])


def audit_rules(abstract: Any, logical: Any, mesh,
                table: RuleTable = TRAIN_RULES) -> list[dict]:
    """Lint a model's parameter tree against a rule table on ``mesh``.

    One finding per problem, in tree order, ``path`` spelled as jax's
    ``keystr``:

    * ``severity="error"``: a leaf names a logical axis the table does not
      know (it would silently replicate);
    * ``severity="info"``: a leaf resolves to full replication although
      the mesh has spare capacity (an axis above 1).

    ``abstract``/``logical`` are `ModelBundle.abstract()` /
    `logical_axes()` (or agent-stacked by `launch.specs.with_agent_axis`);
    ``mesh`` only needs a ``.shape`` mapping, or is a `DeviceMesh`."""
    spare = any(s > 1 for s in mesh_shape(mesh).values())
    findings: list[dict] = []
    for path, leaf, log in _pairs(abstract, logical):
        name = keystr(path)
        unknown = sorted({a for a in log if a is not None and a not in table})
        if unknown:
            findings.append({
                "path": name, "logical": tuple(log), "severity": "error",
                "issue": f"unknown logical axes {unknown} (no rule; "
                         "leaf silently replicates)"})
            continue
        spec = logical_spec(mesh, leaf.shape, log, table)
        if spare and not any(e is not None for e in spec):
            findings.append({
                "path": name, "logical": tuple(log), "severity": "info",
                "issue": "fully replicated on a mesh with spare capacity"})
    return findings


def local_block(mesh, full: torch.Tensor, pls):
    """``full`` (the same on every rank) as a DTensor placed by ``pls`` on
    ``mesh``: each rank keeps its own block, a local chunk, with no
    communication."""
    from torch.distributed.tensor import DTensor, Replicate
    rep = DTensor.from_local(full, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return rep.redistribute(mesh, pls)


_MESH_CORRUPT = ("fault injection on the sharded leafwise path is not "
                 "supported; use the dense paths for fault scenarios")


def _mesh_leaf(t, mesh, pl):
    """``t`` as a DTensor on ``mesh``: a DTensor as it is, a full tensor
    distributed by the placements ``pl``."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(t, DTensor):
        return t
    return distribute_tensor(t, mesh, pl)


def mesh_pdsgd_tree(W: torch.Tensor, B: torch.Tensor, x_tree, g_tree,
                    bits_tree, lam_bar, *, mesh, leaf_specs=None,
                    mask: torch.Tensor | None = None,
                    corrupt: torch.Tensor | None = None):
    """The leafwise Eq. (4) update with every leaf a DTensor on ``mesh`` (a
    `DeviceMesh`), placed by its spec in ``leaf_specs`` (a tree or
    sequence of specs, agent axis included; DTensor leaves are taken as
    they are).  Per leaf: the obfuscate kernel (B1) on the rank's local
    shard reading ``bits_tree``'s uint32 draws; the local shards of x and
    u gathered over the agent axes (`dist.collectives.gather_agents`: the
    ranks holding the same block of the leaf in the other agents); the
    gossip kernel over them, B2 (W) or B4 (``mask``: W_k from the edge
    mask on chip); the rank keeps its agents' rows.  Every column is the
    ``mesh=None`` leafwise layout's bit for bit, and nothing of a leaf
    outside the rank's block is gathered.  Returns a tree of DTensors.
    ``corrupt`` is refused with the reference's message."""
    if corrupt is not None:
        raise NotImplementedError(_MESH_CORRUPT)
    if leaf_specs is None:
        raise ValueError("mesh given but leaf_specs is None; resolve specs "
                         "via dist.sharding.logical_spec")
    from torch.distributed.tensor import DTensor
    from ..kernels.gossip import gossip_update, masked_gossip_update
    from .collectives import gather_agents, mesh_agent
    specs = (tree_leaves(leaf_specs) if isinstance(leaf_specs, dict)
             else list(leaf_specs))
    slot = mesh_agent(mesh)
    outs = []
    for x, g, b, spec in zip(tree_leaves(x_tree), tree_leaves(g_tree),
                             tree_leaves(bits_tree), specs):
        pl = placements(spec, mesh, x.dim())
        xd, gd = _mesh_leaf(x, mesh, pl), _mesh_leaf(g, mesh, pl)
        # full bits travel as int32 words (gloo has no uint32); a DTensor
        # holds its rank's block already
        bl = (b if isinstance(b, DTensor)
              else _mesh_leaf(b.view(torch.int32), mesh, pl)).to_local()
        bl = bl.view(torch.uint32)
        xl, gl = xd.to_local(), gd.to_local()
        rows = xl.shape[0]
        u = obfuscate_update(xl.reshape(rows, -1), gl.reshape(rows, -1),
                             bl.reshape(rows, -1), lam_bar, 0.0, -1.0)
        Xa = gather_agents(mesh, xl.reshape(rows, -1))
        Ua = gather_agents(mesh, u)
        if mask is not None:
            out = masked_gossip_update(mask.to(Xa.device), B.to(Xa.device),
                                       Xa, Ua)
        else:
            out = gossip_update(W.to(Xa.device), B.to(Xa.device), Xa, Ua)
        own = out[slot * rows:(slot + 1) * rows].reshape(xl.shape)
        outs.append(DTensor.from_local(own, mesh, xd.placements,
                                       shape=xd.shape, stride=xd.stride()))
    return tree_unflatten(x_tree, outs)
