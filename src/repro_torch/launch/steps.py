"""Step builders (counterpart of ``repro.launch.steps``): the per-step key
stream, the mesh's agent torus (`torus_topology`, `make_torus_W`), DSGT's
initial carry (`dsgt_carry`) and the decentralized train step over a
mesh's agent torus (`make_train_step`), with the dense and the ring gossip
schedules.

``make_train_step`` runs in two forms.  Given a stand-in mesh (any object
whose ``.shape`` maps "pod"/"data"/"model" to sizes) all m =
`num_agents(mesh)` agents live on one device, in one flat (m, width)
buffer, as `core.pdsgd` holds them.  Given a `DeviceMesh` each
("pod", "data") rank hosts one agent: its parameters are DTensors sharded
over those axes, the dense schedule gathers the agents' x and u over the
agent axes and runs the same update on the rank's row, and the ring
schedule exchanges only the per-link messages, one point-to-point shift a
direction (`dist.collectives.torus_gossip_pdsgd`).  Both forms walk the
same trajectory bit for bit.

The reference's ``make_prefill_step`` and ``make_decode_step`` wait for
the dry-run (ROADMAP 9), their only caller there; the port's serving
calls a bundle's ``prefill_fn`` and ``decode_fn`` directly.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import prng, topology
from ..dist.sharding import mesh_shape

__all__ = ["per_step_keys", "torus_topology", "make_torus_W", "dsgt_carry",
           "make_train_step", "sharded_pdsgd_step"]


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


def _is_device_mesh(mesh) -> bool:
    return getattr(mesh, "mesh_dim_names", None) is not None


def _local(t):
    """A DTensor's local shard, a tensor as it is."""
    return t.to_local() if hasattr(t, "to_local") else t


def _leaf_specs(bundle, mesh, m: int):
    """Each parameter leaf's spec on ``mesh`` by TRAIN_RULES, agent axis
    first (None for a bundle without parameter definitions)."""
    if not hasattr(bundle, "abstract"):
        return None
    from ..core.privacy import tree_leaves, tree_unflatten
    from ..dist.sharding import TRAIN_RULES, logical_spec
    from .specs import with_agent_axis
    p_abs, p_log = with_agent_axis(bundle.abstract(), bundle.logical_axes(),
                                   m)
    return tree_unflatten(p_abs, [
        logical_spec(mesh, a.shape, log, TRAIN_RULES)
        for a, log in zip(tree_leaves(p_abs), tree_leaves(p_log))])


def make_train_step(bundle, mesh, gossip: str = "dense",
                    algorithm: str = "pdsgd", lam_base: float = 0.1,
                    use_pallas: bool = False, mixing=None, observer=None,
                    faults=None, sharded: bool = False,
                    ring_schedule: str = "pipelined",
                    ring_fused: bool = False):
    """``train_step(params, batch, seed, step) -> (params, loss)``.

    ``params`` is a tree of (m, ...) leaves (with a `DeviceMesh`: DTensors
    sharded over its agent axes, or this rank's (1, ...) blocks), ``batch``
    a tree of (m, ...) leaves (all agents' rows, or DTensors: each rank
    reads its own), ``seed`` the step's key seed (``key(seed)``) and
    ``step`` the absolute step.  lam_bar = lam_base / (step + 1); Lambda^k
    and B^k come from the reference's per-agent keys.  The returned leaves
    are views of a new flat buffer (DTensors on a mesh); the inputs are
    left as they are.  The loss is the agents' mean (on a mesh: all
    agents', gathered).

    ``gossip="dense"``: W x - B^k u with explicit (m, m) matrices through
    `core.pdsgd.pdsgd_update` — with ``use_pallas`` the concat layout's
    kernels (the obfuscate kernel reading the Lambda bits, then the gossip
    kernel, the masked one under a time-varying ``mixing``; ``sharded``
    with a `DeviceMesh`: the leafwise layout over it), else the unfused
    formula (the reference's ``use_pallas=False`` default).  On a mesh the
    rank obfuscates its own row, the agents' x and u are gathered over
    the agent axes, and the same gossip runs there; the rank keeps its
    row.  ``gossip="ring"``: u by the unfused per-agent obfuscation, b
    rows from `dist.collectives.sample_b_draws` on ``agent_key(fold_in(
    key, 2), step, 0)`` (masked onto the realized links), then
    `dist.collectives.torus_gossip_pdsgd`: on one device its dense
    fallback, or the ring kernel with ``ring_fused``; on a mesh the
    point-to-point exchange in ``ring_schedule``.

    ``mixing`` (a `core.mixing.MixingProcess` on `torus_topology(mesh)`)
    makes W_k time-varying; ``resample`` is dense-only.  ``algorithm``:
    pdsgd, dsgd (W x - lam g) or dsgt (the first argument and the first
    return are the carry ``(params, (y_prev, g_prev))`` of `dsgt_carry`,
    dense only).  ``observer`` (a `privacy.observe.Adversary`, pdsgd and
    dsgd) makes the return ``(params, {"loss", "observation"})``: the
    ring taps the sender-side messages of the exchange itself.
    ``faults`` (a `faults.FaultProcess`, pdsgd, crash only, rejoin
    'hold') composes the coupling through `faults.realize_coupling`, holds
    the down agents' rows and guards every received ring message.
    """
    from ..core.mixing import as_process
    from ..dist import collectives as C
    from .mesh import num_agents

    if faults is not None and faults.is_inert:
        faults = None
    if faults is not None:
        if algorithm != "pdsgd":
            raise ValueError(
                "fault injection composes with the paper's pdsgd update; "
                f"algorithm={algorithm!r} is not a fault scenario")
        if faults.has_corruption:
            raise ValueError(
                "corrupt-link injection is a single-controller scenario "
                "(core.pdsgd.make_decentralized_step); the mesh launch "
                "path carries crash faults only")
        if faults.rejoin != "hold":
            raise ValueError(
                "rejoin='neighbor-avg' is a single-controller scenario "
                "(core.pdsgd.make_decentralized_step); the mesh launch "
                "path rejoins with 'hold'")
    if algorithm == "dsgt" and gossip != "dense":
        raise ValueError(
            "algorithm='dsgt' supports gossip='dense' only (the tracker is "
            "a second gossiped variable; the ring pipeline carries one)")
    if observer is not None and algorithm not in ("pdsgd", "dsgd"):
        raise ValueError(
            f"observation capture supports algorithm pdsgd/dsgd here, "
            f"not {algorithm!r}")
    if algorithm not in ("pdsgd", "dsgd", "dsgt"):
        raise ValueError(algorithm)
    if gossip not in ("dense", "ring"):
        raise ValueError(f"unknown gossip {gossip!r}; expected 'dense' or "
                         "'ring'")
    if ring_schedule not in ("staged", "pipelined"):
        raise ValueError(f"unknown schedule {ring_schedule!r}; "
                         "expected 'staged' or 'pipelined'")
    m = num_agents(mesh)
    torus = torus_topology(mesh)
    shape = mesh_shape(mesh)
    n_data, n_pod = shape.get("data", 1), shape.get("pod", 1)
    on_mesh = _is_device_mesh(mesh)
    if mixing is not None:
        if mixing.mode == "resample" and gossip == "ring":
            raise ValueError(
                "mixing mode='resample' redraws the graph off the torus "
                "support; the ring schedule cannot carry it — use "
                "gossip='dense'")
        if (mixing.num_agents != m
                or not np.array_equal(mixing.topology.adjacency,
                                      torus.adjacency)):
            raise ValueError(
                "mixing process must be built on this mesh's agent torus "
                "(see launch.steps.torus_topology)")
    process = mixing if mixing is not None else as_process(torus)
    if faults is not None and faults.num_agents != m:
        raise ValueError(
            f"faults built for {faults.num_agents} agents but the "
            f"mesh torus has {m}")
    specs = _leaf_specs(bundle, mesh, m) if (sharded or gossip == "ring") \
        else None
    if gossip == "ring" and observer is not None and specs is not None:
        from ..core.privacy import tree_leaves
        if any(any(e is not None for e in s[1:]) for s in tree_leaves(specs)):
            raise ValueError(
                "observation capture on gossip='ring' needs the "
                "non-agent dims replicated; this bundle shards them "
                "(model-parallel PartitionSpecs) — audit a "
                "replicated-per-agent bundle instead")
    sharded_mesh = sharded and on_mesh
    if sharded_mesh and not (use_pallas and gossip == "dense"
                             and algorithm == "pdsgd" and faults is None
                             and observer is None):
        raise ValueError(
            "sharded=True over a DeviceMesh runs the leafwise kernels "
            "(use_pallas=True) of pdsgd with gossip='dense', without "
            "faults or capture")

    def realize(k: int, dev):
        """(W, support, mask, alive): alive None without faults, mask None
        on a static coupling."""
        if faults is not None:
            from ..faults import realize_coupling
            W, support, mask, alive, _ = realize_coupling(process, faults, k,
                                                          dev)
            return W, support, mask, alive
        W, support, mask = process.realize(k, dev)
        return W, support, mask, None

    def train_step(params, batch, seed, step):
        from ..core.pdsgd import (DecentralizedState, _agent_grads,
                                  _dsgt_step_, _keep_where, dsgd_update,
                                  pdsgd_update)
        from ..core.privacy import agent_key, tree_leaves, tree_unflatten
        from ..kernels.build import to_device
        from ..kernels.ops import FlatLayout
        from ..privacy import observe as O
        k = int(step)
        carry = None
        if algorithm == "dsgt":
            params, carry = params
        leaves = tree_leaves(params)
        local = [_local(t) for t in leaves]
        L = local[0].shape[0]
        lo = C.mesh_agent(mesh) * L if on_mesh else 0
        dev = local[0].device
        # the step's draws run where the parameters are
        key = to_device(prng.key(int(seed)), dev)
        W, support, mask, alive = realize(k, dev)
        lam_bar = (torch.full((), lam_base, dtype=torch.float32, device=dev)
                   / (torch.full((), float(k), dtype=torch.float32,
                                 device=dev) + 1.0))
        if not sharded_mesh:
            layout = FlatLayout.of(tree_unflatten(params,
                                                  [t[0] for t in local]))
            X = layout.flatten(tree_unflatten(params, local), L)
            G = torch.empty_like(X)
            losses = _agent_grads(bundle.loss_fn,
                                  DecentralizedState(flat=X, layout=layout),
                                  _batch_rows(batch, lo, L), G)
        held = X.clone() if alive is not None and not sharded_mesh else None
        observation = None
        gather = (lambda t: C.gather_agents(mesh, t)) if on_mesh \
            else (lambda t: t)
        rows = slice(lo, lo + L)
        if algorithm == "dsgt":
            Y, Gp = (layout.flatten(tree_unflatten(params, [
                _local(t) for t in tree_leaves(c)]), L) for c in carry)
            Xa, Ya, Gpa, Ga = (gather(t) for t in (X, Y, Gp, G))
            _dsgt_step_(Xa, Ya, Gpa, Ga, W=W, lam=lam_bar)
            X, Y, Gp = Xa[rows], Ya[rows], Gpa[rows]
        elif algorithm == "dsgd":
            Xa, Ga = gather(X), gather(G)
            if observer is not None:
                D = layout.size
                observation = O.adversary_view(observer, O.state_record(
                    support=support, x_flat=Xa[:, :D].float(),
                    g_flat=Ga[:, :D].float(), W=W, lam=lam_bar))
            X = dsgd_update(Xa, Ga, W=W, lam=lam_bar)[rows]
        elif sharded_mesh:
            X = None
            new, losses = sharded_pdsgd_step(
                bundle, mesh, params, batch, key, k, W, support, mask,
                lam_bar, specs)
        elif gossip == "dense" and not on_mesh:
            out = pdsgd_update(
                X, G, layout, key=key, step=k, W=W, support=support,
                lam_bar=lam_bar, kernel_rng=False, in_place=True,
                eager=not use_pallas, mask=mask,
                kernel_layout="leafwise" if sharded and use_pallas
                else "concat",
                observe=observer is not None,
                fields=(observer.fields if observer is not None
                        else O.RECORD_FIELDS))
            if observer is not None:
                out, record = out
                observation = O.adversary_view(observer, record)
            X = out
        elif gossip == "dense":
            X, observation = _mesh_dense(
                mesh, X, G, layout, key, k, W, support, mask, lam_bar,
                use_pallas, observer, lo, gather)
        else:
            U = _own_u(G, layout, key, k, lam_bar, lo)
            b = C.sample_b_draws(agent_key(prng.fold_in(key, 2), k, 0), m,
                                 n_data, n_pod).to(dev)
            W_k = None
            if mask is not None:
                b = C.mask_b_draws(b, C.directional_keep(support, n_data,
                                                         n_pod))
                W_k = W
            elif mixing is not None:
                W_k = W
            out = C.torus_gossip_pdsgd(
                mesh if on_mesh else None, layout.tree(X), layout.tree(U), b,
                n_data=n_data, n_pod=n_pod, W=W_k,
                capture=observer is not None,
                finite_guard=faults is not None, schedule=ring_schedule,
                fused=ring_fused)
            if observer is not None:
                out, V = out
                W_rec, B_rec = C.dense_coupling(b, n_data, n_pod, W=W_k)
                D = layout.size
                record = O.full_record(
                    v=V, support=support, x_flat=gather(X)[:, :D].float(),
                    u_flat=gather(U)[:, :D].float(),
                    g_flat=gather(G)[:, :D].float(), W=W_rec, B=B_rec)
                observation = O.adversary_view(observer, record)
            X = layout.flatten(out, L).to(X.dtype)
        if alive is not None:
            _keep_where(X, (alive.to(dev)[rows] > 0)[:, None], held)
        loss = gather(losses.to(dev)).mean()
        if X is not None:
            new = tree_unflatten(params,
                                 _as_leaves(leaves, layout.leaf_views(X)))
        if algorithm == "dsgt":
            new = (new, (tree_unflatten(params, _as_leaves(
                leaves, layout.leaf_views(Y))), tree_unflatten(
                    params, _as_leaves(leaves, layout.leaf_views(Gp)))))
        if observer is not None:
            return new, {"loss": loss, "observation": observation}
        return new, loss

    return train_step


def _as_leaves(like, views):
    """``views`` as DTensors placed like the leaves of ``like`` (which are
    DTensors on a mesh), else as they are."""
    from torch.distributed.tensor import DTensor
    return [DTensor.from_local(v, t.device_mesh, t.placements, shape=t.shape,
                               stride=tuple(t.stride()))
            if isinstance(t, DTensor) else v for t, v in zip(like, views)]


def _batch_rows(batch, lo: int, L: int):
    """This block's agents' rows of a batch: DTensor leaves' local shards,
    the rows [lo, lo + L) of full (m, ...) leaves."""
    if isinstance(batch, dict):
        return {k: _batch_rows(v, lo, L) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_batch_rows(v, lo, L) for v in batch)
    if hasattr(batch, "to_local"):
        return batch.to_local()
    return batch[lo:lo + L]


def _own_u(G: torch.Tensor, layout, key, k: int, lam_bar, lo: int):
    """u = Lambda^k ∘ g of the agents lo, lo + 1, ... whose gradients are
    G's rows, by the unfused per-agent formula (the reference's
    ``_per_agent_obfuscated``, `core.pdsgd._obfuscated_rows`' formula),
    keyed by their global ids."""
    from ..core.privacy import agent_key, obfuscated_gradient, tree_leaves
    from ..kernels.build import to_device
    key = to_device(key, G.device)  # the draws on G's device, not the host
    lam_key = prng.fold_in(key, 1)
    U = torch.zeros_like(G)
    for r in range(G.shape[0]):
        u = obfuscated_gradient(agent_key(lam_key, k, lo + r),
                                layout.tree(G[r]), lam_bar)
        for view, leaf in zip(layout.leaf_views(U[r]), tree_leaves(u)):
            view.copy_(leaf)
    return U


def _own_bits(key, k: int, layout, lo: int, L: int, dev):
    """The Lambda^k bits of agents lo .. lo + L - 1 laid out like their
    flat rows (`core.pdsgd.per_agent_bits`' rows lo .. lo + L - 1)."""
    from ..core.pdsgd import lambda_key_table
    from ..kernels.build import to_device
    table = lambda_key_table(key, k, L, layout.n_leaves,
                             agents=torch.arange(lo, lo + L))
    return prng.leaf_bits(to_device(table, dev), layout.offsets, L,
                          layout.width)


def _mesh_dense(mesh, X, G, layout, key, k, W, support, mask, lam_bar,
                use_pallas, observer, lo, gather):
    """The dense schedule with one agent a rank: this rank's u (the
    obfuscate kernel reading its own Lambda bits, or the unfused
    formula), x and u gathered over the agent axes, then the gossip of
    `core.pdsgd.pdsgd_update`'s route over all rows (the gossip kernel,
    the masked one with ``mask``, or `core.pdsgd.oracle_mix` per leaf);
    the rank keeps its row."""
    from ..core.pdsgd import oracle_mix
    from ..core.privacy import agent_key, sample_B
    from ..kernels.gossip import gossip_update, masked_gossip_update
    from ..kernels.obfuscate import obfuscate_update
    from ..privacy import observe as O
    L = X.shape[0]
    B = sample_B(agent_key(prng.fold_in(key, 2), k, 0), support)
    if use_pallas:
        bits = _own_bits(key, k, layout, lo, L, X.device)
        U = obfuscate_update(X, G, bits, lam_bar, 0.0, -1.0)
    else:
        U = _own_u(G, layout, key, k, lam_bar, lo)
    Xa, Ua = gather(X), gather(U)
    observation = None
    if observer is not None:
        D = layout.size
        rec = {"support": support, "W": W, "B": B}
        if "x" in observer.fields:
            rec["x_flat"] = Xa[:, :D].float()
        if "u" in observer.fields:
            rec["u_flat"] = Ua[:, :D].float()
        if "g" in observer.fields:
            rec["g_flat"] = gather(G)[:, :D].float()
        observation = O.adversary_view(observer, O.full_record(
            v=O.wire_messages(W, B, Xa[:, :D], Ua[:, :D]), **rec))
    if not use_pallas:
        out = torch.zeros_like(Xa)
        for o, x, u in zip(layout.leaf_views(out), layout.leaf_views(Xa),
                           layout.leaf_views(Ua)):
            o.copy_(oracle_mix(W, x) - oracle_mix(B, u))
    elif mask is not None:
        out = masked_gossip_update(mask, B, Xa, Ua)
    else:
        out = gossip_update(W, B, Xa, Ua)
    return out[lo:lo + L], observation


def _sub_placements(mesh, placements) -> list:
    """A (m, ...) leaf's placements on the mesh without its agent axes, the
    dimensions counted without the agent dimension."""
    from torch.distributed.tensor import Shard
    return [Shard(p.dim - 1) if isinstance(p, Shard) else p
            for n, p in zip(mesh.mesh_dim_names, placements)
            if n not in ("pod", "data")]


def sharded_pdsgd_step(bundle, mesh, params, batch, key, k: int, W,
                       support, mask, lam_bar, specs):
    """The sharded execution's step on this rank (its agent: the mesh's
    "data" coordinate), W/support/mask the step's coupling, lam_bar its
    step size, ``key`` its key, ``specs`` the leaves' specs: the
    agent's parameters as DTensors on its (fsdp, model) block, the loss
    and its gradient by DTensor propagation (plain tensors the model
    makes, the rotary tables and masks, count as replicated), each
    gradient reduced onto its parameter's placements; then the leafwise
    update (`dist.sharding.mesh_pdsgd_tree`: B1 on the rank's block, the
    agents' blocks gathered over the agent axes, B2 or B4).  Returns the
    new (m, ...) DTensor tree and the agent's loss as a (1,) tensor."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from ..core.privacy import agent_key, sample_B, tree_leaves, \
        tree_unflatten
    from ..dist.sharding import (TRAIN_RULES, local_block, logical_spec,
                                 mesh_pdsgd_tree)
    from ..dist.sharding import placements as spec_placements
    from ..kernels.ops import FlatLayout
    from ..dist.collectives import mesh_agent
    names = mesh.mesh_dim_names
    sub = mesh[tuple(n for n in names if n not in ("pod", "data"))]
    lo = mesh_agent(mesh)
    leaves = tree_leaves(params)
    agent = []
    for t in leaves:
        loc = t.to_local()
        if loc.shape[0] != 1:
            raise ValueError("the sharded execution takes one agent a rank")
        shape = tuple(t.shape[1:])
        agent.append(DTensor.from_local(
            loc[0].detach(), sub, _sub_placements(mesh, t.placements),
            shape=shape, stride=_contiguous_stride(shape),
            run_check=False).requires_grad_())

    def agent_batch(b):
        if isinstance(b, dict):
            return {n: agent_batch(v) for n, v in b.items()}
        if isinstance(b, DTensor):
            loc = b.to_local()[0]
            shape = tuple(b.shape[1:])
            return DTensor.from_local(loc, sub,
                                      _sub_placements(mesh, b.placements),
                                      shape=shape,
                                      stride=_contiguous_stride(shape),
                                      run_check=False)
        row = b[lo]
        log = ("batch", "seq") + (None,) * (row.dim() - 2)
        return local_block(sub, row.to(agent[0].device), spec_placements(
            logical_spec(sub, row.shape, log, TRAIN_RULES), sub, row.dim()))

    with implicit_replication():
        loss = bundle.loss_fn(tree_unflatten(params, agent),
                              agent_batch(batch))
        grads = torch.autograd.grad(loss, agent, allow_unused=True)
    g_dt = []
    for t, a, g in zip(leaves, agent, grads):
        gl = (torch.zeros_like(a.to_local()) if g is None
              else g.redistribute(sub, a.placements).to_local())
        g_dt.append(DTensor.from_local(gl[None], mesh, t.placements,
                                       shape=t.shape, stride=t.stride(),
                                       run_check=False))
    single = tree_unflatten(params, [torch.empty(a.shape, dtype=a.dtype,
                                                 device="meta")
                                     for a in agent])
    layout = FlatLayout.of(single)
    dev = agent[0].to_local().device
    bits_row = _own_bits(key, k, layout, lo, 1, dev)
    bits = []
    for t, a, o0, o1, shp in zip(leaves, agent, layout.offsets[:-1],
                                 layout.offsets[1:], layout.shapes):
        blk = local_block(sub, bits_row[0, o0:o1].reshape(shp),
                     a.placements).to_local()
        bits.append(DTensor.from_local(blk[None], mesh, t.placements,
                                       shape=t.shape, stride=t.stride(),
                                       run_check=False))
    B = sample_B(agent_key(prng.fold_in(key, 2), k, 0), support)
    new = mesh_pdsgd_tree(W, B, params, tree_unflatten(params, g_dt),
                          tree_unflatten(params, bits), lam_bar, mesh=mesh,
                          leaf_specs=specs, mask=mask)
    loss = loss.full_tensor() if isinstance(loss, DTensor) else loss
    return new, loss.detach().float().reshape(1)


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))
