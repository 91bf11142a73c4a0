"""The paper's privacy-preserving decentralized SGD, Eq. (4),

    x^{k+1} = W x^k - B^k (Lambda^k ∘ g^k),

(counterpart of ``repro.core.pdsgd``; the ``pdsgd`` algorithm over a static
or time-varying mixing process, with agent faults, sentinels and
trimmed-mean aggregation, in the concat or the ring kernel layout — the
baselines, observers and clipping come later).

State layout.  All m agents' parameters live in ONE flat (m, width) buffer,
each row the agent's leaves concatenated in tree order and zero-padded to
a multiple of 512 (`kernels.FlatLayout`, the reference's concat layout).
The model sees views into that buffer, so the fused update needs no
flatten/concat.  The step updates the buffer in place where the reference
donates it: u is written over the gradient buffer and x' over the
parameters.

Randomness.  Lambda^k and B^k come from the reference's key derivation,
reproduced bit for bit by `prng`: B^k from ``agent_key(fold_in(key, 2),
step, 0)``; Lambda^k from one key per (agent, leaf),
``split(agent_key(fold_in(key, 1), step, a), n_leaves)`` — the keys
``repro.core.pdsgd._per_agent_bits`` draws its bits from.  On the main
path the obfuscate kernel draws the bits itself from that key table.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..dist import collectives as C
from ..faults.inject import (guarded_gossip_mix, neighbor_avg_warmstart,
                             trimmed_mean_mix)
from ..faults.process import FaultProcess, realize_coupling
from ..kernels.build import to_device
from ..kernels.obfuscate import obfuscate_update, obfuscate_update_krng
from ..kernels.ops import FlatLayout, fused_pdsgd_flat, ring_pdsgd_flat
from . import prng
from .mixing import MixingProcess, as_process
from .privacy import (agent_key, obfuscated_gradient, sample_B, tree_leaves,
                      tree_unflatten)
from .schedules import Schedule
from .topology import Topology

__all__ = ["DecentralizedState", "init_state", "consensus_error",
           "lambda_key_table", "per_agent_bits", "gossip_mix",
           "pdsgd_update", "obfuscate_flat", "make_decentralized_step"]

_LAYOUTS = ("concat", "ring")
_RING_CORRUPT = ("kernel_layout='ring' does not carry corrupt-link "
                 "injection; the guarded fault path stays dense")


def _check_layout(kernel_layout: str) -> None:
    if kernel_layout not in _LAYOUTS:
        raise ValueError(f"unknown kernel_layout {kernel_layout!r}; have "
                         f"{_LAYOUTS} (the leafwise layout of sharded "
                         f"agents is not ported yet)")


@dataclasses.dataclass
class DecentralizedState:
    """Per-agent parameters as one flat (m, width) buffer, plus the step."""

    flat: torch.Tensor
    layout: FlatLayout
    step: int = 0

    @property
    def num_agents(self) -> int:
        return int(self.flat.shape[0])

    @property
    def params(self):
        """The parameter tree, leaves (m, ...) viewing `flat`."""
        return self.layout.tree(self.flat)


def init_state(params, m: int, device=None) -> DecentralizedState:
    """Replicate a single-agent parameter tree to m agents."""
    layout = FlatLayout.of(params)
    leaves = tree_leaves(params)
    device = torch.device(device) if device is not None else leaves[0].device
    flat = torch.zeros((m, layout.width), dtype=leaves[0].dtype,
                       device=device)
    for view, leaf in zip(layout.leaf_views(flat), leaves):
        view.copy_(leaf.to(device))
    return DecentralizedState(flat=flat, layout=layout, step=0)


@torch.no_grad()
def consensus_error(flat: torch.Tensor, chunk: int = 1 << 24) -> torch.Tensor:
    """sum_i ||x_i - x_bar||^2 over a flat (m, width) buffer: m times the
    per-column population variance, summed, in f32, a column chunk at a
    time (padding columns are equal across agents and add nothing)."""
    m = flat.shape[0]
    total = torch.zeros((), dtype=torch.float32, device=flat.device)
    for s in range(0, flat.shape[1], chunk):
        x = flat[:, s:s + chunk].float()
        total += torch.var(x, dim=0, correction=0).sum() * m
    return total


def lambda_key_table(key: torch.Tensor, step: int, m: int,
                     n_leaves: int) -> torch.Tensor:
    """(m, n_leaves, 2) keys: row a is ``split(agent_key(fold_in(key, 1),
    step, a), n_leaves)``."""
    lam_key = prng.fold_in(key, 1)
    return torch.stack([prng.split(agent_key(lam_key, step, a), n_leaves)
                        for a in range(m)])


def per_agent_bits(key: torch.Tensor, step: int, layout: FlatLayout, m: int,
                   device=None) -> torch.Tensor:
    """The Lambda^k bits of every agent laid out like the flat buffer, as
    (m, width) uint32: ``repro.core.pdsgd._per_agent_bits``, flattened and
    padded with zeros."""
    table = to_device(lambda_key_table(key, step, m, layout.n_leaves),
                      device or "cpu")
    return prng.leaf_bits(table, layout.offsets, m, layout.width)


def gossip_mix(mat: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """y_i = sum_j mat[i, j] x_j over the leading agent axis, in f32, cast
    to p's dtype."""
    y = mat.to(p.dtype).float() @ p.reshape(p.shape[0], -1).float()
    return y.reshape(p.shape).to(p.dtype)


def _obfuscated_rows(G: torch.Tensor, layout: FlatLayout,
                     key: torch.Tensor, step: int,
                     lam_bar) -> torch.Tensor:
    """u = Lambda^k ∘ g per agent by the reference's unfused formula
    (`privacy.obfuscated_gradient` over each agent's leaves), as a new
    flat buffer."""
    lam_key = prng.fold_in(key, 1)
    u_rows = torch.zeros_like(G)
    for a in range(G.shape[0]):
        u = obfuscated_gradient(agent_key(lam_key, step, a),
                                layout.tree(G[a]), lam_bar)
        for view, leaf in zip(layout.leaf_views(u_rows[a]), tree_leaves(u)):
            view.copy_(leaf)
    return u_rows


def _lambda_source(key: torch.Tensor, step: int, layout: FlatLayout,
                   X: torch.Tensor, kernel_rng: bool) -> dict:
    """What the obfuscate kernel draws Lambda^k from: the key table and the
    leaf offsets (``kernel_rng``), or the `per_agent_bits` buffer."""
    m = X.shape[0]
    if kernel_rng:
        return {"keys": lambda_key_table(key, step, m, layout.n_leaves),
                "offsets": torch.tensor(layout.offsets, dtype=torch.int64)}
    return {"bits": per_agent_bits(key, step, layout, m, device=X.device)}


@torch.no_grad()
def pdsgd_update(X: torch.Tensor, G: torch.Tensor, layout: FlatLayout, *,
                 key: torch.Tensor, step: int, W: torch.Tensor,
                 support: torch.Tensor, lam_bar, kernel_rng: bool = True,
                 in_place: bool = False, eager: bool = False,
                 mask: torch.Tensor | None = None,
                 corrupt: torch.Tensor | None = None,
                 corrupt_mode: str = "nan", corrupt_scale: float = 1e4,
                 guard_clip: float | None = 1e3,
                 kernel_layout: str = "concat",
                 torus_shape: tuple[int, int] | None = None) -> torch.Tensor:
    """One iteration of Eq. (4) on flat (m, width) buffers; returns x'.

    ``W``/``support`` are this step's realized coupling and its support
    (B^k is drawn on the support); ``mask`` is the realized edge mask of a
    time-varying or faulty coupling (None for a static one).  ``corrupt``
    (an (m,) 0/1 vector of corrupt senders) selects the fault-tolerant
    gossip: the corrupt agents' transmits are poisoned per
    ``corrupt_mode``/``corrupt_scale`` and every link is finite-guarded at
    ``guard_clip`` (None: no guard) at the receiver.

    The training step takes the fused branch: `kernels.fused_pdsgd_flat`,
    the obfuscate kernel drawing Lambda from the key table in-kernel
    (``kernel_rng=True``, the reference's TPU default) or reading the
    `per_agent_bits` buffer (``kernel_rng=False``, the reference's HBM
    bits path), then the gossip kernel the coupling asks for (static W,
    the mask, or the guarded one).  ``in_place`` overwrites G with u and X
    with x'.

    ``kernel_layout="ring"`` runs the whole update as ONE kernel from
    per-direction tables: the realized W_k and B^k are split by
    `dist.collectives.directional_weights` / `rows_from_dense` over the
    ``torus_shape`` = (n_data, n_pod) torus (default (m, 1), one ring,
    which must hold the coupling's support), and
    `kernels.ops.ring_pdsgd_flat` draws Lambda, obfuscates and exchanges
    each direction's message in one pass.  ``mask`` is subsumed: a
    dropped link is a zero entry of W_k and B^k, hence a zero table slot
    and an exactly-zero message.  ``corrupt`` is refused (the guarded
    fault path stays dense).

    ``eager=True`` is the reference's unfused formula (its
    ``use_pallas=False`` branch, whatever the layout): per agent
    `privacy.obfuscated_gradient` over the leaves, then per leaf
    `gossip_mix`, or `faults.inject.guarded_gossip_mix` when ``corrupt``
    is given.  It realizes the same Lambda^k and B^k; it is the
    port-internal oracle the tests hold the fused branch against, and
    writes a new buffer.
    """
    _check_layout(kernel_layout)
    B = sample_B(agent_key(prng.fold_in(key, 2), step, 0), support)
    if kernel_layout == "ring" and not eager:
        if corrupt is not None:
            raise ValueError(_RING_CORRUPT)
        m = X.shape[0]
        n_data, n_pod = torus_shape if torus_shape is not None else (m, 1)
        if n_data * n_pod != m:
            raise ValueError(
                f"torus_shape {n_pod}x{n_data} does not hold m={m} agents")
        tabs = C.directional_weights(W, n_data, n_pod)
        w_tab = torch.cat([tabs["w_self"][:, None], tabs["w_dir"]], dim=1)
        b_rows = C.rows_from_dense(B, n_data, n_pod)
        return ring_pdsgd_flat(
            w_tab, b_rows, C.source_table(n_data, n_pod), X, G, lam_bar,
            **_lambda_source(key, step, layout, X, kernel_rng),
            in_place=in_place)
    if eager:
        u_rows = _obfuscated_rows(G, layout, key, step, lam_bar)
        out = torch.zeros_like(X)
        for o, x, u in zip(layout.leaf_views(out), layout.leaf_views(X),
                           layout.leaf_views(u_rows)):
            if corrupt is not None:
                o.copy_(guarded_gossip_mix(W, B, x, u, corrupt,
                                           mode=corrupt_mode,
                                           scale=corrupt_scale,
                                           clip=guard_clip))
            else:
                o.copy_(gossip_mix(W, x) - gossip_mix(B, u))
        return out
    out, _ = fused_pdsgd_flat(
        W, B, X, G, lam_bar, **_lambda_source(key, step, layout, X,
                                              kernel_rng),
        mask=mask, corrupt=corrupt, corrupt_mode=corrupt_mode,
        corrupt_scale=corrupt_scale, guard_clip=guard_clip,
        in_place=in_place)
    return out


@torch.no_grad()
def obfuscate_flat(X: torch.Tensor, G: torch.Tensor, layout: FlatLayout, *,
                   key: torch.Tensor, step: int, lam_bar,
                   kernel_rng: bool = True,
                   eager: bool = False) -> torch.Tensor:
    """u = Lambda^k ∘ g alone (the descent of trimmed-mean aggregation):
    through the obfuscate kernel, written over G, or by the unfused
    formula (``eager``) into a new buffer.  The same Lambda^k as
    `pdsgd_update`."""
    if eager:
        return _obfuscated_rows(G, layout, key, step, lam_bar)
    src = _lambda_source(key, step, layout, X, kernel_rng)
    if kernel_rng:
        return obfuscate_update_krng(X, G, src["keys"], src["offsets"],
                                     lam_bar, 0.0, -1.0, out=G)
    return obfuscate_update(X, G, src["bits"], lam_bar, 0.0, -1.0, out=G)


def _agent_batch(batch, a: int):
    if isinstance(batch, dict):
        return {k: _agent_batch(v, a) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_agent_batch(v, a) for v in batch)
    return batch[a]


def _agent_grads(loss_fn, state: DecentralizedState, batch,
                 G: torch.Tensor) -> torch.Tensor:
    """Each agent's loss and gradient, one agent at a time (the reference
    vmaps ``value_and_grad``); gradients land in G's rows.  Returns the
    (m,) f32 losses."""
    layout = state.layout
    losses = []
    for a in range(state.num_agents):
        params = [v.detach().requires_grad_()
                  for v in layout.leaf_views(state.flat[a])]
        loss = loss_fn(tree_unflatten(layout.template, params),
                       _agent_batch(batch, a))
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        with torch.no_grad():
            for view, g in zip(layout.leaf_views(G[a]), grads):
                if g is None:
                    view.zero_()
                else:
                    view.copy_(g)
        losses.append(loss.detach().float())
    G[:, layout.size:].zero_()
    return torch.stack(losses)


def _finite(flat: torch.Tensor, chunk: int = 1 << 24) -> torch.Tensor:
    """Whether every entry of an (m, n) buffer is finite, as a device bool,
    a column chunk at a time (no (m, n) mask is allocated)."""
    ok = torch.ones((), dtype=torch.bool, device=flat.device)
    for s in range(0, flat.shape[1], chunk):
        ok &= torch.isfinite(flat[:, s:s + chunk]).all()
    return ok


@torch.no_grad()
def _warm_start(flat: torch.Tensor, mask: torch.Tensor, alive: torch.Tensor,
                alive_prev: torch.Tensor, chunk: int = 1 << 22) -> None:
    """`faults.inject.neighbor_avg_warmstart` on the flat buffer, in place,
    a column chunk at a time (the rows of agents that do not rejoin are
    written back unchanged)."""
    for s in range(0, flat.shape[1], chunk):
        part = flat[:, s:s + chunk]
        part.copy_(neighbor_avg_warmstart(part, mask, alive, alive_prev)[0])


@torch.no_grad()
def _trimmed_mean(flat: torch.Tensor, U: torch.Tensor, support, corrupt, *,
                  trim: int, mode: str, scale: float,
                  chunk: int = 1 << 22) -> None:
    """`faults.inject.trimmed_mean_mix` on the flat buffers, x' written over
    ``flat`` a column chunk at a time (columns are independent)."""
    for s in range(0, flat.shape[1], chunk):
        part = flat[:, s:s + chunk]
        part.copy_(trimmed_mean_mix(part, U[:, s:s + chunk], support,
                                    corrupt, trim=trim, mode=mode,
                                    scale=scale))


def make_decentralized_step(loss_fn: Callable[[Any, Any], torch.Tensor],
                            topology: Topology | MixingProcess,
                            schedule: Schedule, kernel_rng: bool = True, *,
                            faults: FaultProcess | None = None,
                            nan_policy: str = "off",
                            aggregation: str = "gossip", trim: int = 1,
                            eager: bool = False,
                            kernel_layout: str = "concat",
                            torus_shape: tuple[int, int] | None = None):
    """``step(state, batch, key) -> (state, aux)`` for PDSGD.

    ``loss_fn(params_i, batch_i)`` is ONE agent's scalar loss; batch leaves
    carry a leading (m, ...) agent axis.  ``key`` is the step's key (the
    reference's ``fold_in(run_key, k)``).  lam_bar is evaluated on the
    buffer's device from the step counter.  The returned state shares the
    input state's buffer, which the step has updated in place.
    ``kernel_rng`` picks how the obfuscate kernel gets Lambda's bits (see
    `pdsgd_update`); ``eager=True`` runs the unfused formula instead of
    the kernels (the tests' oracle).  ``kernel_layout``/``torus_shape``
    pick the update's layout (`pdsgd_update`): ``"ring"`` runs it as one
    ring kernel per step.

    ``topology`` may be a `MixingProcess`: the step realizes W_k from the
    absolute step each iteration, and a time-varying one routes the
    gossip through the masked kernel.

    ``faults`` (a `faults.FaultProcess`) composes the coupling per step
    through `faults.realize_coupling`; down agents keep their held rows;
    rejoining agents warm start from their stable neighbours first with
    ``rejoin='neighbor-avg'``; corrupt transmits go through the guarded
    kernel.  An inert process is no process, so the rate-0 step is the
    fault-free step.  ``nan_policy`` adds isfinite sentinels on the loss
    and the updated parameters: ``"warn"`` counts
    (``aux["fault_nonfinite"]``), ``"skip"`` also restores the held
    buffer on a non-finite step.  ``aggregation="trimmed_mean"`` replaces
    the gossip by coordinate-wise trimmed-mean aggregation of the
    neighbours' states (`faults.inject.trimmed_mean_mix`) with each
    agent's own obfuscated descent.

    Held state and the in-place update.  The reference freezes a down
    agent's row to the held state after the gossip; here the gossip
    writes x' over the buffer, so the step copies the down agents' rows
    (at most m of them) before it and writes them back after.  Under
    ``nan_policy="skip"`` it copies the whole held buffer first (one more
    (m, width) buffer for the step).  The neighbour-average warm start
    changes the held rows before the gradients, as the reference's.
    """
    if nan_policy not in ("off", "warn", "skip"):
        raise ValueError(f"unknown nan_policy {nan_policy!r}; "
                         f"have ('off', 'warn', 'skip')")
    if aggregation not in ("gossip", "trimmed_mean"):
        raise ValueError(f"unknown aggregation {aggregation!r}; "
                         f"have ('gossip', 'trimmed_mean')")
    _check_layout(kernel_layout)
    process = as_process(topology)
    if faults is not None and faults.is_inert:
        faults = None  # the rate-0 path IS the fault-free path
    if faults is not None and faults.num_agents != process.num_agents:
        raise ValueError(
            f"faults built for {faults.num_agents} agents but the "
            f"topology has {process.num_agents}")
    m = process.num_agents
    if aggregation == "trimmed_mean" and not (1 <= trim
                                              and m - 2 * trim >= 1):
        raise ValueError(
            f"trim must satisfy 1 <= trim and m - 2*trim >= 1; "
            f"got trim={trim}, m={m}")
    corrupting = faults is not None and faults.has_corruption
    if corrupting and kernel_layout == "ring" and not eager \
            and aggregation == "gossip":
        raise ValueError(_RING_CORRUPT)
    rejoining = (faults is not None and faults.has_crash
                 and not faults.is_failstop)

    def step(state: DecentralizedState, batch, key: torch.Tensor):
        if state.num_agents != m:
            raise ValueError(f"state has {state.num_agents} agents, the "
                             f"topology {m}")
        X = state.flat
        dev = X.device
        k = state.step
        alive = corrupt = rejoin = None
        # named ranges: the host time of each part in a torch.profiler trace
        with torch.profiler.record_function("coupling"):
            if faults is None:
                W, support, mask = process.realize(k, dev)
            else:
                W, support, mask, alive, corrupt = realize_coupling(
                    process, faults, k, dev)
            lam_bar = schedule(torch.full((), float(k), dtype=torch.float32,
                                          device=dev))
        with torch.profiler.record_function("held_state"):
            # the held anchor: the buffer with rejoiners warm started
            if rejoining:
                prev = faults.alive_before(k)
                rejoin = alive * (1.0 - prev)
                if faults.rejoin == "neighbor-avg" and bool(rejoin.any()):
                    _warm_start(X, mask, alive, prev)
            down = ([] if alive is None else
                    [int(i) for i in torch.nonzero(alive == 0).flatten()])
            held_rows = {i: X[i].clone() for i in down}
            held = X.clone() if nan_policy == "skip" else None
        G = torch.empty_like(X)
        with torch.profiler.record_function("agent_grads"):
            losses = _agent_grads(loss_fn, state, batch, G)
        with torch.profiler.record_function("pdsgd_update"):
            if aggregation == "trimmed_mean":
                U = obfuscate_flat(X, G, state.layout, key=key, step=k,
                                   lam_bar=lam_bar, kernel_rng=kernel_rng,
                                   eager=eager)
                _trimmed_mean(
                    X, U, support,
                    corrupt if corrupt is not None else torch.zeros(m),
                    trim=trim,
                    mode=faults.corrupt_mode if faults else "nan",
                    scale=faults.corrupt_scale if faults else 1e4)
                del U
            else:
                out = pdsgd_update(
                    X, G, state.layout, key=key, step=k, W=W,
                    support=support, lam_bar=lam_bar, kernel_rng=kernel_rng,
                    in_place=True, eager=eager, mask=mask,
                    corrupt=corrupt if corrupting else None,
                    corrupt_mode=faults.corrupt_mode if corrupting
                    else "nan",
                    corrupt_scale=faults.corrupt_scale if corrupting
                    else 1e4,
                    guard_clip=faults.guard_clip if corrupting else 1e3,
                    kernel_layout=kernel_layout, torus_shape=torus_shape)
                if out is not X:
                    X.copy_(out)
                del out
        del G
        aux = {"loss": losses.mean()}
        with torch.profiler.record_function("held_state"):
            # down agents neither transmit (the coupling saw to that) nor
            # update; restored before the sentinels, as in the reference
            for i, row in held_rows.items():
                X[i].copy_(row)
            del held_rows
            if nan_policy != "off":
                finite = bool(torch.isfinite(losses).all()
                              & _finite(X[:, :state.layout.size]))
                aux["fault_nonfinite"] = int(not finite)
                if nan_policy == "skip" and not finite:
                    X.copy_(held)
            del held
        new = DecentralizedState(flat=X, layout=state.layout, step=k + 1)
        with torch.profiler.record_function("consensus_error"):
            aux["consensus_error"] = consensus_error(
                X[:, :state.layout.size])
        if alive is not None:
            aux["fault_down"] = int(m - alive.sum())
            aux["fault_corrupt"] = int(corrupt.sum())
            aux["fault_rejoin"] = (int(rejoin.sum()) if rejoin is not None
                                   else 0)
        return new, aux

    return step
