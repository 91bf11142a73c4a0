"""The paper's privacy-preserving decentralized SGD, Eq. (4),

    x^{k+1} = W x^k - B^k (Lambda^k ∘ g^k),

(counterpart of ``repro.core.pdsgd``; the ``pdsgd`` algorithm with a static
mixing process — the baselines, faults, observers and clipping come later).

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

from ..kernels.build import to_device
from ..kernels.ops import FlatLayout, fused_pdsgd_flat
from . import prng
from .mixing import MixingProcess, as_process
from .privacy import (agent_key, obfuscated_gradient, sample_B, tree_leaves,
                      tree_unflatten)
from .schedules import Schedule
from .topology import Topology

__all__ = ["DecentralizedState", "init_state", "consensus_error",
           "lambda_key_table", "per_agent_bits", "gossip_mix",
           "pdsgd_update", "make_decentralized_step"]


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


@torch.no_grad()
def pdsgd_update(X: torch.Tensor, G: torch.Tensor, layout: FlatLayout, *,
                 key: torch.Tensor, step: int, W: torch.Tensor,
                 support: torch.Tensor, lam_bar, kernel_rng: bool = True,
                 in_place: bool = False,
                 eager: bool = False) -> torch.Tensor:
    """One iteration of Eq. (4) on flat (m, width) buffers; returns x'.

    The training step takes the fused branch: `kernels.fused_pdsgd_flat`,
    the obfuscate kernel drawing Lambda from the key table in-kernel
    (``kernel_rng=True``, the reference's TPU default) or reading the
    `per_agent_bits` buffer (``kernel_rng=False``, the reference's HBM
    bits path), then the gossip kernel.  ``in_place`` overwrites G with u
    and X with x'.

    ``eager=True`` is the reference's unfused formula (its
    ``use_pallas=False`` branch): per agent `privacy.obfuscated_gradient`
    over the leaves, then `gossip_mix` per leaf.  It realizes the same
    Lambda^k and B^k; `make_decentralized_step` never takes it — it is
    the port-internal oracle the tests hold the fused branch against.
    """
    m = X.shape[0]
    B = sample_B(agent_key(prng.fold_in(key, 2), step, 0), support)
    if eager:
        lam_key = prng.fold_in(key, 1)
        out = torch.zeros_like(X)
        u_rows = torch.zeros_like(G)
        for a in range(m):
            u = obfuscated_gradient(agent_key(lam_key, step, a),
                                    layout.tree(G[a]), lam_bar)
            for view, leaf in zip(layout.leaf_views(u_rows[a]),
                                  tree_leaves(u)):
                view.copy_(leaf)
        for o, x, u in zip(layout.leaf_views(out), layout.leaf_views(X),
                           layout.leaf_views(u_rows)):
            o.copy_(gossip_mix(W, x) - gossip_mix(B, u))
        return out
    offsets = torch.tensor(layout.offsets, dtype=torch.int64)
    if kernel_rng:
        keys = lambda_key_table(key, step, m, layout.n_leaves)
        out, _ = fused_pdsgd_flat(W, B, X, G, lam_bar, keys=keys,
                                  offsets=offsets, in_place=in_place)
    else:
        bits = per_agent_bits(key, step, layout, m, device=X.device)
        out, _ = fused_pdsgd_flat(W, B, X, G, lam_bar, bits=bits,
                                  in_place=in_place)
    return out


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


def make_decentralized_step(loss_fn: Callable[[Any, Any], torch.Tensor],
                            topology: Topology | MixingProcess,
                            schedule: Schedule, kernel_rng: bool = True):
    """``step(state, batch, key) -> (state, aux)`` for PDSGD.

    ``loss_fn(params_i, batch_i)`` is ONE agent's scalar loss; batch leaves
    carry a leading (m, ...) agent axis.  ``key`` is the step's key (the
    reference's ``fold_in(run_key, k)``).  lam_bar is evaluated on the
    buffer's device from the step counter.  The returned state shares the
    input state's buffer, which the step has updated in place.
    ``kernel_rng`` picks how the obfuscate kernel gets Lambda's bits (see
    `pdsgd_update`).
    """
    process = as_process(topology)

    def step(state: DecentralizedState, batch, key: torch.Tensor):
        if state.num_agents != process.num_agents:
            raise ValueError(f"state has {state.num_agents} agents, the "
                             f"topology {process.num_agents}")
        dev = state.flat.device
        W, support, _ = process.realize(state.step, dev)
        lam_bar = schedule(torch.full((), float(state.step),
                                      dtype=torch.float32, device=dev))
        G = torch.empty_like(state.flat)
        # named ranges: the host time of each part in a torch.profiler trace
        with torch.profiler.record_function("agent_grads"):
            losses = _agent_grads(loss_fn, state, batch, G)
        with torch.profiler.record_function("pdsgd_update"):
            pdsgd_update(state.flat, G, state.layout, key=key,
                         step=state.step, W=W, support=support,
                         lam_bar=lam_bar, kernel_rng=kernel_rng,
                         in_place=True)
        del G
        new = DecentralizedState(flat=state.flat, layout=state.layout,
                                 step=state.step + 1)
        with torch.profiler.record_function("consensus_error"):
            aux = {"loss": losses.mean(),
                   "consensus_error": consensus_error(state.flat)}
        return new, aux

    return step
