"""The paper's privacy-preserving decentralized SGD, Eq. (4),

    x^{k+1} = W x^k - B^k (Lambda^k ∘ g^k),

and the baselines it is evaluated against (counterpart of
``repro.core.pdsgd``):

  * ``pdsgd``   : Eq. (4), over a static or time-varying mixing process,
                  with agent faults, sentinels and trimmed-mean
                  aggregation, in the concat, the ring or the leafwise
                  kernel layout;
  * ``dsgd``    : x^{k+1} = W x^k - lam^k g^k                  (Lian et al.)
  * ``dsgt``    : gradient tracking, x and the tracker y both gossiped
                  (2x PDSGD's message volume);
  * ``dp_dsgd`` : dsgd with N(0, sigma_DP^2) noise added to g  (Table I).

State layout.  All m agents' parameters live in ONE flat (m, width) buffer,
each row the agent's leaves concatenated in tree order and zero-padded to
a multiple of 512 (`kernels.FlatLayout`, the reference's concat layout).
The model sees views into that buffer, so the fused update needs no
flatten/concat.  The step updates the buffer in place where the reference
donates it: u is written over the gradient buffer and x' over the
parameters.  DSGT's tracker pair is two more such buffers.

Randomness.  Lambda^k and B^k come from the reference's key derivation,
reproduced bit for bit by `prng`: B^k from ``agent_key(fold_in(key, 2),
step, 0)``; Lambda^k from one key per (agent, leaf),
``split(agent_key(fold_in(key, 1), step, a), n_leaves)`` — the keys
``repro.core.pdsgd._per_agent_bits`` draws its bits from.  On the main
path the obfuscate kernel draws the bits itself from that key table.
DP-DSGD's noise is ``normal(split(fold_in(key, 3), n_leaves)[l])`` over
each leaf's (m, ...) view.  ``partitionable=False`` on the step draws all
of them from jax's earlier threefry stream (`prng`).

The scanned step.  `make_scanned_steps` runs k steps per call of
`make_decentralized_step`'s ``step.inner`` at a step counter tensor: on
the CPU a loop, on the card one CUDA graph of k steps, whose keys,
schedule, coupling, faults and draws come from the device counter.
Threefry in int64 torch ops is exact on any device, a fault's outage
length is a float32 comparison, and B^k and the noise are drawn on the
buffer's device on either path, so the graph's steps are the eager
steps bit for bit.
"""
from __future__ import annotations

import ctypes
import dataclasses
import time
from typing import Any, Callable

import torch

from ..dist import collectives as C
from ..dist.sharding import mesh_pdsgd_tree
from ..faults.inject import (guarded_gossip_mix, neighbor_avg_warmstart,
                             trimmed_mean_mix)
from ..faults.process import FaultProcess, realize_coupling
from ..kernels.build import launch_counts, to_device
from ..kernels.obfuscate import obfuscate_update, obfuscate_update_krng
from ..kernels.ops import (FlatLayout, fused_pdsgd_flat, leafwise_pdsgd_flat,
                           ring_pdsgd_flat)
from ..optim.base import tree_map
from ..privacy import observe as O
from . import prng
from .mixing import MixingProcess, as_process
from .privacy import (agent_key, clip_gradients, obfuscated_gradient,
                      sample_B, tree_leaves, tree_unflatten)
from .schedules import Schedule
from .topology import Topology

__all__ = ["ALGORITHMS", "DecentralizedState", "init_state",
           "consensus_error", "lambda_key_table", "per_agent_bits",
           "gossip_mix", "fma_gossip_mix", "oracle_mix", "pdsgd_update", "dsgd_update", "dsgt_update",
           "dp_dsgd_update", "dp_noise_", "obfuscate_flat",
           "make_decentralized_step", "make_scanned_steps"]

ALGORITHMS = ("pdsgd", "dsgd", "dsgt", "dp_dsgd")
_LAYOUTS = ("concat", "leafwise", "ring")
_RING_CORRUPT = ("kernel_layout='ring' does not carry corrupt-link "
                 "injection; the guarded fault path stays dense")
_RING_STREAM = ("kernel_layout='ring' draws jax's partitionable threefry "
                "stream only")
_LEAFWISE_OBSERVE = ("observation capture is defined on the concatenated "
                     "wire buffer; kernel_layout='leafwise' does not "
                     "support it")
# columns a chunk of the plain (m, width) passes
_CHUNK = 1 << 24


def _check_layout(kernel_layout: str, mesh=None) -> None:
    if kernel_layout not in _LAYOUTS:
        raise ValueError(f"unknown kernel_layout {kernel_layout!r}; have "
                         f"{_LAYOUTS}")
    if mesh is not None and kernel_layout != "leafwise":
        raise ValueError(f"a mesh runs the leafwise layout only, not "
                         f"kernel_layout={kernel_layout!r}")


@dataclasses.dataclass
class DecentralizedState:
    """Per-agent parameters as one flat (m, width) buffer, plus the step.

    ``tracker`` is the algorithm's extra state: None, or for dsgt the pair
    (y^{k-1}, g^{k-1}), two (m, width) buffers in the parameters' dtype
    (`init_state(..., algorithm="dsgt")`)."""

    flat: torch.Tensor
    layout: FlatLayout
    step: int = 0
    tracker: tuple[torch.Tensor, torch.Tensor] | None = None

    @property
    def num_agents(self) -> int:
        return int(self.flat.shape[0])

    @property
    def params(self):
        """The parameter tree, leaves (m, ...) viewing `flat`."""
        return self.layout.tree(self.flat)


def init_state(params, m: int, device=None,
               algorithm: str = "pdsgd") -> DecentralizedState:
    """Replicate a single-agent parameter tree to m agents; ``algorithm``
    sizes the extra state (dsgt: a zero tracker pair)."""
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    layout = FlatLayout.of(params)
    leaves = tree_leaves(params)
    device = torch.device(device) if device is not None else leaves[0].device
    flat = torch.zeros((m, layout.width), dtype=leaves[0].dtype,
                       device=device)
    for view, leaf in zip(layout.leaf_views(flat), leaves):
        view.copy_(leaf.to(device))
    tracker = None
    if algorithm == "dsgt":
        tracker = (torch.zeros_like(flat), torch.zeros_like(flat))
    return DecentralizedState(flat=flat, layout=layout, step=0,
                              tracker=tracker)


@torch.no_grad()
def consensus_error(flat: torch.Tensor, chunk: int = _CHUNK) -> torch.Tensor:
    """sum_i ||x_i - x_bar||^2 over a flat (m, width) buffer: m times the
    per-column population variance, summed, in f32, a column chunk at a
    time (padding columns are equal across agents and add nothing)."""
    m = flat.shape[0]
    total = torch.zeros((), dtype=torch.float32, device=flat.device)
    for s in range(0, flat.shape[1], chunk):
        x = flat[:, s:s + chunk].float()
        total += torch.var(x, dim=0, correction=0).sum() * m
    return total


def lambda_key_table(key: torch.Tensor, step, m: int, n_leaves: int,
                     partitionable: bool = True,
                     agents: torch.Tensor | None = None) -> torch.Tensor:
    """(m, n_leaves, 2) keys: row r is ``split(agent_key(fold_in(key, 1),
    step, a), n_leaves)`` for agent a = ``agents[r]`` (default a = r), every
    row at once, on key's device (``step`` an int or a device counter;
    ``partitionable``: the threefry stream, `prng`).  A process owning a
    block of agents passes their global ids."""
    lam_key = prng.fold_in(key, 1)
    if agents is None:
        agents = torch.arange(m, dtype=torch.int64, device=key.device)
    else:
        agents = torch.as_tensor(agents, dtype=torch.int64).to(key.device)
        if agents.shape != (m,):
            raise ValueError(f"agents must be ({m},) ids, got "
                             f"{tuple(agents.shape)}")
    return prng.split(agent_key(lam_key, step, agents), n_leaves,
                      partitionable)


_OFFSETS: dict = {}


def _offsets(layout: FlatLayout, device) -> torch.Tensor:
    """The layout's leaf offsets as an int64 tensor on ``device``, made
    once per (layout, device): a CUDA graph reads the same tensor at
    every replay."""
    device = torch.device(device)
    cache_key = (layout.offsets, device)
    t = _OFFSETS.get(cache_key)
    if t is None:
        t = to_device(torch.tensor(layout.offsets, dtype=torch.int64),
                      device)
        _OFFSETS[cache_key] = t
    return t


def per_agent_bits(key: torch.Tensor, step, layout: FlatLayout, m: int,
                   device=None, partitionable: bool = True) -> torch.Tensor:
    """The Lambda^k bits of every agent laid out like the flat buffer, as
    (m, width) uint32: ``repro.core.pdsgd._per_agent_bits``, flattened and
    padded with zeros, drawn on ``device``."""
    table = to_device(lambda_key_table(key, step, m, layout.n_leaves,
                                       partitionable), device or "cpu")
    return prng.leaf_bits(table, layout.offsets, m, layout.width,
                          partitionable=partitionable)


def _pieces(n: int, chunk: int):
    """Column ranges ``[s, e)`` covering ``n`` columns, ``chunk`` wide,
    never a one-column piece (a matrix-vector product sums in another
    order than the matrix product): the last piece takes one more."""
    chunk = max(chunk, 2)
    s = 0
    while s < n:
        e = n if n - s <= chunk + 1 else s + chunk
        yield s, e
        s = e


@torch.no_grad()
def gossip_mix(mat: torch.Tensor, p: torch.Tensor,
               chunk: int = _CHUNK) -> torch.Tensor:
    """y_i = sum_j mat[i, j] x_j over the leading agent axis: mat cast to
    p's dtype, the products summed in f32 and the sum cast to p's dtype,
    a column chunk at a time (columns are independent, so the chunks
    change no value; no f32 copy of the whole buffer is made)."""
    m = p.shape[0]
    src = p.reshape(m, -1)
    matf = mat.to(p.dtype).float()
    out = torch.empty(src.shape, dtype=p.dtype, device=p.device)
    for s, e in _pieces(src.shape[1], chunk):
        out[:, s:e] = (matf @ src[:, s:e].float()).to(p.dtype)
    return out.reshape(p.shape)


def fma_f32(a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """C's ``fmaf(a, b, c)`` elementwise on f32 tensors: a * b + c rounded
    once to f32, in f64 arithmetic, on any device.  a * b is exact in f64;
    the f64 sum s and its exact error e (TwoSum) hold a * b + c; s
    rounded to f32 is the answer unless s lies exactly halfway between
    two f32 values and e is not 0, when the answer is the neighbour on
    e's side."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bv = s - p
    err = (p - (s - bv)) + (cd - bv)
    r = s.float()
    rd = r.double()
    toward = torch.where(s > rd, float("inf"), float("-inf")).float()
    other = torch.nextafter(r, toward)
    tie = (2.0 * s == rd + other.double()) & (err != 0)
    wrong = tie & (((err > 0) & (rd < s)) | ((err < 0) & (rd > s)))
    return torch.where(wrong, other, r)


@torch.no_grad()
def fma_gossip_mix(mat: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """`gossip_mix` summed as the gossip kernels sum on the card (B2/B4,
    ``csrc/gossip.cu``): per row one `fma_f32` chain over ascending j,
    from 0, on the f32 products, cast to p's dtype."""
    m = p.shape[0]
    src = p.reshape(m, -1)
    matf = mat.to(p.dtype).float()
    out = torch.empty(src.shape, dtype=p.dtype, device=p.device)
    # narrower pieces than gossip_mix's: each fma_f32 makes f64 temporaries
    for s, e in _pieces(src.shape[1], _CHUNK >> 4):
        acc = torch.zeros((m, e - s), dtype=torch.float32, device=p.device)
        for j in range(m):
            acc = fma_f32(matf[:, j:j + 1], src[j:j + 1, s:e].float(), acc)
        out[:, s:e] = acc.to(p.dtype)
    return out.reshape(p.shape)


def oracle_mix(mat: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The unfused oracle's mix: `fma_gossip_mix` on the card (the order
    of B2's accumulation, so the oracle's x' is B2's bit for bit),
    `gossip_mix` elsewhere (a matrix product, the order of the
    reference's ``W @ x`` on the CPU, and of the kernels' plain
    versions)."""
    if p.device.type == "cuda":
        return fma_gossip_mix(mat, p)
    return gossip_mix(mat, p)


def _descend(mixed: torch.Tensor, d: torch.Tensor, lam) -> torch.Tensor:
    """mixed - lam d in f32, cast to mixed's dtype.  In f32 it is the
    reference's ``a - lam * d`` operation for operation; the reference's
    f32 ``lam`` would promote bf16 parameters to f32, the port keeps the
    buffer's dtype."""
    return (mixed.float() - lam * d.float()).to(mixed.dtype)


@torch.no_grad()
def dsgd_update(X: torch.Tensor, G: torch.Tensor, *, W: torch.Tensor, lam,
                out: torch.Tensor | None = None,
                chunk: int = _CHUNK) -> torch.Tensor:
    """Conventional decentralized SGD: x' = W x - lam g on flat (m, width)
    buffers, a column piece at a time (``out`` may be X: each piece is
    read whole before it is written)."""
    out = torch.empty_like(X) if out is None else out
    for s, e in _pieces(X.shape[1], chunk):
        out[:, s:e] = _descend(gossip_mix(W, X[:, s:e]), G[:, s:e], lam)
    return out


@torch.no_grad()
def dsgt_update(X: torch.Tensor, Y: torch.Tensor, G: torch.Tensor,
                G_prev: torch.Tensor, *, W: torch.Tensor, lam,
                chunk: int = _CHUNK) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradient tracking on flat buffers, as the reference writes it:

        x^{k+1} = W x^k - lam y^k
        y^{k+1} = W y^k + g^{k+1} - g^k

    (``G`` is g^{k+1}, ``G_prev`` g^k); returns new (x', y').  The training
    step runs the phase-shifted form in place (`_dsgt_step_`)."""
    Xn, Yn = torch.empty_like(X), torch.empty_like(Y)
    for s, e in _pieces(X.shape[1], chunk):
        Xn[:, s:e] = _descend(gossip_mix(W, X[:, s:e]), Y[:, s:e], lam)
        Yn[:, s:e] = gossip_mix(W, Y[:, s:e]) + G[:, s:e] - G_prev[:, s:e]
    return Xn, Yn


@torch.no_grad()
def _dsgt_step_(X: torch.Tensor, Y: torch.Tensor, G_prev: torch.Tensor,
                G: torch.Tensor, *, W: torch.Tensor, lam,
                chunk: int = _CHUNK) -> None:
    """The step's DSGT, in place (the reference's
    ``make_decentralized_step`` dsgt branch, ``pdsgd.py:600-613``): the
    tracker holds (y^{k-1}, g^{k-1}), y^k = W y^{k-1} + g^k - g^{k-1} in
    the parameters' dtype (y^{-1} = g^{-1} = 0, so the first tracker is
    g^0), x^{k+1} = W x^k - lam y^k with the FRESH y^k; then the tracker
    becomes (y^k, g^k).  Phase-shifted against `dsgt_update`: do not swap
    one for the other without re-deriving the phase."""
    for s, e in _pieces(X.shape[1], chunk):
        y = gossip_mix(W, Y[:, s:e]) + G[:, s:e] - G_prev[:, s:e]
        X[:, s:e] = _descend(gossip_mix(W, X[:, s:e]), y, lam)
        Y[:, s:e] = y
        G_prev[:, s:e] = G[:, s:e]


@torch.no_grad()
def dp_noise_(G: torch.Tensor, layout: FlatLayout, key: torch.Tensor,
              sigma_dp: float, chunk: int = 1 << 22,
              partitionable: bool = True) -> torch.Tensor:
    """G += sigma_dp N(0, 1), in place, in G's dtype: leaf l's noise is
    ``normal(split(key, n_leaves)[l], (m, *shape_l))`` laid over its (m,
    n_l) columns (counter a n_l + c at row a, column c), drawn ``chunk``
    columns at a time with int64 threefry on G's device."""
    m = G.shape[0]
    keys = prng.split(to_device(key, G.device), layout.n_leaves,
                      partitionable)
    rows = torch.arange(m, dtype=torch.int64, device=G.device)[:, None]
    for l, (o, o1) in enumerate(zip(layout.offsets[:-1],
                                    layout.offsets[1:])):
        n = o1 - o
        for c in range(0, n, chunk):
            c1 = min(n, c + chunk)
            idx = rows * n + torch.arange(c, c1, dtype=torch.int64,
                                          device=G.device)[None, :]
            z = prng.normal_from_bits(
                prng.bits_at(keys[l], idx, m * n, G.dtype == torch.bfloat16,
                             partitionable), G.dtype)
            G[:, o + c:o + c1] += z * sigma_dp
    return G


@torch.no_grad()
def dp_dsgd_update(X: torch.Tensor, G: torch.Tensor, layout: FlatLayout, *,
                   key: torch.Tensor, W: torch.Tensor, lam,
                   sigma_dp: float, out: torch.Tensor | None = None,
                   partitionable: bool = True) -> torch.Tensor:
    """Differential-privacy baseline: Gaussian noise added to the gradient
    (`dp_noise_`, written over G) before the conventional update."""
    dp_noise_(G, layout, key, sigma_dp, partitionable=partitionable)
    return dsgd_update(X, G, W=W, lam=lam, out=out)


def _obfuscated_rows(G: torch.Tensor, layout: FlatLayout,
                     key: torch.Tensor, step: int, lam_bar,
                     partitionable: bool = True) -> torch.Tensor:
    """u = Lambda^k ∘ g per agent by the reference's unfused formula
    (`privacy.obfuscated_gradient` over each agent's leaves), as a new
    flat buffer."""
    lam_key = prng.fold_in(key, 1)
    u_rows = torch.zeros_like(G)
    for a in range(G.shape[0]):
        u = obfuscated_gradient(agent_key(lam_key, step, a),
                                layout.tree(G[a]), lam_bar, partitionable)
        for view, leaf in zip(layout.leaf_views(u_rows[a]), tree_leaves(u)):
            view.copy_(leaf)
    return u_rows


def _lambda_source(key: torch.Tensor, step, layout: FlatLayout,
                   X: torch.Tensor, kernel_rng: bool,
                   partitionable: bool = True, agents=None) -> dict:
    """What the obfuscate kernel draws Lambda^k from: the key table and the
    leaf offsets (``kernel_rng``), or the `per_agent_bits` buffer.  Derived
    where the key lies: a host key (the eager loop) on the host, a device
    key (the graph) on the card, as uint32 with device offsets.
    ``agents``: the rows' global agent ids (`lambda_key_table`; the key
    table only)."""
    m = X.shape[0]
    if kernel_rng:
        keys = lambda_key_table(key, step, m, layout.n_leaves, partitionable,
                                agents=agents)
        if keys.device.type == "cuda":
            return {"keys": keys.to(torch.uint32),
                    "offsets": _offsets(layout, keys.device)}
        return {"keys": keys,
                "offsets": torch.tensor(layout.offsets, dtype=torch.int64)}
    if agents is not None:
        raise ValueError("agents= keys the in-kernel draw only "
                         "(kernel_rng=True)")
    return {"bits": per_agent_bits(key, step, layout, m, device=X.device,
                                   partitionable=partitionable)}


@torch.no_grad()
def pdsgd_update(X: torch.Tensor, G: torch.Tensor, layout: FlatLayout, *,
                 key: torch.Tensor, step, W: torch.Tensor,
                 support: torch.Tensor, lam_bar, kernel_rng: bool = True,
                 in_place: bool = False, eager: bool = False,
                 mask: torch.Tensor | None = None,
                 corrupt: torch.Tensor | None = None,
                 corrupt_mode: str = "nan", corrupt_scale: float = 1e4,
                 guard_clip: float | None = 1e3,
                 kernel_layout: str = "concat",
                 torus_shape: tuple[int, int] | None = None,
                 partitionable: bool = True, observe: bool = False,
                 fields: tuple[str, ...] = O.RECORD_FIELDS,
                 mesh=None, leaf_specs=None):
    """One iteration of Eq. (4) on flat (m, width) buffers; returns x'.

    ``W``/``support`` are this step's realized coupling and its support
    (B^k is drawn on the support); ``mask`` is the realized edge mask of a
    time-varying or faulty coupling (None for a static one).  ``corrupt``
    (an (m,) 0/1 vector of corrupt senders) selects the fault-tolerant
    gossip: the corrupt agents' transmits are poisoned per
    ``corrupt_mode``/``corrupt_scale`` and every link is finite-guarded at
    ``guard_clip`` (None: no guard) at the receiver.  ``step`` is the
    absolute step, an int or a device counter.

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

    ``kernel_layout="leafwise"`` runs the two kernels once per leaf, on
    the leaf's own columns of the flat buffers (`kernels.ops.
    leafwise_pdsgd_flat`: B1 reading the `per_agent_bits` buffer, then
    B2, B4 with ``mask`` or B6 with ``corrupt``), every column the concat
    bits path's bit for bit.  With ``mesh`` (a `DeviceMesh`) and
    ``leaf_specs`` (a partition spec per leaf, agent axis included,
    `dist.sharding`) each leaf is a DTensor on the mesh
    (`dist.sharding.mesh_pdsgd_tree`): B1 on its local shard, then B2
    or B4 over the agents' shards gathered on the agent axes, bit for bit
    the ``mesh=None`` layout; ``corrupt`` is refused there.  ``observe`` is refused (capture is defined on the
    concatenated wire buffer).

    ``eager=True`` is the reference's unfused formula (its
    ``use_pallas=False`` branch, whatever the layout): per agent
    `privacy.obfuscated_gradient` over the leaves, then per leaf
    `oracle_mix`, or `faults.inject.guarded_gossip_mix` when ``corrupt``
    is given.  It realizes the same Lambda^k and B^k; it is the
    port-internal oracle the tests hold the fused branch against, and
    writes a new buffer.

    ``partitionable=False`` draws Lambda^k and B^k from jax's earlier
    threefry stream (`prng`; the concat layout only).

    ``observe=True`` also returns the wire-tap record of
    `privacy.observe.full_record`, ``(x', record)``, with the ``fields``
    among the reference's (an adversary's view reads only its own: the
    external eavesdropper's V and support need no x, u or g).  Each
    route records what it realized: the fused route forms V between its
    two kernels from x^k and the obfuscate kernel's own u; the ring route
    scatters the kernel's own per-direction messages to the dense V; the
    oracle forms V from its u.  x and g are copied before the in-place
    writes.  Capture only reads the update's buffers, so x' is the same
    bits as without it.  ``corrupt`` is refused with it (a poisoned wire
    is not an audited scenario).
    """
    _check_layout(kernel_layout, mesh)
    if observe and corrupt is not None:
        raise ValueError("observation capture with corrupt links is not "
                         "an audited scenario")
    if observe and kernel_layout == "leafwise" and not eager:
        raise ValueError(_LEAFWISE_OBSERVE)
    B = sample_B(agent_key(prng.fold_in(key, 2), step, 0), support,
                 partitionable)
    D = layout.size
    rec = {}
    if observe:
        rec = {"support": support, "W": W if "W" in fields else None,
               "B": B if "B" in fields else None}
        if "g" in fields:
            rec["g_flat"] = G[:, :D].to(torch.float32, copy=True)
        if "x" in fields and (kernel_layout != "ring" or eager):
            rec["x_flat"] = X[:, :D].to(torch.float32, copy=True)
    if kernel_layout == "ring" and not eager:
        if corrupt is not None:
            raise ValueError(_RING_CORRUPT)
        if not partitionable:
            raise ValueError(_RING_STREAM)
        m = X.shape[0]
        n_data, n_pod = torus_shape if torus_shape is not None else (m, 1)
        if n_data * n_pod != m:
            raise ValueError(
                f"torus_shape {n_pod}x{n_data} does not hold m={m} agents")
        tabs = C.directional_weights(W, n_data, n_pod)
        w_tab = torch.cat([tabs["w_self"][:, None], tabs["w_dir"]], dim=1)
        b_rows = C.rows_from_dense(B, n_data, n_pod)
        out = ring_pdsgd_flat(
            w_tab, b_rows, C.source_table(n_data, n_pod), X, G, lam_bar,
            **_lambda_source(key, step, layout, X, kernel_rng),
            in_place=in_place, observe=observe, observe_fields=fields)
        if not observe:
            return out
        out, flats = out
        rec["v"] = O.scatter_directions(flats["v"],
                                        C.perm_stack(n_data, n_pod), D)
        if "x" in fields:
            rec["x_flat"] = flats["x"][:, :D]
        if "u" in fields:
            rec["u_flat"] = flats["u"][:, :D]
        return out, O.full_record(v=rec.pop("v"), **rec)
    if kernel_layout == "leafwise" and not eager:
        return _leafwise_update(X, G, layout, W, B, lam_bar, key, step,
                                in_place, mask, corrupt, corrupt_mode,
                                corrupt_scale, guard_clip, partitionable,
                                mesh, leaf_specs)
    if eager:
        u_rows = _obfuscated_rows(G, layout, key, step, lam_bar,
                                  partitionable)
        out = torch.zeros_like(X)
        for o, x, u in zip(layout.leaf_views(out), layout.leaf_views(X),
                           layout.leaf_views(u_rows)):
            if corrupt is not None:
                o.copy_(guarded_gossip_mix(W, B, x, u, corrupt,
                                           mode=corrupt_mode,
                                           scale=corrupt_scale,
                                           clip=guard_clip))
            else:
                o.copy_(oracle_mix(W, x) - oracle_mix(B, u))
        if not observe:
            return out
        _tap_record(rec, fields, W, B, X, u_rows, D)
        return out, O.full_record(v=rec.pop("v"), **rec)
    out, _ = fused_pdsgd_flat(
        W, B, X, G, lam_bar, **_lambda_source(key, step, layout, X,
                                              kernel_rng, partitionable),
        mask=mask, corrupt=corrupt, corrupt_mode=corrupt_mode,
        corrupt_scale=corrupt_scale, guard_clip=guard_clip,
        in_place=in_place, partitionable=partitionable,
        tap=((lambda U: _tap_record(rec, fields, W, B, X, U, D))
             if observe else None))
    if corrupt is not None:
        # a poisoned transmit covers the row's padding too; the padding
        # stays zero (a checkpoint does not hold it: the reference has none)
        out[:, layout.size:].zero_()
    if not observe:
        return out
    return out, O.full_record(v=rec.pop("v"), **rec)


def _leafwise_update(X, G, layout: FlatLayout, W, B, lam_bar, key, step,
                     in_place: bool, mask, corrupt, corrupt_mode,
                     corrupt_scale, guard_clip, partitionable: bool, mesh,
                     leaf_specs) -> torch.Tensor:
    """`pdsgd_update`'s leafwise layout (x' written over X with
    ``in_place``, else into a new buffer)."""
    m = X.shape[0]
    bits = per_agent_bits(key, step, layout, m, device=X.device,
                          partitionable=partitionable)
    if not in_place:
        X, G = X.clone(), G.clone()
    if mesh is None:
        return leafwise_pdsgd_flat(
            W, B, X, G, bits, layout, lam_bar, mask=mask, corrupt=corrupt,
            corrupt_mode=corrupt_mode, corrupt_scale=corrupt_scale,
            guard_clip=guard_clip)
    out = mesh_pdsgd_tree(W, B, layout.tree(X), layout.tree(G),
                          layout.tree(bits), lam_bar, mesh=mesh,
                          leaf_specs=leaf_specs, mask=mask, corrupt=corrupt)
    for view, leaf in zip(layout.leaf_views(X), tree_leaves(out)):
        view.copy_(leaf.full_tensor())
    return X


def _tap_record(rec: dict, fields, W, B, X: torch.Tensor, U: torch.Tensor,
                D: int) -> None:
    """The wire and u of a concat-layout update into ``rec``: V from x^k
    (X before the update writes it) and the update's own u."""
    rec["v"] = O.wire_messages(W, B, X[:, :D], U[:, :D])
    if "u" in fields:
        rec["u_flat"] = U[:, :D].to(torch.float32, copy=True)


@torch.no_grad()
def obfuscate_flat(X: torch.Tensor, G: torch.Tensor, layout: FlatLayout, *,
                   key: torch.Tensor, step: int, lam_bar,
                   kernel_rng: bool = True, eager: bool = False,
                   partitionable: bool = True,
                   agents=None) -> torch.Tensor:
    """u = Lambda^k ∘ g alone (the descent of trimmed-mean aggregation, and
    a multi-controller rank's local update): through the obfuscate kernel,
    written over G, or by the unfused formula (``eager``) into a new
    buffer.  The same Lambda^k as `pdsgd_update`; ``agents`` gives the
    rows' global agent ids when X holds a block of the agents
    (`lambda_key_table`)."""
    if eager:
        if agents is not None:
            raise ValueError("agents= keys the kernel's draw only")
        return _obfuscated_rows(G, layout, key, step, lam_bar, partitionable)
    src = _lambda_source(key, step, layout, X, kernel_rng, partitionable,
                         agents=agents)
    if kernel_rng:
        return obfuscate_update_krng(X, G, src["keys"], src["offsets"],
                                     lam_bar, 0.0, -1.0, out=G,
                                     partitionable=partitionable)
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


def _finite(flat: torch.Tensor, chunk: int = _CHUNK) -> torch.Tensor:
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
def _keep_where(flat: torch.Tensor, keep: torch.Tensor,
                held: torch.Tensor) -> None:
    """``flat = where(keep, flat, held)`` in place (no temporary): ``keep``
    a device bool, () for the whole buffer or (m, 1) by rows.  The
    selection moves bits, so it runs on both contiguous buffers viewed as
    8-byte words where their rows allow it (a quarter of a bf16 buffer's
    elements); where ``keep`` holds, the entry is ``flat``'s own, bit for
    bit."""
    if (flat.shape[-1] * flat.element_size()) % 8 == 0:
        flat, held = flat.view(torch.int64), held.view(torch.int64)
    torch.where(keep, flat, held, out=flat)


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


def _graph_refusal(eager: bool, mesh=None) -> str | None:
    """What keeps a step out of the CUDA graph of `make_scanned_steps`, or
    None: the port's unfused oracle (``eager=True``), which is the tests'
    reference for the kernels' route, not a route to train by, and the
    leafwise layout over a mesh (DTensor's dispatch runs on the host at
    every call)."""
    if eager:
        return "the unfused oracle (eager=True)"
    return "the leafwise layout over a mesh" if mesh is not None else None


def make_decentralized_step(loss_fn: Callable[[Any, Any], torch.Tensor],
                            topology: Topology | MixingProcess,
                            schedule: Schedule, kernel_rng: bool = True, *,
                            algorithm: str = "pdsgd", sigma_dp: float = 0.0,
                            grad_clip: float | None = None,
                            track_mean: bool = False,
                            faults: FaultProcess | None = None,
                            nan_policy: str = "off",
                            aggregation: str = "gossip", trim: int = 1,
                            eager: bool = False,
                            kernel_layout: str = "concat",
                            torus_shape: tuple[int, int] | None = None,
                            partitionable: bool = True,
                            observer: O.Adversary | None = None,
                            mesh=None, leaf_specs=None):
    """``step(state, batch, key) -> (state, aux)`` for one of `ALGORITHMS`.

    ``loss_fn(params_i, batch_i)`` is ONE agent's scalar loss; batch leaves
    carry a leading (m, ...) agent axis.  ``key`` is the step's key (the
    reference's ``fold_in(run_key, k)``).  lam_bar is evaluated on the
    buffer's device from the step counter (agent 0, as the reference).
    The returned state shares the input state's buffers, which the step
    has updated in place.  ``kernel_rng`` picks how the obfuscate kernel
    gets Lambda's bits (see `pdsgd_update`); ``eager=True`` runs the
    unfused formula instead of the kernels (the tests' oracle).
    ``kernel_layout``/``torus_shape`` pick the update's layout
    (`pdsgd_update`): ``"ring"`` runs it as one ring kernel per step,
    ``"leafwise"`` as the two kernels once per leaf (with ``mesh`` and
    ``leaf_specs``: on a device mesh, the leaves DTensors).

    ``algorithm``: ``pdsgd`` (Eq. 4, the kernels), or a baseline — ``dsgd``
    (`dsgd_update`), ``dsgt`` (in place on ``state.tracker``, the
    reference's phase-shifted convention, `_dsgt_step_`) or ``dp_dsgd``
    (`dp_dsgd_update` with ``sigma_dp``, its noise from ``fold_in(key,
    3)``).  The baselines' W x and W y are plain torch products, as the
    reference computes them outside any Pallas kernel.  ``grad_clip``
    (kappa > 0) clips every gradient element to [-kappa, kappa] in place
    before the update (`privacy.clip_gradients`).  ``track_mean`` adds
    the agent-mean parameters to aux (``params_mean``, a tree).

    ``topology`` may be a `MixingProcess`: the step realizes W_k from the
    absolute step each iteration (on the card from the device counter
    under the CUDA graph, `MixingProcess.realize`), and a time-varying one
    routes the gossip through the masked kernel.

    ``observer`` (a `privacy.observe.Adversary`) turns on the wire-tap:
    ``aux["observation"]`` is that adversary's view of this step's
    messages (pdsgd: the v_ij tensor of `pdsgd_update(observe=True)`,
    built with only the fields the view reads; dsgd and dp_dsgd:
    `privacy.observe.state_record`, the states broadcast in the clear and
    the clean gradients, copied before the update).  Under
    `make_scanned_steps` the views stack into (unroll_k, ...) aux.
    Capture leaves the trajectory bit for bit as without it.  Refused for
    dsgt (its two-variable exchange is not audited), corrupt-link faults
    and trimmed-mean aggregation (a poisoned wire, a raw-state
    broadcast); crash/restart faults compose with it.

    ``faults`` (a `faults.FaultProcess`, pdsgd only) composes the coupling
    per step through `faults.realize_coupling`; down agents keep their
    held rows; rejoining agents warm start from their stable neighbours
    first with ``rejoin='neighbor-avg'``; corrupt transmits go through the
    guarded kernel.  An inert process is no process, so the rate-0 step is
    the fault-free step.  ``nan_policy`` adds isfinite sentinels on the
    loss, the updated parameters and the tracker: ``"warn"`` counts
    (``aux["fault_nonfinite"]``), ``"skip"`` also restores the held
    buffers on a non-finite step.  ``aggregation="trimmed_mean"`` (pdsgd
    only) replaces the gossip by coordinate-wise trimmed-mean aggregation
    of the neighbours' states (`faults.inject.trimmed_mean_mix`) with each
    agent's own obfuscated descent.

    Held state and the in-place update.  The step follows the reference's
    structure with no host sync on any branch.  The held anchor (the
    reference's ``held``) is one clone of the buffer, taken after the
    neighbour-average warm start (which changes the rejoining rows before
    the gradients and writes the others back unchanged) when faults have
    crashes or ``nan_policy="skip"`` (one more (m, width) buffer for the
    step; with a tracker under "skip", two more).  The gossip writes x'
    over the buffer; then the down agents' rows are restored from the
    anchor by a ``where`` on the agent rows, the sentinel flag is formed
    on the device, and "skip" restores the whole buffer (and the tracker)
    by a ``where`` on it.  The fault counters and ``fault_nonfinite`` are
    0-d int32 tensors on the buffer's device.

    ``step.inner(state, batch, key, k)`` is the same step at absolute step
    ``k``, an int or a 0-d int64 counter tensor (the draws of the
    coupling, the faults, B^k and Lambda^k then run on its device): what
    `make_scanned_steps` runs and captures.  ``step.graph_refusal`` names
    what keeps this step out of a CUDA graph (the unfused oracle only;
    None when the graph holds it).

    ``partitionable=False`` draws every random number of the step
    (Lambda^k, B^k, DP-DSGD's noise) from jax's earlier threefry stream
    (`prng`), the one the recorded Fig. 2 target was drawn from.  The
    draws that follow jax's partitionable stream only (a time-varying
    mixing process's masks, faults, the ring layout's kernels) are
    refused with it.
    """
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if observer is not None and algorithm == "dsgt":
        raise ValueError("observation capture supports pdsgd/dsgd/dp_dsgd; "
                         "dsgt's two-variable exchange is not audited")
    if grad_clip is not None and not grad_clip > 0.0:
        raise ValueError(f"grad_clip must be > 0, got {grad_clip}")
    if nan_policy not in ("off", "warn", "skip"):
        raise ValueError(f"unknown nan_policy {nan_policy!r}; "
                         f"have ('off', 'warn', 'skip')")
    if aggregation not in ("gossip", "trimmed_mean"):
        raise ValueError(f"unknown aggregation {aggregation!r}; "
                         f"have ('gossip', 'trimmed_mean')")
    _check_layout(kernel_layout, mesh)
    if kernel_layout == "leafwise" and observer is not None:
        raise ValueError(_LEAFWISE_OBSERVE)
    process = as_process(topology)
    if faults is not None and faults.is_inert:
        faults = None  # the rate-0 path IS the fault-free path
    if not partitionable:
        if not process.is_static or faults is not None:
            raise ValueError(
                "partitionable=False (jax's earlier threefry stream) takes "
                "a static topology without faults: mixing masks and fault "
                "realizations draw the partitionable stream only")
        if kernel_layout == "ring" and not eager:
            raise ValueError(_RING_STREAM)
    if faults is not None:
        if algorithm != "pdsgd":
            raise ValueError(
                "fault injection composes with the paper's pdsgd update; "
                f"algorithm={algorithm!r} is not a fault scenario")
        if faults.num_agents != process.num_agents:
            raise ValueError(
                f"faults built for {faults.num_agents} agents but the "
                f"topology has {process.num_agents}")
        if observer is not None and faults.has_corruption:
            raise ValueError("observation capture with corrupt links is "
                             "not an audited scenario")
    if aggregation == "trimmed_mean" and observer is not None:
        raise ValueError(
            "trimmed-mean aggregation broadcasts raw neighbor states "
            "(conventional-DSGD wire); capture of it is not an audited "
            "scenario")
    m = process.num_agents
    if aggregation == "trimmed_mean":
        if algorithm != "pdsgd":
            raise ValueError("aggregation='trimmed_mean' is a pdsgd mode")
        if not (1 <= trim and m - 2 * trim >= 1):
            raise ValueError(
                f"trim must satisfy 1 <= trim and m - 2*trim >= 1; "
                f"got trim={trim}, m={m}")
    corrupting = faults is not None and faults.has_corruption
    if corrupting and kernel_layout == "ring" and not eager \
            and aggregation == "gossip":
        raise ValueError(_RING_CORRUPT)
    rejoining = (faults is not None and faults.has_crash
                 and not faults.is_failstop)
    holding = (faults is not None and faults.has_crash) \
        or nan_policy == "skip"

    def inner(state: DecentralizedState, batch, key: torch.Tensor, k):
        if state.num_agents != m:
            raise ValueError(f"state has {state.num_agents} agents, the "
                             f"topology {m}")
        if algorithm == "dsgt" and state.tracker is None:
            raise ValueError(
                "algorithm='dsgt' carries (y, prev_grads) in "
                "state.tracker; build the state with "
                "init_state(params, m, algorithm='dsgt')")
        X = state.flat
        dev = X.device
        layout = state.layout
        alive = corrupt = rejoin = None
        # named ranges: the host time of each part in a torch.profiler trace
        with torch.profiler.record_function("coupling"):
            if faults is None:
                W, support, mask = process.realize(k, dev)
            else:
                W, support, mask, alive, corrupt = realize_coupling(
                    process, faults, k, dev)
                alive, corrupt = to_device(alive, dev), to_device(corrupt,
                                                                  dev)
            k_f32 = (k.to(torch.float32) if isinstance(k, torch.Tensor)
                     else torch.full((), float(k), dtype=torch.float32,
                                     device=dev))
            lam_bar = schedule(k_f32)
        with torch.profiler.record_function("held_state"):
            if rejoining:
                prev = to_device(faults.alive_before(k), dev)
                rejoin = alive * (1.0 - prev)
                if faults.rejoin == "neighbor-avg":
                    _warm_start(X, mask, alive, prev)
            # the held anchor: the buffer with rejoiners warm started
            held = X.clone() if holding else None
            held_tracker = (tuple(t.clone() for t in state.tracker)
                            if nan_policy == "skip"
                            and state.tracker is not None else None)
        G = torch.empty_like(X)
        with torch.profiler.record_function("agent_grads"):
            losses = _agent_grads(loss_fn, state, batch, G)
            if grad_clip is not None:
                clip_gradients(G[:, :layout.size], grad_clip)
        observation = None
        if observer is not None and algorithm != "pdsgd":
            # the state-sharing baselines' wire carries x_j in the clear
            # (dp_dsgd noises the gradient, not the state)
            D = layout.size
            observation = O.adversary_view(observer, O.state_record(
                support=support, x_flat=X[:, :D].to(torch.float32,
                                                    copy=True),
                g_flat=G[:, :D].to(torch.float32, copy=True), W=W,
                lam=lam_bar))
        with torch.profiler.record_function(f"{algorithm}_update"):
            if algorithm == "dsgd":
                dsgd_update(X, G, W=W, lam=lam_bar, out=X)
            elif algorithm == "dp_dsgd":
                dp_dsgd_update(X, G, layout, key=prng.fold_in(key, 3), W=W,
                               lam=lam_bar, sigma_dp=sigma_dp, out=X,
                               partitionable=partitionable)
            elif algorithm == "dsgt":
                _dsgt_step_(X, *state.tracker, G, W=W, lam=lam_bar)
            elif aggregation == "trimmed_mean":
                U = obfuscate_flat(X, G, layout, key=key, step=k,
                                   lam_bar=lam_bar, kernel_rng=kernel_rng,
                                   eager=eager, partitionable=partitionable)
                _trimmed_mean(
                    X, U, support,
                    corrupt if corrupt is not None
                    else torch.zeros(m, device=dev),
                    trim=trim,
                    mode=faults.corrupt_mode if faults else "nan",
                    scale=faults.corrupt_scale if faults else 1e4)
                del U
            else:
                out = pdsgd_update(
                    X, G, layout, key=key, step=k, W=W,
                    support=support, lam_bar=lam_bar, kernel_rng=kernel_rng,
                    in_place=True, eager=eager, mask=mask,
                    corrupt=corrupt if corrupting else None,
                    corrupt_mode=faults.corrupt_mode if corrupting
                    else "nan",
                    corrupt_scale=faults.corrupt_scale if corrupting
                    else 1e4,
                    guard_clip=faults.guard_clip if corrupting else 1e3,
                    kernel_layout=kernel_layout, torus_shape=torus_shape,
                    partitionable=partitionable, mesh=mesh,
                    leaf_specs=leaf_specs,
                    observe=observer is not None,
                    fields=(observer.fields if observer is not None
                            else O.RECORD_FIELDS))
                if observer is not None:
                    out, record = out
                    observation = O.adversary_view(observer, record)
                    del record
                if out is not X:
                    X.copy_(out)
                del out
        del G
        aux = {"loss": losses.mean()}
        with torch.profiler.record_function("held_state"):
            # down agents neither transmit (the coupling saw to that) nor
            # update; restored before the sentinels, as in the reference
            if faults is not None and faults.has_crash:
                _keep_where(X, (alive > 0)[:, None], held)
            if nan_policy != "off":
                finite = (torch.isfinite(losses).all()
                          & _finite(X[:, :layout.size]))
                for t in state.tracker or ():
                    finite &= _finite(t[:, :layout.size])
                aux["fault_nonfinite"] = (~finite).to(torch.int32)
                if nan_policy == "skip":
                    # where(True, new, held) is new bit for bit
                    _keep_where(X, finite, held)
                    for t, h in zip(state.tracker or (), held_tracker or ()):
                        _keep_where(t, finite, h)
            del held, held_tracker
        new = DecentralizedState(flat=X, layout=layout, step=state.step + 1,
                                 tracker=state.tracker)
        with torch.profiler.record_function("consensus_error"):
            aux["consensus_error"] = consensus_error(X[:, :layout.size])
        if track_mean:
            aux["params_mean"] = layout.tree(X.mean(dim=0))
        if observation is not None:
            aux["observation"] = observation
        if alive is not None:
            aux["fault_down"] = (m - alive.sum()).to(torch.int32)
            aux["fault_corrupt"] = corrupt.sum().to(torch.int32)
            aux["fault_rejoin"] = (
                rejoin.sum().to(torch.int32) if rejoin is not None
                else torch.zeros((), dtype=torch.int32, device=dev))
        return new, aux

    def step(state: DecentralizedState, batch, key: torch.Tensor):
        return inner(state, batch, key, state.step)

    step.inner = inner
    step.graph_refusal = _graph_refusal(eager, mesh)
    return step


def _tree_pairs(dst, src):
    """Leaf pairs of two trees of one structure."""
    if isinstance(dst, dict):
        return [p for k in dst for p in _tree_pairs(dst[k], src[k])]
    if isinstance(dst, (tuple, list)):
        return [p for d, s in zip(dst, src) for p in _tree_pairs(d, s)]
    return [] if dst is None else [(dst, src)]


def _stack_aux(auxes: list):
    """Per-step aux dicts -> one dict of (k, ...) stacks."""
    first = auxes[0]
    if isinstance(first, dict):
        return {k: _stack_aux([a[k] for a in auxes]) for k in first}
    if isinstance(first, torch.Tensor):
        return torch.stack(auxes)
    return torch.tensor(auxes)


def _copy_in(dst: torch.Tensor, src) -> None:
    """Copy a chunk's input into a graph's static buffer without waiting
    for the card: a host tensor goes through pinned memory."""
    src = torch.as_tensor(src)
    if src.device.type == "cpu":
        src = src.pin_memory()
    dst.copy_(src, non_blocking=True)


_WARMUP_STREAMS: dict = {}


def _warmup_stream(device) -> "torch.cuda.Stream":
    """One side stream per device for every graph's warm-up chunk: cuBLAS
    keeps a workspace per (handle, stream) for the process's life, so a
    new stream per graph would leave one behind for each."""
    device = torch.device(device)
    if device not in _WARMUP_STREAMS:
        _WARMUP_STREAMS[device] = torch.cuda.Stream(device)
    return _WARMUP_STREAMS[device]


def _capture_nodes(stream) -> int | None:
    """The nodes of the graph ``stream`` is capturing, from libcuda
    (``cuStreamGetCaptureInfo``, ``cuGraphGetNodes``), or None where
    libcuda does not answer.  A query only: no sync, no launch."""
    P = ctypes.POINTER
    vp, sz = ctypes.c_void_p, ctypes.c_size_t
    try:
        cuda = ctypes.CDLL("libcuda.so.1")
        v3 = hasattr(cuda, "cuStreamGetCaptureInfo_v3")  # CUDA >= 12.3
        info = (cuda.cuStreamGetCaptureInfo_v3 if v3
                else cuda.cuStreamGetCaptureInfo_v2)
        get_nodes = cuda.cuGraphGetNodes
    except (OSError, AttributeError):
        return None
    # (stream, status, id, graph, dependencies[, edge data], count)
    info.argtypes = [vp, P(ctypes.c_int), P(ctypes.c_uint64), P(vp), P(vp),
                     *([P(vp)] if v3 else []), P(sz)]
    info.restype = ctypes.c_int
    get_nodes.argtypes = [vp, vp, P(sz)]
    get_nodes.restype = ctypes.c_int
    status, cid = ctypes.c_int(), ctypes.c_uint64()
    graph, deps, edges = vp(), vp(), vp()
    ndeps, nodes = sz(), sz()
    rc = info(stream.cuda_stream, ctypes.byref(status), ctypes.byref(cid),
              ctypes.byref(graph), ctypes.byref(deps),
              *([ctypes.byref(edges)] if v3 else []), ctypes.byref(ndeps))
    if rc != 0 or not graph.value or get_nodes(
            graph, None, ctypes.byref(nodes)) != 0:
        return None
    return int(nodes.value)


class _StepGraph:
    """k steps of ``inner`` captured in one CUDA graph over one state's
    buffers: static inputs are a (k, m, ...) batch buffer, a (k, 2) key
    buffer and a device step counter that the graph increments after each
    step; the outputs are the stacked aux tensors.  The first chunk runs
    the same k steps eagerly on a side stream (PyTorch's warm-up before
    capture; they are real steps); capturing then launches nothing, and
    every later chunk replays.  The wrappers count a launch where they
    launch a kernel, and a replay goes through no wrapper: what they count
    during capture (no kernel runs) is taken back and kept as
    ``launches``, what one replay launches, beside ``replays``.
    ``warmup_s`` and ``capture_s`` are the host seconds of the warm-up
    chunk and of the capture with its instantiation; ``nodes`` the nodes
    the captured graph holds (None where libcuda does not say)."""

    def __init__(self, inner, k: int, state: DecentralizedState, batches,
                 keys):
        dev = state.flat.device
        self.inner, self.k = inner, k
        self.batches = tree_map(
            lambda t: torch.empty(tuple(t.shape), dtype=t.dtype,
                                  device=dev), batches)
        self.keys = torch.empty((k, 2), dtype=torch.int64, device=dev)
        self.counter = torch.zeros((), dtype=torch.int64, device=dev)
        self.graph = None
        self.aux = None
        self.launches: dict[str, int] = {}
        self.replays = 0
        self.warmup_s = self.capture_s = None
        self.nodes = None

    def _load(self, state, batches, keys) -> None:
        for d, s in _tree_pairs(self.batches, batches):
            _copy_in(d, s)
        _copy_in(self.keys, torch.as_tensor(keys, dtype=torch.int64))
        self.counter.fill_(state.step)

    def _steps(self, state):
        auxes = []
        for i in range(self.k):
            batch = tree_map(lambda t: t[i], self.batches)
            state, aux = self.inner(state, batch, self.keys[i],
                                    self.counter)
            self.counter += 1
            auxes.append(aux)
        return _stack_aux(auxes)

    def __call__(self, state, batches, keys):
        self._load(state, batches, keys)
        if self.graph is None:
            t0 = time.perf_counter()
            side = _warmup_stream(state.flat.device)
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                aux = self._steps(state)
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            before = dict(launch_counts)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.aux = self._steps(state)
                self.nodes = _capture_nodes(torch.cuda.current_stream())
            self.warmup_s, self.capture_s = t1 - t0, time.perf_counter() - t1
            self.launches = {n: c - before.get(n, 0)
                             for n, c in launch_counts.items()
                             if c != before.get(n, 0)}
            for n, c in self.launches.items():
                launch_counts[n] -= c
        else:
            self.graph.replay()
            self.replays += 1
            aux = tree_map(torch.clone, self.aux)
        return aux


def make_scanned_steps(step_fn, unroll_k: int):
    """``scanned(state, batches, keys) -> (state, aux_stacked)``: ``unroll_k``
    steps of a `make_decentralized_step` step per call, the counterpart
    of the reference's ``lax.scan``.  Every ``batches`` leaf has a
    leading (unroll_k, m, ...) axis; ``keys`` is (unroll_k, 2) (e.g.
    `launch.steps.per_step_keys`); each aux value comes out stacked
    (unroll_k, ...).

    On the CPU it is a loop over ``step.inner`` at a 0-d int64 counter
    tensor, the form the graph captures (the draws of the coupling, the
    faults, B^k and Lambda^k from the counter), bitwise the eager loop's
    int form.  On the card it is one CUDA graph of ``unroll_k`` steps
    (`_StepGraph`), captured once per state's buffers and batch shapes
    and replayed per chunk; the keys, the schedule, B^k, Lambda^k and
    DP-DSGD's noise are derived inside it from the device step counter,
    bitwise the eager steps' values.  The state's buffers are updated in
    place; the aux stacks are copies, so they outlive the next replay.
    ``scanned.replayed_launches()`` gives the kernel launches the replays
    ran, each graph's captured launches times its replays (the wrappers'
    `launch_counts` hold the eager warm-up chunks' only);
    ``scanned.graph_stats()`` each graph's warm-up and capture seconds and
    node count (`_StepGraph`).

    The graph holds every step configuration the reference's ``lax.scan``
    holds: a time-varying mixing process (each W_k realized in the graph
    from the device counter, the masked gossip kernel there), agent
    faults (realized from the counter, down rows and the rejoin warm start
    as ``where``), the ``nan_policy`` sentinels (a device flag, "skip" as
    a ``where``; the counters come out stacked (unroll_k,), read once a
    chunk), trimmed-mean aggregation, the ring layout and any model whose
    forward and backward launch no host sync.  A step's observation
    (``observer``) stacks like the other aux.  The one step it refuses,
    on every device and before any step runs, is the port's unfused
    oracle (``eager=True``); nothing falls back to the eager loop.
    """
    inner = getattr(step_fn, "inner", None)
    if inner is None:
        raise ValueError("make_scanned_steps needs a step from "
                         "make_decentralized_step")
    if unroll_k < 1:
        raise ValueError(f"unroll_k must be >= 1, got {unroll_k}")
    if step_fn.graph_refusal is not None:
        raise ValueError(
            f"the scanned step (unroll_k > 1, a CUDA graph on the card) "
            f"does not hold {step_fn.graph_refusal}: it is the tests' "
            f"oracle for the kernels' route; run it eagerly (--unroll-k 1)")
    graphs: dict = {}

    def scanned(state: DecentralizedState, batches, keys):
        if state.flat.device.type != "cuda":
            counter = torch.full((), state.step, dtype=torch.int64)
            auxes = []
            for i in range(unroll_k):
                state, aux = inner(state, tree_map(lambda t: t[i], batches),
                                   keys[i], counter)
                counter = counter + 1
                auxes.append(aux)
            return state, _stack_aux(auxes)
        ptrs = (state.flat.data_ptr(),) + tuple(
            t.data_ptr() for t in state.tracker or ())
        shapes = tuple((tuple(s.shape), s.dtype)
                       for _, s in _tree_pairs(batches, batches))
        graph = graphs.get((ptrs, shapes))
        if graph is None:
            graph = graphs[(ptrs, shapes)] = _StepGraph(
                inner, unroll_k, state, batches, keys)
        aux = graph(state, batches, keys)
        return DecentralizedState(flat=state.flat, layout=state.layout,
                                  step=state.step + unroll_k,
                                  tracker=state.tracker), aux

    def replayed_launches() -> dict[str, int]:
        out: dict[str, int] = {}
        for g in graphs.values():
            for n, c in g.launches.items():
                out[n] = out.get(n, 0) + c * g.replays
        return out

    def graph_stats() -> list[dict]:
        """Per captured graph: the warm-up chunk's and the capture's host
        seconds, the graph's nodes and its replays."""
        return [{"warmup_s": g.warmup_s, "capture_s": g.capture_s,
                 "nodes": g.nodes, "replays": g.replays}
                for g in graphs.values()]

    scanned.replayed_launches = replayed_launches
    scanned.graph_stats = graph_stats
    return scanned
