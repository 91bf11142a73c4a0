"""Time-varying coupling: the process that realizes W_k each step
(counterpart of ``repro.core.mixing``).

Three modes, as in the reference:

* ``static``   — W_k is the base Metropolis matrix every step (cast once
                 from float64 to float32, exactly as the reference does);
                 ``dropout`` with rate 0 is the same process.
* ``dropout``  — each undirected base edge fails independently per step
                 with probability ``rate``: a symmetric Bernoulli mask from
                 ``fold_in(key(seed), step)``, then Metropolis weights on
                 the surviving graph, so every W_k is doubly stochastic
                 with w_ii > 0 whatever the draw.
* ``resample`` — the graph is redrawn as an Erdős–Rényi G(m, p) every
                 ``resample_every`` steps, from ``fold_in(key(seed),
                 step // resample_every)``.

Keys fold in the absolute step, never a carried key, so any loop that
realizes step k gets the same W_k.  The draws go through `prng`, so the
masks are the reference's bit for bit, and `metropolis_from_mask` sums
each row in ascending order (`kernels.ref.metropolis_ref`), which is the
reference's rounding.

Where it runs.  A mask is m × m (m <= 32).  For an int step (the eager
loop) a time-varying process draws it on the host with `prng` and copies
the (mask, W, support) triple to the device through pinned memory, which
does not wait for the device.  For a 0-d int64 device counter (the CUDA
graph of `core.pdsgd.make_scanned_steps`) the key, the bits, the mask and
its Metropolis weights are all computed on the counter's device with
torch ops, no host copy and no sync: int64 threefry is exact, the
comparison and the one division per weight are correctly rounded, and
the row sum runs in ascending j, so both give the same bits.  The static
mode keeps its device constants cached per device, copied once.  The
gossip kernels take the mask and recompute the Metropolis weights on the
card (`kernels.gossip.masked_gossip_update`); `masked_gossip_update_krng`
draws the same mask inside the kernel.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from ..kernels.build import to_device
# the Metropolis weights of a mask, the masked gossip kernels' rounding
from ..kernels.ref import mask_from_bits
from ..kernels.ref import metropolis_ref as metropolis_from_mask
from . import prng
from .topology import Topology

__all__ = ["MixingProcess", "make_mixing", "as_process",
           "metropolis_from_mask", "symmetric_edge_mask",
           "is_connected_mask", "MODES"]

MODES = ("static", "dropout", "resample")


def is_connected_mask(support: torch.Tensor) -> bool:
    """Whether a 0/1 support matrix is connected: repeated squaring of
    (A + I), ceil(log2 m) products."""
    m = support.shape[0]
    a = ((support.float() + torch.eye(m, device=support.device)) > 0).float()
    for _ in range(max(1, int(np.ceil(np.log2(max(m, 2)))))):
        a = ((a @ a) > 0).float()
    return bool((a > 0).all())


def symmetric_edge_mask(key: torch.Tensor, m: int, keep_prob) -> torch.Tensor:
    """Symmetric off-diagonal Bernoulli(keep_prob) mask, float32 on the
    CPU: one uniform of ``prng.bits(key, (m, m))`` per undirected edge (the
    strict upper triangle, mirrored), so a link fails both ways at once;
    ``keep_prob`` is compared in float32, as the reference compares it.
    The draw of the in-kernel mask (`kernels.ref.mask_from_bits`)."""
    return mask_from_bits(prng.bits(key, (m, m)), keep_prob,
                          1.0 - torch.eye(m))


# eq=False: identity semantics, as the reference; compare configurations
# with fingerprint().
@dataclasses.dataclass(frozen=True, eq=False)
class MixingProcess:
    """``realize(step, device) -> (W, support, mask)``:

    * ``W``       — (m, m) float32 doubly-stochastic mixing matrix;
    * ``support`` — (m, m) float32 0/1, W's support with the diagonal
                    (what `privacy.sample_B` draws B^k on);
    * ``mask``    — (m, m) float32 0/1 symmetric off-diagonal edge mask,
                    or ``None`` when W is the static constant.
    """

    mode: str
    topology: Topology
    rate: float = 0.0
    resample_every: int = 0
    resample_p: float | None = None
    seed: int = 0

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown mixing mode {self.mode!r}; "
                             f"have {MODES}")
        if not 0.0 <= self.rate < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), "
                             f"got {self.rate}")
        if self.mode != "dropout" and self.rate != 0.0:
            raise ValueError(
                f"rate is a dropout-mode knob; mode={self.mode!r} ignores "
                f"rate={self.rate}")
        if self.mode != "resample" and (self.resample_every != 0
                                        or self.resample_p is not None):
            raise ValueError(
                f"resample_every/resample_p are resample-mode knobs; "
                f"mode={self.mode!r} ignores them")
        if self.mode == "resample":
            if self.resample_every < 1:
                raise ValueError("mode='resample' needs resample_every >= 1")
            p = self.edge_prob
            if not 0.0 < p <= 1.0:
                raise ValueError(f"resample_p must be in (0, 1], got {p}")
        adj_off = torch.as_tensor(self.topology.adjacency).float()
        adj_off.fill_diagonal_(0.0)
        object.__setattr__(self, "_adj_off", adj_off)
        object.__setattr__(self, "_key", prng.key(self.seed))
        # device -> static (W, support), copied once
        object.__setattr__(self, "_on_device", {})
        # device -> (key, mask_adj), for masks drawn on a device counter
        object.__setattr__(self, "_draw_consts", {})

    @property
    def num_agents(self) -> int:
        return self.topology.num_agents

    @property
    def is_static(self) -> bool:
        """True when every W_k is the same constant."""
        return self.mode == "static" or (self.mode == "dropout"
                                         and self.rate == 0.0)

    @property
    def base_mask(self) -> torch.Tensor:
        """The base graph's off-diagonal 0/1 adjacency (float32, CPU)."""
        return self._adj_off

    @property
    def keep_prob(self) -> float:
        """Per-edge keep probability of a draw: 1 - rate (dropout) or the
        ER edge probability (resample)."""
        return (self.edge_prob if self.mode == "resample"
                else 1.0 - self.rate)

    @property
    def edge_prob(self) -> float:
        """Resample-mode ER edge probability (default: the base graph's
        off-diagonal edge density)."""
        if self.resample_p is not None:
            return float(self.resample_p)
        m = self.num_agents
        off = self.topology.adjacency.sum() - m
        return float(off / max(m * (m - 1), 1))

    def fingerprint(self) -> dict:
        """JSON-stable identity of the configuration; inert knobs are
        normalized out (a static process reports mode "static" and a null
        seed), as the reference's."""
        adj = np.ascontiguousarray(self.topology.adjacency.astype(np.uint8))
        static = self.is_static
        return {
            "mode": "static" if static else self.mode,
            "num_agents": int(self.num_agents),
            "base_adjacency_sha256":
                hashlib.sha256(adj.tobytes()).hexdigest()[:16],
            "rate": 0.0 if static else float(self.rate),
            "resample_every": int(self.resample_every),
            "resample_p": (float(self.edge_prob)
                           if self.mode == "resample" else None),
            "seed": None if static else int(self.seed),
        }

    def mask_key(self, step) -> torch.Tensor:
        """The (2,) key step ``step``'s mask is drawn from: ``fold_in(
        key(seed), step)`` (dropout) or ``fold_in(key(seed), step //
        resample_every)`` (resample).  ``step`` an int (a host key) or a
        0-d int64 device counter (the key on its device)."""
        if self.is_static:
            raise ValueError("a static process draws no mask")
        if isinstance(step, torch.Tensor):
            idx = step.to(torch.int64)
            if self.mode == "resample":
                idx = torch.div(idx, self.resample_every,
                                rounding_mode="floor")
            return prng.fold_in(self._device_consts(idx.device)[0], idx)
        idx = int(step)
        if self.mode == "resample":
            idx //= self.resample_every
        return prng.fold_in(self._key, idx)

    def mask_adj(self) -> torch.Tensor:
        """The off-diagonal adjacency a draw is gated by: the base graph
        (dropout) or the complete graph (resample)."""
        if self.mode == "resample":
            m = self.num_agents
            return 1.0 - torch.eye(m)
        return self._adj_off

    def _device_consts(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(key, mask_adj) on ``device``, copied once: the eager chunk a
        CUDA graph runs before its capture makes them, so the capture
        copies nothing."""
        device = torch.device(device)
        if device not in self._draw_consts:
            self._draw_consts[device] = (to_device(self._key, device),
                                         to_device(self.mask_adj(), device))
        return self._draw_consts[device]

    def realize_mask(self, step) -> torch.Tensor:
        """Step ``step``'s (m, m) edge mask (time-varying modes):
        `symmetric_edge_mask` gated by `mask_adj`, what the in-kernel draw
        gives for the same key.  On the CPU for an int step, on the
        counter's device for a 0-d device counter."""
        m = self.num_agents
        key = self.mask_key(step)
        adj = (self._device_consts(key.device)[1]
               if isinstance(step, torch.Tensor) else self.mask_adj())
        return mask_from_bits(prng.bits(key, (m, m)), self.keep_prob, adj)

    def realize(self, step, device=None):
        """(W_k, support_k, mask_k) on ``device`` for the absolute ``step``:
        an int, or a 0-d int64 counter tensor, whose device the draw then
        runs on (``device`` defaults to it).  Static tensors are shared
        between calls: do not write to them."""
        if isinstance(step, torch.Tensor) and device is None:
            device = step.device
        device = torch.device(device or "cpu")
        if self.is_static:
            if device not in self._on_device:
                W = torch.as_tensor(self.topology.weights).to(torch.float32)
                support = torch.as_tensor(self.topology.adjacency).to(
                    torch.float32)
                self._on_device[device] = (W.to(device), support.to(device))
            return (*self._on_device[device], None)
        if isinstance(step, torch.Tensor):
            mask = self.realize_mask(step.to(device))
            W = metropolis_from_mask(mask)
            support = mask + torch.eye(self.num_agents, device=device)
            return W, support, mask
        mask = self.realize_mask(step)
        W = metropolis_from_mask(mask)
        support = mask + torch.eye(self.num_agents)
        return tuple(to_device(t, device) for t in (W, support, mask))

    # -- B-connectivity window diagnostics ------------------------------
    def union_support(self, step: int, window: int) -> torch.Tensor:
        """Union of the realized supports over steps (step - window, step]
        (clamped at 0), float32 0/1 on the CPU."""
        if self.is_static:
            return self.realize(0)[1]
        m = self.num_agents
        acc = torch.zeros((m, m))
        for i in range(int(window)):
            s = int(step) - i
            if s < 0:
                break
            acc += self.realize(s)[1]
        return (acc > 0).float()

    def window_monitor(self, window: int):
        """``monitor(step) -> {"connected", "union_min_degree",
        "union_edges"}`` of the union graph of the last ``window``
        realized supports ending at ``step``."""
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        m = self.num_agents

        def monitor(step):
            union = self.union_support(int(step), window)
            off = union * (1.0 - torch.eye(m))
            return {"connected": is_connected_mask(union),
                    "union_min_degree": int(off.sum(dim=1).min()),
                    "union_edges": int(off.sum() / 2.0)}

        return monitor


def make_mixing(topology: Topology, *, rate: float = 0.0,
                resample_every: int = 0, resample_p: float | None = None,
                seed: int = 0, mode: str | None = None) -> MixingProcess:
    """Build a `MixingProcess`, inferring the mode from the knobs:
    ``resample_every > 0`` -> resample, ``rate > 0`` -> dropout, else
    static.  Dropout together with resample is refused."""
    if mode is None:
        if resample_every > 0 and rate > 0.0:
            raise ValueError(
                "dropout and resample are separate modes; set only one of "
                "rate / resample_every")
        mode = ("resample" if resample_every > 0
                else "dropout" if rate > 0.0 else "static")
    return MixingProcess(mode=mode, topology=topology, rate=rate,
                         resample_every=resample_every,
                         resample_p=resample_p, seed=seed)


def as_process(topology_or_process) -> MixingProcess:
    """A bare `Topology` becomes its static process."""
    if isinstance(topology_or_process, MixingProcess):
        return topology_or_process
    if isinstance(topology_or_process, Topology):
        return MixingProcess(mode="static", topology=topology_or_process)
    raise TypeError(f"expected Topology or MixingProcess, got "
                    f"{type(topology_or_process).__name__}")
