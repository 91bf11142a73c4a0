"""Agent failure as a random-access stochastic process (counterpart of
``repro.faults.process``).

`FaultProcess.realize(step)` says which agents are up and which transmit
garbage at an absolute step, and `realize_coupling` folds that into the
mixing realization: a down agent's incident links are dropped and the
Metropolis weights recomputed over the survivors, so every realized W_k
is doubly stochastic with w_ii > 0 (a dead agent's row is e_i: it mixes
with nobody and holds).

Modes, as the reference:

* **Markov crash-restart** (``crash_rate > 0, restart_rate > 0``): each
  agent draws a crash onset per step; an onset at step s knocks it out
  for a geometric(``restart_rate``) number of steps, truncated at
  ``max_outage``.  Onsets and durations fold in the absolute step, so
  ``realize(step)`` is random access (a lookback over the last
  ``max_outage`` onsets).
* **Failstop** (``crash_rate > 0, restart_rate == 0``): agent i's first
  crash T_i ~ Geometric(crash_rate) is drawn once with
  ``np.random.default_rng(seed)``; ``alive = step < T_i``.
* **Corrupt transmits** (``corrupt_rate > 0``): a live agent poisons what
  it sends this step (nan, +inf, or scaled by ``corrupt_scale``),
  neutralized at each receiver by the per-link finite guard.

The draws use `core.prng`, so each realization is the reference's bit for
bit — up to the one transcendental: a Markov outage length is
``1 + floor(log1p(-u) / log1p(-restart_rate))`` in float32, and torch's
``log1p`` may differ from XLA's by an ulp, which moves a length only
where the quotient sits on an integer.  The lookback only asks whether a
length exceeds d, and u takes the 2^23 values k 2^-23, so that formula is
evaluated once, on the CPU, over all of them (`_duration_thresholds`):
"length > d" is then ``u >= t_d``, a float32 comparison that is exact on
every device.  So a realization drawn on the card is the host's bit for
bit, whatever the card's ``log1p``.

``realize(step)`` takes an int (a host realization: one batched threefry
pass over the lookback, memoized for the last few steps) or a 0-d int64
device counter: the draws then run on the counter's device, nothing is
memoized and nothing is read back, which is what a CUDA graph of steps
captures.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core import prng
from ..core.mixing import MixingProcess, metropolis_from_mask
from ..kernels.build import to_device
from ..kernels.ref import CORRUPT_MODES

__all__ = ["FaultProcess", "make_faults", "realize_coupling",
           "CORRUPT_MODES", "REJOIN_POLICIES"]

REJOIN_POLICIES = ("hold", "neighbor-avg")
_MEMO = 8  # realizations kept: the step and its predecessor, with room


def _f32(v) -> float:
    """``v`` rounded to float32, as a python float (a comparison with a
    float32 tensor then takes place in float32 on any device)."""
    return float(np.float32(v))


@functools.lru_cache(maxsize=None)
def _duration_thresholds(restart_rate: float,
                         max_outage: int) -> torch.Tensor:
    """(max_outage,) float32 t_d with ``dur(u) > d  <=>  u >= t_d`` for
    every uniform u = k 2^-23, dur the reference's truncated geometric
    length ``clamp(1 + floor(log1p(-u) / log1p(-restart_rate)), 1,
    max_outage)`` in float32, evaluated on the CPU over all 2^23 values of
    u (t_d = 1.0, never reached, where no u gives a length above d)."""
    d = torch.arange(max_outage, dtype=torch.float32)
    if restart_rate >= 1.0:  # every outage lasts one step
        return torch.where(d < 1.0, 0.0, 1.0)
    u = prng.bits_to_uniform(torch.arange(1 << 23, dtype=torch.int64) << 9)
    log_keep = torch.tensor(np.log1p(-restart_rate), dtype=torch.float32)
    dur = 1.0 + torch.floor(torch.log1p(-u) / log_keep)
    dur = torch.clamp(dur, 1.0, float(max_outage))
    if not bool((dur[1:] >= dur[:-1]).all()):
        raise ValueError("the outage length is not monotone in u")
    count = torch.searchsorted(dur, d, right=True)  # how many u give <= d
    return (count.double() / float(1 << 23)).float()


def _uniforms(key: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Row l is ``prng.uniform(fold_in(key, idx[l]), (n,))``: (L, n), on
    key's device."""
    keys = prng.fold_in(key, idx)
    ctr = torch.arange(n, dtype=torch.int64, device=key.device)[None, :]
    y0, y1 = prng.threefry2x32(keys[:, 0:1], keys[:, 1:2],
                               (ctr >> 32) & prng.MASK32, ctr & prng.MASK32)
    return torch.clamp_min(prng.bits_to_uniform(y0 ^ y1), 0.0)


# eq=False: identity semantics, as the reference; compare configurations
# with fingerprint().
@dataclasses.dataclass(frozen=True, eq=False)
class FaultProcess:
    """``realize(step) -> (alive, corrupt)``, both (m,) float32 0/1 — on the
    CPU for an int step, on the counter's device for a 0-d int64 counter:
    ``alive`` 1 for agents up this step (a down agent neither transmits
    nor updates); ``corrupt`` 1 for live agents whose outgoing messages
    are poisoned this step (a subset of ``alive``)."""

    num_agents: int
    crash_rate: float = 0.0
    restart_rate: float = 0.0
    corrupt_rate: float = 0.0
    corrupt_mode: str = "nan"
    corrupt_scale: float = 1e4
    rejoin: str = "hold"
    guard_clip: float | None = 1e3  # None: no guard
    max_outage: int = 64
    seed: int = 0

    def __post_init__(self):
        if self.num_agents < 1:
            raise ValueError(f"need num_agents >= 1, got {self.num_agents}")
        if not 0.0 <= self.crash_rate < 1.0:
            raise ValueError(f"crash_rate must be in [0, 1), "
                             f"got {self.crash_rate}")
        if not 0.0 <= self.restart_rate <= 1.0:
            raise ValueError(f"restart_rate must be in [0, 1], "
                             f"got {self.restart_rate}")
        if not 0.0 <= self.corrupt_rate <= 1.0:
            raise ValueError(f"corrupt_rate must be in [0, 1], "
                             f"got {self.corrupt_rate}")
        if self.corrupt_mode not in CORRUPT_MODES:
            raise ValueError(f"unknown corrupt_mode {self.corrupt_mode!r}; "
                             f"have {CORRUPT_MODES}")
        if self.rejoin not in REJOIN_POLICIES:
            raise ValueError(f"unknown rejoin policy {self.rejoin!r}; "
                             f"have {REJOIN_POLICIES}")
        if self.guard_clip is not None and not self.guard_clip > 0.0:
            raise ValueError(f"guard_clip must be > 0 (or None to disable "
                             f"the guard), got {self.guard_clip}")
        if self.max_outage < 1:
            raise ValueError(f"max_outage must be >= 1, got {self.max_outage}")
        # knobs that drive nothing are refused, as in the reference
        if self.restart_rate > 0.0 and self.crash_rate == 0.0:
            raise ValueError("restart_rate is a crash-mode knob; set "
                             "crash_rate > 0 to use it")
        if self.rejoin != "hold":
            if self.crash_rate == 0.0 or self.restart_rate == 0.0:
                raise ValueError(
                    "rejoin='neighbor-avg' needs a crash-restart process "
                    "(crash_rate > 0 AND restart_rate > 0); failstop "
                    "agents never rejoin")
        if self.corrupt_rate == 0.0 and (self.corrupt_mode != "nan"
                                         or self.corrupt_scale != 1e4):
            raise ValueError(
                "corrupt_mode/corrupt_scale are corruption knobs; "
                "corrupt_rate=0 ignores them")
        root = prng.key(self.seed)
        consts = {"key_crash": prng.fold_in(root, 0),
                  "key_dur": prng.fold_in(root, 1),
                  "key_corrupt": prng.fold_in(root, 2)}
        if self.is_failstop:
            rng = np.random.default_rng(self.seed)
            consts["t_fail"] = torch.from_numpy(
                rng.geometric(self.crash_rate, size=self.num_agents)
                .astype(np.int64))
        elif self.crash_rate > 0.0:
            consts["dur_thresholds"] = _duration_thresholds(
                float(self.restart_rate), int(self.max_outage))
        object.__setattr__(self, "_consts", consts)
        object.__setattr__(self, "_memo", {})
        object.__setattr__(self, "_on_device", {})

    @property
    def is_inert(self) -> bool:
        """True when realize() is constantly (ones, zeros): no faults."""
        return self.crash_rate == 0.0 and self.corrupt_rate == 0.0

    @property
    def has_crash(self) -> bool:
        return self.crash_rate > 0.0

    @property
    def has_corruption(self) -> bool:
        return self.corrupt_rate > 0.0

    @property
    def is_failstop(self) -> bool:
        return self.crash_rate > 0.0 and self.restart_rate == 0.0

    def fingerprint(self) -> dict:
        """JSON-stable identity of the configuration, inert knobs
        normalized out (as the reference's)."""
        crash, corrupt = self.has_crash, self.has_corruption
        return {
            "num_agents": int(self.num_agents),
            "crash_rate": float(self.crash_rate),
            "restart_rate": float(self.restart_rate) if crash else 0.0,
            "rejoin": self.rejoin if crash else None,
            "max_outage": (int(self.max_outage)
                           if crash and self.restart_rate > 0.0 else 0),
            "corrupt_rate": float(self.corrupt_rate),
            "corrupt_mode": self.corrupt_mode if corrupt else None,
            "corrupt_scale": (float(self.corrupt_scale)
                              if corrupt and self.corrupt_mode == "scale"
                              else None),
            "guard_clip": ((float(self.guard_clip)
                            if self.guard_clip is not None else "off")
                           if corrupt else None),
            "seed": None if self.is_inert else int(self.seed),
        }

    def _consts_on(self, device) -> dict:
        """The keys, failstop times and duration thresholds on ``device``,
        copied once: the eager chunk a CUDA graph runs before its capture
        makes them, so the capture copies nothing."""
        device = torch.device(device)
        if device.type == "cpu":
            return self._consts
        if device not in self._on_device:
            self._on_device[device] = {n: to_device(t, device)
                                       for n, t in self._consts.items()}
        return self._on_device[device]

    def _markov_down(self, step) -> torch.Tensor:
        """(m,) bool: the union of the outages active at ``step`` — every
        onset in the last ``max_outage`` steps with its own geometric
        duration (``dur > d`` as ``u >= t_d``, `_duration_thresholds`).
        ``step`` an int or a 0-d int64 tensor, on whose device the draws
        run."""
        dev = step.device if isinstance(step, torch.Tensor) else None
        c = self._consts_on(dev or "cpu")
        m = self.num_agents
        d = torch.arange(self.max_outage, dtype=torch.int64, device=dev)
        s = step - d
        sc = torch.clamp_min(s, 0)
        onset = _uniforms(c["key_crash"], sc, m) < _f32(self.crash_rate)
        lasts = (_uniforms(c["key_dur"], sc, m)
                 >= c["dur_thresholds"][:, None])
        live = (s >= 0)[:, None]
        return (onset & lasts & live).any(dim=0)

    def realize(self, step):
        """(alive, corrupt) at the absolute ``step``: (m,) float32 0/1.  An
        int gives them on the CPU, memoized (do not write to them); a 0-d
        int64 counter tensor on its device, drawn there from the counter
        without a host sync (what a CUDA graph of steps captures), bit
        for bit the int form's."""
        if isinstance(step, torch.Tensor):
            return self._realize(step.to(torch.int64), step.device)
        step = int(step)
        hit = self._memo.get(step)
        if hit is not None:
            return hit
        out = self._realize(step, torch.device("cpu"))
        if len(self._memo) >= _MEMO:
            self._memo.pop(next(iter(self._memo)))
        self._memo[step] = out
        return out

    def _realize(self, step, dev: torch.device):
        c = self._consts_on(dev)
        m = self.num_agents
        if self.crash_rate == 0.0:
            alive = torch.ones(m, device=dev)
        elif self.is_failstop:
            alive = (step < c["t_fail"]).float()
        else:
            alive = (~self._markov_down(step)).float()
        if self.corrupt_rate == 0.0:
            corrupt = torch.zeros(m, device=dev)
        else:
            idx = (step.reshape(1) if isinstance(step, torch.Tensor)
                   else torch.tensor([step]))
            draws = _uniforms(c["key_corrupt"], idx, m)[0]
            corrupt = (draws < _f32(self.corrupt_rate)).float() * alive
        return alive, corrupt

    def alive_at(self, step) -> torch.Tensor:
        return self.realize(step)[0]

    def alive_before(self, step) -> torch.Tensor:
        """Who was up at ``step - 1`` (everyone, before step 0); for a
        counter tensor a ``where`` on its device."""
        if isinstance(step, torch.Tensor):
            prev = self.alive_at(torch.clamp_min(step - 1, 0))
            return torch.where(step > 0, prev, torch.ones_like(prev))
        if int(step) <= 0:
            return torch.ones(self.num_agents)
        return self.alive_at(int(step) - 1)

    def rejoin_mask(self, step) -> torch.Tensor:
        """1 for agents up at ``step`` that were down at ``step - 1``
        (nothing rejoins at step 0)."""
        return self.alive_at(step) * (1.0 - self.alive_before(step))


def make_faults(num_agents: int, *, crash_rate: float = 0.0,
                restart_rate: float = 0.0, corrupt_rate: float = 0.0,
                corrupt_mode: str = "nan", corrupt_scale: float = 1e4,
                rejoin: str = "hold", guard_clip: float | None = 1e3,
                max_outage: int = 64, seed: int = 0) -> FaultProcess:
    """Build a `FaultProcess`, normalizing the knobs of an inert
    dimension so it never trips the stray-knob validation."""
    if corrupt_rate == 0.0:
        corrupt_mode, corrupt_scale = "nan", 1e4
    if crash_rate == 0.0:
        restart_rate, rejoin = 0.0, "hold"
    return FaultProcess(num_agents=num_agents, crash_rate=crash_rate,
                        restart_rate=restart_rate, corrupt_rate=corrupt_rate,
                        corrupt_mode=corrupt_mode,
                        corrupt_scale=corrupt_scale, rejoin=rejoin,
                        guard_clip=guard_clip, max_outage=max_outage,
                        seed=seed)


def realize_coupling(process: MixingProcess, faults: FaultProcess,
                     step, device=None):
    """Compose a mixing realization with a fault realization:
    ``(W, support, mask, alive, corrupt)``.

    ``mask`` is the mixing mask (the base graph for a static process) with
    every down agent's links dropped; W its Metropolis weights (a dead
    agent's row is e_i), ``support = mask + I`` (what B^k is drawn on, so
    a dead agent's B column is e_i and nobody receives from it).

    ``step`` an int: realized on the host, W, support and mask copied to
    ``device``, alive and corrupt left on the CPU.  ``step`` a 0-d int64
    counter tensor: all five drawn and composed on its device, with no
    host sync or copy."""
    if process.num_agents != faults.num_agents:
        raise ValueError(
            f"mixing has {process.num_agents} agents but faults were "
            f"built for {faults.num_agents}")
    alive, corrupt = faults.realize(step)
    if isinstance(step, torch.Tensor):
        dev = step.device
        # the base graph's copy on the device (made by the eager chunk)
        base = (process._device_consts(dev)[1] if process.is_static
                else process.realize_mask(step))
        mask = base * (alive[:, None] * alive[None, :])
        return (metropolis_from_mask(mask),
                mask + torch.eye(process.num_agents, device=dev), mask,
                alive, corrupt)
    base = (process.base_mask if process.is_static
            else process.realize_mask(step))
    mask = base * (alive[:, None] * alive[None, :])
    W = metropolis_from_mask(mask)
    support = mask + torch.eye(process.num_agents)
    device = torch.device(device or "cpu")
    return (*(to_device(t, device) for t in (W, support, mask)), alive,
            corrupt)
