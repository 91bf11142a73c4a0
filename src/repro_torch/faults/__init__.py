"""Agent-level fault injection, degradation and healing (counterpart of
``repro.faults``): `process.FaultProcess` realizes per-step (alive,
corrupt) vectors from the absolute step, `realize_coupling` composes them
with a mixing realization, and `inject` holds the degradation mechanics
(transmit poisoning, finite-guarded gossip, trimmed-mean aggregation,
neighbour-average rejoin warm start); `audit` measures what that warm
start leaks (import it from there)."""
from .inject import (finite_guard, guarded_gossip_mix,
                     neighbor_avg_warmstart, poison_transmit,
                     trimmed_mean_mix)
from .process import (CORRUPT_MODES, REJOIN_POLICIES, FaultProcess,
                      make_faults, realize_coupling)

__all__ = ["FaultProcess", "make_faults", "realize_coupling",
           "CORRUPT_MODES", "REJOIN_POLICIES", "poison_transmit",
           "finite_guard", "guarded_gossip_mix", "trimmed_mean_mix",
           "neighbor_avg_warmstart"]
