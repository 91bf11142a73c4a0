"""The privacy audit (counterpart of ``repro.privacy``):

* `observe`    — wire-tap capture: adversary models (auditor / external
                 eavesdropper / curious neighbour) and the observation
                 records every execution path emits;
* `estimators` — empirical entropy, theta and MSE-floor estimators
                 (binned and Kozachenko–Leonenko kNN) checking Theorem 5's
                 closed forms (`core.entropy`) from samples; numpy, a copy
                 of the reference's;
* `attacks`    — DLG gradient inversion (Sec. VII), its sweep, and the
                 least-squares inversion that is exact against
                 conventional DSGD and Theorem-5-floored against PDSGD.

`launch.audit` drives all three and writes the JSON privacy report.
"""
from .attacks import (DLGResult, dlg_attack, dlg_attack_grid,
                      dsgd_exact_recovery, eavesdropper_aggregate,
                      eavesdropper_observation, gradient_match_loss,
                      pdsgd_ls_recovery, recovery_mse,
                      states_from_broadcast)
from .estimators import (binned_entropy, empirical_recovery_floor,
                         estimate_h_y, estimate_theta, knn_entropy,
                         observations_from_capture, sample_observations)
from .observe import (Adversary, adversary_view, auditor, curious_neighbor,
                      external_eavesdropper, flatten_agents, full_record,
                      state_record, wire_messages)

__all__ = [
    "Adversary", "auditor", "external_eavesdropper", "curious_neighbor",
    "adversary_view", "flatten_agents", "wire_messages", "full_record",
    "state_record",
    "binned_entropy", "knn_entropy", "estimate_h_y", "estimate_theta",
    "empirical_recovery_floor", "sample_observations",
    "observations_from_capture",
    "DLGResult", "dlg_attack", "dlg_attack_grid", "gradient_match_loss",
    "eavesdropper_observation", "eavesdropper_aggregate",
    "dsgd_exact_recovery", "pdsgd_ls_recovery", "recovery_mse",
    "states_from_broadcast",
]
