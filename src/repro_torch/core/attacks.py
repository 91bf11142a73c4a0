"""Compatibility shim, as the reference keeps one: the attack harness lives
in `repro_torch.privacy.attacks`; this module re-exports the names that
``repro.core.attacks`` re-exports."""
from __future__ import annotations

from ..privacy.attacks import (DLGResult, dlg_attack, dlg_attack_grid,
                               eavesdropper_observation,
                               gradient_match_loss)

__all__ = ["DLGResult", "dlg_attack", "dlg_attack_grid",
           "gradient_match_loss", "eavesdropper_observation"]
