"""Models (dense transformer and xLSTM families)."""
from .build import ModelBundle, build_model

__all__ = ["ModelBundle", "build_model"]
