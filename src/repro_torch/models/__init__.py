"""Models (dense transformer family)."""
from .build import ModelBundle, build_model

__all__ = ["ModelBundle", "build_model"]
