"""Deterministic synthetic data (numpy, shared with the reference)."""
from .pipeline import DataPipeline, make_lm_pipeline
from .synthetic import (SyntheticLMDataset, estimation_problem,
                        synthetic_digits)

__all__ = ["DataPipeline", "make_lm_pipeline", "SyntheticLMDataset",
           "estimation_problem", "synthetic_digits"]
