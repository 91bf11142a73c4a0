"""Deterministic synthetic data (numpy, shared with the reference) and the
worker thread that builds chunks ahead of the train loop."""
from .pipeline import (BATCH_LOGICAL, CHUNK_LOGICAL, DataPipeline,
                       make_lm_pipeline)
from .prefetch import Prefetcher, make_placer, prefetch_chunks
from .synthetic import (SyntheticLMDataset, estimation_problem,
                        synthetic_digits)

__all__ = ["DataPipeline", "make_lm_pipeline", "SyntheticLMDataset",
           "estimation_problem", "synthetic_digits", "BATCH_LOGICAL",
           "CHUNK_LOGICAL", "Prefetcher", "make_placer", "prefetch_chunks"]
