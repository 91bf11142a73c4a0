"""Host-side LM data pipeline (counterpart of ``repro.data.pipeline``;
numpy only, so the port and the reference draw identical batches).

Batches are (agents, per_agent_batch, seq) and random-access: agent a's
rows at ``step`` come from ``np.random.default_rng((seed, step, a))``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .synthetic import SyntheticLMDataset

__all__ = ["DataPipeline", "make_lm_pipeline"]


@dataclasses.dataclass
class DataPipeline:
    dataset: SyntheticLMDataset
    num_agents: int
    per_agent_batch: int
    seq_len: int
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        """``{"tokens", "labels"}`` int32 arrays for ``step``."""
        tokens = np.stack([
            self.dataset.batch(np.random.default_rng((self.seed, step, a)),
                               self.per_agent_batch, self.seq_len + 1)
            for a in range(self.num_agents)])
        return {"tokens": tokens[..., :-1], "labels": tokens[..., 1:]}


def make_lm_pipeline(vocab_size: int, num_agents: int, per_agent_batch: int,
                     seq_len: int, seed: int = 0) -> DataPipeline:
    return DataPipeline(
        dataset=SyntheticLMDataset(vocab_size=vocab_size, seed=seed),
        num_agents=num_agents, per_agent_batch=per_agent_batch,
        seq_len=seq_len, seed=seed)
