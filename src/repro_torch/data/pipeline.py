"""Host-side LM data pipeline (counterpart of ``repro.data.pipeline``;
numpy only, so the port and the reference draw identical batches).

Batches are (agents, per_agent_batch, seq) and random-access: agent a's
rows at ``step`` come from ``np.random.default_rng((seed, step, a))``, so
an ``agent_slice`` build is bit for bit the matching rows of the full
build.  The scanned loop (`core.make_scanned_steps`) takes *chunks*: the
batches of ``unroll_k`` consecutive steps stacked on a leading axis
(`chunk_at`, `chunks`), so a resumed run re-chunks from any step and
walks the uninterrupted stream.  `data.prefetch` builds them ahead of the
consumer on a worker thread.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from .synthetic import SyntheticLMDataset

__all__ = ["DataPipeline", "make_lm_pipeline", "BATCH_LOGICAL",
           "CHUNK_LOGICAL"]

# Logical axis names of a batch leaf and of a chunk leaf (the reference's,
# which its sharding rule tables resolve; the leading scan axis of a chunk
# is never sharded)
BATCH_LOGICAL = ("agents", "batch", "seq")
CHUNK_LOGICAL = (None,) + BATCH_LOGICAL


@dataclasses.dataclass
class DataPipeline:
    dataset: SyntheticLMDataset
    num_agents: int
    per_agent_batch: int
    seq_len: int
    seed: int = 0

    def _slice(self, agent_slice: tuple[int, int] | None) -> tuple[int, int]:
        if agent_slice is None:
            return 0, self.num_agents
        lo, hi = int(agent_slice[0]), int(agent_slice[1])
        if not (0 <= lo < hi <= self.num_agents):
            raise ValueError(
                f"agent_slice {agent_slice} out of range for "
                f"{self.num_agents} agents")
        return lo, hi

    def batch_at(self, step: int,
                 agent_slice: tuple[int, int] | None = None) -> dict:
        """``{"tokens", "labels"}`` int32 arrays for ``step``; with
        ``agent_slice=(lo, hi)`` only agents [lo, hi)."""
        lo, hi = self._slice(agent_slice)
        tokens = np.stack([
            self.dataset.batch(np.random.default_rng((self.seed, step, a)),
                               self.per_agent_batch, self.seq_len + 1)
            for a in range(lo, hi)])
        return {"tokens": tokens[..., :-1], "labels": tokens[..., 1:]}

    def chunk_at(self, start_step: int, unroll_k: int,
                 agent_slice: tuple[int, int] | None = None) -> dict:
        """The batches of steps [start_step, start_step + unroll_k)
        stacked leaf by leaf on a leading (unroll_k,) axis."""
        batches = [self.batch_at(start_step + i, agent_slice)
                   for i in range(unroll_k)]
        return {k: np.stack([b[k] for b in batches]) for k in batches[0]}

    def chunks(self, unroll_k: int, start_step: int = 0,
               num_chunks: int | None = None,
               agent_slice: tuple[int, int] | None = None) -> Iterator[dict]:
        """`chunk_at` of consecutive chunks from ``start_step``; endless
        unless ``num_chunks`` is given."""
        c = 0
        while num_chunks is None or c < num_chunks:
            yield self.chunk_at(start_step + c * unroll_k, unroll_k,
                                agent_slice)
            c += 1

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_lm_pipeline(vocab_size: int, num_agents: int, per_agent_batch: int,
                     seq_len: int, seed: int = 0) -> DataPipeline:
    return DataPipeline(
        dataset=SyntheticLMDataset(vocab_size=vocab_size, seed=seed),
        num_agents=num_agents, per_agent_batch=per_agent_batch,
        seq_len=seq_len, seed=seed)
