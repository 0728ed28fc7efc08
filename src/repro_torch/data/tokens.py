"""Synthetic LM token pipeline (the reference's ``repro/data/tokens.py``):
sharded, deterministic, resumable.

Every batch is a function of (seed, step, shard) alone, so every
data-parallel shard gets its own tokens, a run is exactly reproducible,
and a run resumed at step k after a crash reads the same stream with no
iterator state beyond the integer step.

The tokens follow a Zipf law (logits ``log(1/rank)``) with a learnable
short-range structure: in the ``(b, s + 1)`` draw, every position ``i``
with ``i % 8 == 7`` repeats position ``i − 7``; ``tokens`` are the draw
without its last column and ``labels`` without its first (int32 numpy).

The rule is the reference's; the stream is not.  The reference draws with
``jax.random.categorical`` under ``fold_in(fold_in(key(seed), step),
shard)`` (threefry); the port, which imports no JAX, draws by inverse CDF
from ``numpy.random.default_rng([seed, step, shard])``.  Tests that compare
the two packages feed both the reference's own batches.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    num_shards: int = 1           # data-parallel shards
    seed: int = 0

    @property
    def per_shard_batch(self) -> int:
        if self.global_batch % self.num_shards:
            raise ValueError(f"global_batch {self.global_batch} is not a "
                             f"multiple of num_shards {self.num_shards}")
        return self.global_batch // self.num_shards


def _zipf_logits(vocab_size: int) -> np.ndarray:
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    return np.log(1.0 / ranks)


class TokenPipeline:
    """Stateless-per-step synthetic token source."""

    def __init__(self, config: TokenPipelineConfig):
        self.config = config
        p = np.exp(_zipf_logits(config.vocab_size))
        self._cdf = np.cumsum(p / p.sum())

    def batch_at(self, step: int, shard: int = 0) -> dict[str, np.ndarray]:
        """Batch for (step, shard): dict(tokens, labels) of (B_shard, S)
        int32.  Deterministic and independent across (step, shard)
        pairs."""
        cfg = self.config
        if not (0 <= shard < cfg.num_shards):
            raise ValueError(f"shard {shard} out of range")
        b, s = cfg.per_shard_batch, cfg.seq_len
        rng = np.random.default_rng([cfg.seed, step, shard])
        u = rng.random((b, s + 1))
        draw = np.minimum(np.searchsorted(self._cdf, u, side="right"),
                          cfg.vocab_size - 1)
        # Short-range structure: every 8th position repeats the token 7
        # before it, an easily learnable conditional.
        idx = np.arange(s + 1)
        src = np.where(idx % 8 == 7, idx - 7, idx)
        draw = draw[:, src].astype(np.int32)
        return {"tokens": draw[:, :-1], "labels": draw[:, 1:]}

    def global_batch_at(self, step: int) -> dict[str, np.ndarray]:
        """All shards concatenated (host-side convenience for 1-process
        runs)."""
        parts = [self.batch_at(step, sh)
                 for sh in range(self.config.num_shards)]
        return {k: np.concatenate([p[k] for p in parts], axis=0)
                for k in parts[0]}


__all__ = ["TokenPipeline", "TokenPipelineConfig"]
