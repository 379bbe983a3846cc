"""Deterministic synthetic LM data pipeline.

The port's own copy of the reference's ``repro/data/pipeline.py``: the same
order-k Markov source with a sparse random transition table and the same
``np.random.default_rng`` streams, so a batch is bit-identical to the
reference's for the same config, step and host. Batches are host numpy
(int32); the train step moves them to its device. Sharding: each host takes
its rows by ``host_index`` out of ``host_count``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

__all__ = ["DataConfig", "SyntheticLM"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    order: int = 2          # Markov order of the synthetic source


class SyntheticLM:
    """Order-k Markov source with a sparse random transition structure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab_size
        # each context hashes to a small set of likely next tokens
        self._tables = rng.integers(0, V, size=(4096, 8))
        self._mix = 0.9

    def _hash(self, ctx: np.ndarray) -> np.ndarray:
        # order 1 with vocab <= 4096: the table is indexed by the previous
        # token itself, so p(next | prev) is learnable; a hashed context
        # over a larger vocabulary can only be memorised
        if ctx.shape[1] == 1 and self.cfg.vocab_size <= 4096:
            return ctx[:, 0].astype(np.int64)
        h = np.zeros(ctx.shape[0], dtype=np.int64)
        for k in range(ctx.shape[1]):
            h = h * 1000003 + ctx[:, k]
        return np.abs(h) % 4096

    def batch(self, step: int, host_index: int = 0, host_count: int = 1):
        """dict(tokens (B_host, S), labels (B_host, S)) int32 for a step."""
        cfg = self.cfg
        if cfg.global_batch % host_count:
            raise ValueError(f"global_batch {cfg.global_batch} does not "
                             f"split over {host_count} hosts")
        B = cfg.global_batch // host_count
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + host_index)
        V, S, k = cfg.vocab_size, cfg.seq_len, cfg.order
        toks = np.empty((B, S + 1), dtype=np.int32)
        toks[:, :k] = rng.integers(0, V, size=(B, k))
        for t in range(k, S + 1):
            h = self._hash(toks[:, t - k:t])
            choices = self._tables[h]                       # (B, 8)
            pick = choices[np.arange(B), rng.integers(0, 8, size=B)]
            rand = rng.integers(0, V, size=B)
            use_table = rng.random(B) < self._mix
            toks[:, t] = np.where(use_table, pick, rand)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
