"""Deterministic sharded synthetic token streams for LM training.

The port of `repro.data.lm_data`, numpy only: the same tokens, bit for bit.

Tokens follow a fixed random bigram process (learnable structure, so loss
visibly decreases), generated *statelessly* per (seed, step, dp_rank): a
restart at step k reproduces the exact stream — the checkpoint/restart and
elastic-resharding invariant the runtime driver relies on.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class LMStreamConfig:
    vocab: int
    seq: int
    global_batch: int
    seed: int = 0
    branching: int = 8  # bigram successors per token


class SyntheticLMStream:
    def __init__(self, cfg: LMStreamConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # each token has `branching` plausible successors
        self.successors = rng.integers(
            0, cfg.vocab, size=(cfg.vocab, cfg.branching), dtype=np.int64
        )

    def batch(self, step: int, dp_rank: int = 0, dp_size: int = 1) -> np.ndarray:
        """(global_batch/dp_size, seq) int32 for this data shard at this step."""
        cfg = self.cfg
        assert cfg.global_batch % dp_size == 0
        local = cfg.global_batch // dp_size
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, dp_rank])
        )
        toks = np.empty((local, cfg.seq), dtype=np.int64)
        toks[:, 0] = rng.integers(0, cfg.vocab, size=local)
        choices = rng.integers(0, cfg.branching, size=(local, cfg.seq - 1))
        for t in range(1, cfg.seq):
            toks[:, t] = self.successors[toks[:, t - 1], choices[:, t - 1]]
        return toks.astype(np.int32)

    def iterator(self, start_step: int = 0, dp_rank: int = 0, dp_size: int = 1):
        step = start_step
        while True:
            yield {"tokens": self.batch(step, dp_rank, dp_size)}
            step += 1
