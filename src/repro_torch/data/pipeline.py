"""Deterministic synthetic-LM data pipeline with a BRAVO-guarded shard index.

The token stream is a seeded Zipf-ish mixture (deterministic per (shard,
step) so restarts can replay exactly — the fault-tolerance tests rely on
it).  Multiple loader threads *read* the shard-assignment index for every
batch they cut; the index is *written* only on epoch boundaries or elastic
rescales — a read-dominated pattern guarded by a selectable rwlock, and the
second first-class BRAVO integration point.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..core.factory import LockEnv


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    n_shards: int = 64
    seed: int = 1234


class SyntheticLM:
    """Deterministic pseudo-corpus: next token depends on previous tokens
    (so a model can actually reduce loss on it)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def sample(self, shard: int, step: int,
               n_seq: int) -> Tuple[np.ndarray, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + shard) * 1_000_033 + step)
        S = cfg.seq_len
        base = rng.integers(0, cfg.vocab, size=(n_seq, S), dtype=np.int64)
        # inject learnable structure: token[t] == f(token[t-1]) 50% of time
        follow = (base[:, :-1] * 31 + 7) % cfg.vocab
        mask = rng.random((n_seq, S - 1)) < 0.5
        base[:, 1:] = np.where(mask, follow, base[:, 1:])
        tokens = base[:, :-1].astype(np.int32)
        labels = base[:, 1:].astype(np.int32)
        return tokens, labels


class ShardIndex:
    """shard -> loader assignment, rwlock-guarded (read-dominated)."""

    def __init__(self, n_shards: int, n_loaders: int, lock):
        self.lock = lock
        self.n_shards = n_shards
        self.assign = np.arange(n_shards) % max(n_loaders, 1)
        self.epoch = 0

    def shards_of(self, loader: int) -> np.ndarray:
        tok = self.lock.acquire_read()
        try:
            return np.where(self.assign == loader)[0].copy()
        finally:
            self.lock.release_read(tok)

    def rebalance(self, n_loaders: int) -> None:
        """Elastic rescale: reassign shards (writer)."""
        tok = self.lock.acquire_write()
        try:
            self.assign = np.arange(self.n_shards) % max(n_loaders, 1)
            self.epoch += 1
        finally:
            self.lock.release_write(tok)


def make_batches(cfg: DataConfig, *, loader: int = 0, n_loaders: int = 1,
                 start_step: int = 0,
                 index: Optional[ShardIndex] = None,
                 env: Optional[LockEnv] = None,
                 lock_name: str = "bravo-ba") -> Iterator[Dict[str, np.ndarray]]:
    """Yields {"tokens","labels"} batches; deterministic in (cfg, step)."""
    gen = SyntheticLM(cfg)
    if index is None:
        env = env or LockEnv()
        index = ShardIndex(cfg.n_shards, n_loaders, env.make(lock_name))
    step = start_step
    per = cfg.global_batch // max(n_loaders, 1)
    while True:
        shards = index.shards_of(loader)
        shard = int(shards[step % len(shards)])
        tokens, labels = gen.sample(shard, step, per)
        yield {"tokens": tokens, "labels": labels}
        step += 1
