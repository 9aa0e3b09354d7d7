"""Deterministic, restartable data pipeline of the PyTorch port: the port's
own copy of the JAX package's ``data/pipeline.py`` (numpy and the standard
library only; batches equal to JAX's bit for bit at every (seed, step, rank,
world)).

Synthetic LM token streams (mixture of Zipfian unigram draws and copy/induction
spans so the loss actually has structure to learn), sharded per data-parallel
host, with double-buffered prefetch.  The iterator state is a single integer
(the step), so checkpoint/restore and elastic re-sharding resume *exactly* —
batch `i` is a pure function of (seed, i, dp_rank, dp_size).
"""
from __future__ import annotations

import threading
import queue
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    copy_frac: float = 0.3  # fraction of each sequence that is a copied span


def _batch(cfg: DataConfig, step: int, rank: int = 0, world: int = 1) -> Dict[str, np.ndarray]:
    """Pure function (seed, step, rank, world) -> batch shard."""
    assert cfg.global_batch % world == 0
    b = cfg.global_batch // world
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, rank]))
    s = cfg.seq_len + 1
    zipf = rng.zipf(cfg.zipf_a, size=(b, s))
    toks = (zipf % (cfg.vocab_size - 2)) + 2  # 0/1 reserved (pad/bos)
    # induction spans: copy an earlier slice forward so context matters
    span = max(2, int(cfg.seq_len * cfg.copy_frac) // 2)
    if s > 2 * span + 2:
        start = rng.integers(1, s - 2 * span - 1, size=b)
        for i in range(b):
            toks[i, start[i] + span : start[i] + 2 * span] = toks[i, start[i] : start[i] + span]
    toks[:, 0] = 1  # bos
    return {
        "tokens": toks[:, :-1].astype(np.int32),
        "labels": toks[:, 1:].astype(np.int32),
    }


class TokenPipeline:
    """Prefetching iterator over deterministic batches."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, rank: int = 0, world: int = 1, prefetch: int = 2):
        self.cfg, self.rank, self.world = cfg, rank, world
        self.step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        step = self.step
        while not self._stop.is_set():
            try:
                self._q.put((step, _batch(self.cfg, step, self.rank, self.world)), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        step, batch = self._q.get()
        self.step = step + 1
        return batch

    def state(self) -> int:
        return self.step

    def close(self):
        self._stop.set()


def batch_at(cfg: DataConfig, step: int, rank: int = 0, world: int = 1) -> Dict[str, np.ndarray]:
    return _batch(cfg, step, rank, world)
