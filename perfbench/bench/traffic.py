"""The one traffic generator: it reads a mix's parameters
(``perfbench/traffic/<mix>.json``) and makes the cell's inputs from the
run's seed.

Two kinds of mix:

* ``images``: a closed loop of batches of ``batch`` images, each batch a
  fresh one of a pool of ``pool_batches`` batches drawn from the seed (held
  in pinned host memory on a card, copied in per batch).
* ``prompts``: a closed loop of batches of ``batch`` requests, each with a
  prompt of token ids uniform over the vocabulary and ``new_tokens`` to
  generate.  The prompt lengths are a fixed set of ``pool_requests``
  lengths spread evenly over [``min_len``, ``max_len``]; each batch takes
  one length from each of ``batch`` equal strata of that set.  The seed
  draws which length of a stratum goes to which batch, their order in the
  batch and the ids: every seed offers the same set of sizes in another
  order, and batches differ little in their work.

Both are closed loops: the next batch is submitted when the last one's
answers are on the host.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

# the streams a run's seed is split into
WEIGHTS, TRAFFIC, SAMPLE, WARMUP = range(4)


def substreams(seed: int, n: int = 4) -> List[int]:
    """``n`` independent 63-bit seeds from a run's seed (any whole number,
    also past 32 bits and negative)."""
    s = int(seed)
    mag = abs(s)
    words = [int(s < 0)]
    while True:
        words.append(mag & 0xFFFFFFFF)
        mag >>= 32
        if not mag:
            break
    state = np.random.SeedSequence(words).generate_state(n, np.uint64)
    return [int(x) % 2**63 for x in state]


def image_pool(traffic: dict, config: dict, seed: int, pin: bool) -> torch.Tensor:
    """``(pool_batches, batch, C, H, W)`` int32 images uniform over the signed
    ``input_bits`` range (the values the integer network takes)."""
    if traffic["kind"] != "images":
        raise ValueError(f"not an image mix: {traffic['kind']!r}")
    gen = torch.Generator().manual_seed(substreams(seed)[TRAFFIC])
    lim = 2 ** (config["input_bits"] - 1)
    shape = (traffic["pool_batches"], traffic["batch"], config["in_channels"],
             config["input_hw"], config["input_hw"])
    pool = torch.randint(-lim + 1, lim, shape, generator=gen, dtype=torch.int32)
    return pool.pin_memory() if pin else pool


def prompt_lengths(traffic: dict) -> np.ndarray:
    """The mix's lengths, evenly spread and sorted."""
    lo, hi, n = traffic["min_len"], traffic["max_len"], traffic["pool_requests"]
    return lo + np.floor((np.arange(n) + 0.5) * (hi - lo + 1) / n).astype(np.int64)


def prompt_pool(traffic: dict, vocab: int, seed: int) -> List[np.ndarray]:
    """The mix's requests, batch after batch: ``pool_requests`` int32
    prompts, batch ``j`` the ``batch`` of them from ``j · batch`` on."""
    if traffic["kind"] != "prompts":
        raise ValueError(f"not a prompt mix: {traffic['kind']!r}")
    rng = np.random.default_rng(substreams(seed)[TRAFFIC])
    lengths, b = prompt_lengths(traffic), traffic["batch"]
    if len(lengths) % b:
        raise ValueError(f"pool_requests {len(lengths)} is not a multiple of the batch {b}")
    strata = np.stack([rng.permutation(row) for row in lengths.reshape(b, -1)])
    lengths = np.stack([rng.permutation(row) for row in strata.T]).reshape(-1)
    ids = rng.integers(0, vocab, int(lengths.sum()), dtype=np.int64).astype(np.int32)
    return np.split(ids, np.cumsum(lengths)[:-1])


def warmup_prompts(traffic: dict, vocab: int, seed: int) -> List[np.ndarray]:
    """One batch of prompts at the mix's longest length: the largest shapes
    its batches reach."""
    rng = np.random.default_rng(substreams(seed)[WARMUP])
    return [rng.integers(0, vocab, traffic["max_len"], dtype=np.int64).astype(np.int32)
            for _ in range(traffic["batch"])]
