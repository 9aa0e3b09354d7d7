"""Continuous-batching scheduler over the pimsab decode step (the port of the
JAX package's ``serve/scheduler.py``).

The lock-step :class:`~repro_torch.serve.engine.ServeEngine` pads every
request to one static batch and keeps retired lanes in the shape until the
*last* request finishes.  This scheduler replaces that loop for the pimsab
backend:

* **Admit/evict between decode steps.**  Requests wait in a FIFO queue and
  are admitted whenever an active lane is free.  When the lanes are full and
  a queued request needs strictly fewer remaining tokens than the longest
  active one, that active request is *preempted* (shortest-job-first): its
  :class:`ResidentState` handles park its cache on the host and it re-enters
  the queue front, so resume is exact — no recompute, no approximation.
* **Bucketed shapes.**  Each request lands in the smallest capacity bucket
  that fits ``prompt_len + max_new_tokens``.  State names encode the bucket,
  not the request, so every request in a bucket replays ONE compiled decode
  program through the global compile cache (``api.compile_cache_info()``
  shows hits climbing as requests are admitted).
* **Retire finished lanes.**  A lane stops consuming modeled cycles the step
  its request hits ``eos`` or its token budget — there is no lock-step tail.

Per step, each active request's cache handles are rebound to the bucket's
Executor and one compiled program runs on the host's functional simulator:
requests time-share the CRAM state region.  The modeled cost of every step
is aggregated from the backend's ``SimReport`` into
:attr:`ContinuousBatcher.stats` (tokens/sec, joules/token).

Tensors: the queries, new K/V rows and contexts are tensors on the
batcher's ``device`` (``"cuda"`` by default; it raises without a card);
each ``ResidentState.value`` stays the int64 CPU tensor it is.  The toy
model's int8 rows are made by numpy, as the JAX package makes them, and
handed over with ``torch.from_numpy``.
"""
from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import api
from repro_torch.serve.pimsab_step import (
    AttnServeConfig,
    decode_executor,
    kv_states,
    run_decode_step,
)

__all__ = [
    "PENDING",
    "ACTIVE",
    "RETIRED",
    "DEFAULT_BUCKETS",
    "ToyTokenModel",
    "ServeRequest",
    "ServeStats",
    "ContinuousBatcher",
]

PENDING = "PENDING"
ACTIVE = "ACTIVE"
RETIRED = "RETIRED"

# Bucket capacities are bounded by the softmax row scratch: a (1, T) score
# row lives in ONE lane (§V-C cross-field reduction), costing ~16-19
# wordlines per cached token, and the two reserved state regions take
# fields*prec rows each off the top of the 256-row CRAM.  At the default
# envelope the planner accepts KV residency up to T=4; T=8 compiles but
# declines residency (the cache streams through DRAM, see the N-PLAN
# notes); T>=12 has no feasible softmax distribution at all.
DEFAULT_BUCKETS: Tuple[int, ...] = (4, 8)


class ToyTokenModel:
    """Deterministic token <-> vector codec for driving the decode step.

    A real deployment surrounds the attention program with projection
    matmuls; this toy model replaces them with a hash-seeded int8 embedding
    so scheduler behavior (bucketing, preemption, exact resume) is testable
    in isolation.  Determinism matters: an evicted request re-embeds the
    same tokens to identical vectors, which is what makes preemption
    lossless.  Magnitudes stay inside the config's score envelope
    (``|q|<=7``, ``|k|<=15`` keeps ``D*7*15 < 2^(score_bits-1)`` for the
    default config).  The rows are drawn by numpy exactly as the JAX
    package draws them, so both packages embed every token alike.
    """

    def __init__(self, cfg: AttnServeConfig, vocab: Optional[int] = None):
        self.cfg = cfg
        self.vocab = int(vocab) if vocab is not None else cfg.value_dim

    def embed(self, token: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(q, k, v) int8 CPU rows of one token, stable across calls."""
        rng = np.random.default_rng(9973 * (int(token) % self.vocab) + 17)
        q = rng.integers(-7, 8, self.cfg.head_dim).astype(np.int8)
        k = rng.integers(-15, 16, self.cfg.head_dim).astype(np.int8)
        v = rng.integers(-100, 100, self.cfg.value_dim).astype(np.int8)
        return torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)

    def detok(self, context: Any) -> int:
        """Next token id from the (1, Dv) context vector: the argmax lane of
        a host copy, the first of equal maxima (numpy's rule)."""
        if isinstance(context, torch.Tensor):
            context = context.detach().cpu().numpy()
        return int(np.argmax(np.asarray(context).ravel())) % self.vocab


@dataclass
class ServeRequest:
    """One request's full scheduler lifecycle: PENDING -> ACTIVE -> RETIRED
    (possibly bouncing back to PENDING on preemption)."""

    rid: int
    prompt: List[int]
    max_new_tokens: int
    eos: int = -1  # token id that retires the request; -1 = "never" sentinel
    state: str = PENDING
    generated: List[int] = field(default_factory=list)
    capacity: int = 0
    pos: int = 0            # next free cache row
    k_state: object = None  # ResidentState handles — survive preemption
    v_state: object = None
    preemptions: int = 0

    def remaining(self) -> int:
        return self.max_new_tokens - len(self.generated)


@dataclass
class ServeStats:
    """Aggregated modeled cost of every decode step the batcher ran."""

    tokens: int = 0
    steps: int = 0
    modeled_seconds: float = 0.0
    energy_j: float = 0.0
    total_cycles: int = 0

    def tokens_per_sec(self) -> float:
        return self.tokens / self.modeled_seconds if self.modeled_seconds else 0.0

    def joules_per_token(self) -> float:
        return self.energy_j / self.tokens if self.tokens else 0.0


class ContinuousBatcher:
    """Admit/evict/retire scheduler driving bucketed pimsab decode programs.

    ``max_active`` bounds the lanes decoded per scheduler step; ``buckets``
    lists the KV capacities programs are compiled for (ascending).  Requests
    whose ``prompt + max_new_tokens`` exceed the largest bucket are rejected
    at submit time.  ``device`` is where the step's operands and contexts
    lie (``"cuda"`` by default, which raises without a card; ``"cpu"``
    when asked)."""

    def __init__(
        self,
        cfg: Optional[AttnServeConfig] = None,
        *,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        max_active: int = 4,
        backend: str = "pimsab",
        model: Optional[ToyTokenModel] = None,
        tune: Any = None,
        device: Any = "cuda",
    ):
        self.device = api.resolve_device(device)
        self.cfg = cfg or AttnServeConfig()
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.max_active = int(max_active)
        self.backend = backend
        self.tune = tune
        self.model = model or ToyTokenModel(self.cfg)
        self.pending: Deque[ServeRequest] = deque()
        self.active: List[ServeRequest] = []
        self.retired: List[ServeRequest] = []
        self.stats = ServeStats()
        self._rid = itertools.count()

    # -- request intake ----------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               eos: int = -1) -> ServeRequest:
        """Queue a request.  ``eos=-1`` (the default) never matches a token
        id, so decode runs to ``max_new_tokens``."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        need = len(prompt) + int(max_new_tokens)
        if need > self.buckets[-1]:
            raise ValueError(
                f"request needs {need} KV rows; largest bucket is "
                f"{self.buckets[-1]}"
            )
        r = ServeRequest(rid=next(self._rid), prompt=prompt,
                         max_new_tokens=int(max_new_tokens), eos=int(eos))
        self.pending.append(r)
        return r

    def _bucket_for(self, need: int) -> int:
        for b in self.buckets:
            if b >= need:
                return b
        raise ValueError(f"no bucket holds {need} rows")  # pre-checked

    # -- admission / preemption --------------------------------------------

    def _prefill(self, r: ServeRequest) -> None:
        """Host-seed the prompt's K/V rows into the parked cache value.

        Prefill stages through DRAM by design — the state seed phase streams
        ``.value`` in on the next bound execution; only the per-token decode
        appends are the CRAM-resident fast path."""
        for t in r.prompt:
            _, k, v = self.model.embed(t)
            r.k_state.value[r.pos] = k
            r.v_state.value[r.pos] = v
            r.pos += 1

    def _admit(self) -> None:
        while self.pending and len(self.active) < self.max_active:
            r = self.pending.popleft()
            if r.k_state is None:  # fresh request (not a preempted resume)
                r.capacity = self._bucket_for(len(r.prompt) + r.max_new_tokens)
                r.k_state, r.v_state = kv_states(self.cfg, r.capacity)
                self._prefill(r)
            r.state = ACTIVE
            self.active.append(r)

    def _preempt(self) -> None:
        """Shortest-job-first: when the lanes are full and a queued request
        is strictly shorter than the longest active one, swap them.  The
        evicted request keeps its state handles (cache parked in ``.value``)
        and resumes exactly."""
        if not self.pending or len(self.active) < self.max_active:
            return
        waiter = min(self.pending, key=lambda r: r.remaining())
        victim = max(self.active, key=lambda r: r.remaining())
        if waiter.remaining() < victim.remaining():
            self.active.remove(victim)
            victim.state = PENDING
            victim.preemptions += 1
            self.pending.appendleft(victim)

    # -- decode ------------------------------------------------------------

    def _last_token(self, r: ServeRequest) -> int:
        return r.generated[-1] if r.generated else r.prompt[-1]

    def _decode_one(self, r: ServeRequest) -> None:
        tok = self._last_token(r)
        q, k_new, v_new = (t.to(self.device) for t in self.model.embed(tok))
        # compile-cache hit for every request after the bucket's first;
        # the call also rebinds this request's cache handles
        ex = decode_executor(self.cfg, r.capacity, r.k_state, r.v_state,
                             backend=self.backend, tune=self.tune)
        ctx = run_decode_step(ex, self.cfg, r.capacity, q, k_new, v_new, r.pos)
        r.pos += 1
        rep = api.last_sim_report()
        if rep is not None:
            self.stats.modeled_seconds += float(rep.modeled_seconds)
            self.stats.energy_j += float(rep.energy_j)
            self.stats.total_cycles += int(rep.total_cycles)
        self.stats.steps += 1
        nxt = self.model.detok(ctx)
        r.generated.append(nxt)
        self.stats.tokens += 1
        if nxt == r.eos or r.remaining() <= 0 or r.pos >= r.capacity:
            r.state = RETIRED

    def step(self) -> bool:
        """One scheduler iteration: preempt, admit, decode every active lane,
        retire finished ones.  Returns False when no work remains."""
        self._preempt()
        self._admit()
        if not self.active:
            return bool(self.pending)
        for r in list(self.active):
            self._decode_one(r)
            if r.state == RETIRED:
                self.active.remove(r)
                self.retired.append(r)
        return bool(self.active or self.pending)

    def run(self) -> List[ServeRequest]:
        """Drive :meth:`step` until every submitted request retires."""
        while self.step():
            pass
        return self.retired

    def summary(self) -> Dict[str, float]:
        """Scalar stats for benchmarks: tokens, modeled tokens/sec, J/token."""
        return {
            "tokens": self.stats.tokens,
            "steps": self.stats.steps,
            "modeled_seconds": self.stats.modeled_seconds,
            "energy_j": self.stats.energy_j,
            "total_cycles": self.stats.total_cycles,
            "tokens_per_sec": self.stats.tokens_per_sec(),
            "joules_per_token": self.stats.joules_per_token(),
        }
