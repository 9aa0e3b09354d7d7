"""Serving engine of the PyTorch port: prefill and decode step builders and
the batched request loop (the JAX package's ``serve/engine.py``).

The serving path runs bit-sliced int8 weights (``maybe_quantize_tree``):
every quantized linear of a step launches the bit-sliced GEMM, and under
``RunFlags.quant_kv`` the int8 attention scores launch the row-dot kernel.

The steps are cached **once per signature** in the kernel API's global
compile cache (``program.cached_executable``) under the JAX package's keys:
a second :class:`ServeEngine` with the same (config, flags, backend,
max_len) reuses the step callables, which ``api.compile_cache_info()``
shows as hits.  The port has no jit, so the cached artifact is the step
callable itself.

``backend=`` takes the JAX package's names.  JAX's int8 serving path calls
no registry kernel, so its ``use_backend`` scope changes nothing there; the
port's steps behave the same: ``"pimsab"`` enters the port's pimsab scope,
which the step's own kernel calls leave (they run on their operands'
device, as JAX runs these contractions outside the registry), and
``"xla"``, ``"pallas"`` and ``"interpret"``, the JAX package's device
backends, enter no scope.  Any other name raises ``ValueError`` when a step
runs, as JAX's does when it traces one.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import MeshRules, P, cache_entry_spec
from repro_torch.kernels import api
from repro_torch.kernels.program import cached_executable
from repro_torch.models.common import dtype_of, maybe_quantize_tree
from repro_torch.models.runtime import DEFAULT_FLAGS, RunFlags
from repro_torch.models.transformer import cache_shape, decode_step, init_params, prefill

# the JAX package's kernel backends (repro.kernels.api.BACKENDS)
JAX_BACKENDS = ("pallas", "interpret", "xla", "pimsab")


def _backend_scope(backend: Optional[str]):
    if backend is None:
        return contextlib.nullcontext()
    if backend not in JAX_BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {JAX_BACKENDS}")
    return api.use_backend(backend) if backend == "pimsab" else contextlib.nullcontext()


def serve_params_shape(cfg: ModelConfig, flags: RunFlags = DEFAULT_FLAGS):
    """The (possibly quantized) serving parameters on the ``meta`` device."""
    p = init_params(cfg, device="meta")
    return maybe_quantize_tree(p, cfg) if flags.quant_serve else p


def cache_specs(cfg: ModelConfig, batch: int, max_len: int, rules: MeshRules, flags: RunFlags = DEFAULT_FLAGS):
    """The decode cache's spec tree (``pos`` a scalar; every block leaf its
    entry's spec behind the unsharded group axis), in the JAX package's
    order of leaves."""
    shapes = cache_shape(cfg, batch, max_len, flags)

    def visit(node):
        if isinstance(node, dict):
            return {k: visit(node[k]) for k in sorted(node)}
        if node.ndim == 0:
            return P()
        # leading dim is the scan-group axis; entry rules apply to the rest
        inner = cache_entry_spec(tuple(node.shape[1:]), cfg, rules, seq_shard_kv=flags.seq_shard_kv)
        return P(None, *inner)

    return {"pos": P(), "blocks": visit(shapes["blocks"])}


def make_prefill_step(cfg, flags=DEFAULT_FLAGS, rules=None, max_len=None, backend=None) -> Callable:
    """``step(params, batch) -> (cache, logits)``.  Under ``rules`` every
    rank calls it with the global batch: it runs its rows and returns its
    cache shard (:func:`cache_specs`) and the global logits."""

    def step(params, batch):
        with _backend_scope(backend):
            return prefill(params, cfg, batch, flags, rules, max_len=max_len)

    return step


def make_decode_step(cfg, flags=DEFAULT_FLAGS, rules=None, backend=None) -> Callable:
    """``step(params, cache, tokens) -> (cache, logits)``; under ``rules``
    the tokens are the global batch's and the cache this rank's shard."""

    def step(params, cache, tokens):
        with _backend_scope(backend):
            return decode_step(params, cfg, cache, tokens, flags, rules)

    return step


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int
    generated: List[int] = field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Static-batch engine: pads prompts to a bucket, prefills, then decodes
    all requests in lock-step, retiring finished ones (continuous batching at
    iteration granularity).  It runs on the device of ``params``."""

    def __init__(self, cfg: ModelConfig, params, flags: RunFlags = DEFAULT_FLAGS, max_len: int = 512,
                 eos: int = -1, backend: Optional[str] = None):
        """``eos`` is the token id that retires a request the moment it is
        generated; the default ``-1`` never matches (decode stops only at
        ``max_new_tokens``).  Retired lanes keep their batch slot, but their
        token feed is masked to the pad id 0 so the cache never ingests
        post-eos garbage."""
        self.cfg, self.flags, self.max_len, self.eos = cfg, flags, max_len, eos
        self.backend = backend
        self.params = maybe_quantize_tree(params, cfg) if flags.quant_serve else params
        self.device = params["embed"]["w"].device
        self._prefill = cached_executable(
            ("serve_step", "prefill", repr(cfg), repr(flags), backend, max_len),
            lambda: make_prefill_step(cfg, flags, max_len=max_len, backend=backend),
        )
        self._decode = cached_executable(
            ("serve_step", "decode", repr(cfg), repr(flags), backend),
            lambda: make_decode_step(cfg, flags, backend=backend),
        )

    def prompt_batch(self, requests: List[Request]) -> dict:
        """The prefill batch of ``requests``: prompts left-padded with 0 to
        the longest (at least 8), plus zero patch embeddings for a vision
        config and zero frame embeddings (B, enc_seq_len, d) for an
        encoder–decoder one.  Counts the ``tokens`` slots
        (``serve.prompt_slots``) and those that are padding
        (``serve.padding_slots``) in :mod:`repro_torch.obs`."""
        b = len(requests)
        s = max(max(len(r.prompt) for r in requests), 8)
        toks = np.zeros((b, s), np.int32)
        for i, r in enumerate(requests):
            toks[i, s - len(r.prompt):] = r.prompt  # left-pad
        obs.count("serve.prompt_slots", b * s)
        obs.count("serve.padding_slots", b * s - sum(len(r.prompt) for r in requests))
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        if self.cfg.frontend == "vision":
            batch["patch_embeds"] = torch.zeros((b, self.cfg.n_patches, self.cfg.d_model),
                                                dtype=dtype_of(self.cfg), device=self.device)
        if self.cfg.is_encdec:
            batch["enc_embeds"] = torch.zeros((b, self.cfg.enc_seq_len, self.cfg.d_model),
                                              dtype=dtype_of(self.cfg), device=self.device)
        return batch

    def run(self, requests: List[Request]) -> List[Request]:
        """Serve ``requests`` to the end: prefill them as one batch, then
        decode in lock-step until each has its ``max_new_tokens`` or its
        ``eos``; their tokens go to ``generated``.

        With span recording on (:mod:`repro_torch.obs`, off by default) a
        run records ``serve.run`` (ids: ``requests``, the request ids)
        around ``serve.prompt_batch``, ``serve.prefill``, each
        ``serve.decode`` step and each ``serve.sample`` (argmax and the
        tokens' read-back): the end of the first ``serve.sample`` is when
        every request's first token is on the host."""
        run = obs.call("serve.run", requests=tuple(r.rid for r in requests)) if obs.recording() else obs.NULL
        with torch.no_grad(), run:
            with obs.span("serve.prompt_batch"):
                batch = self.prompt_batch(requests)
            with obs.span("serve.prefill"):
                cache, logits = self._prefill(self.params, batch)
            steps = max(r.max_new_tokens for r in requests)
            with obs.span("serve.sample"):
                next_tok = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
            for _ in range(steps):
                for i, r in enumerate(requests):
                    if not r.done:
                        t = int(next_tok[i])
                        r.generated.append(t)
                        if t == self.eos or len(r.generated) >= r.max_new_tokens:
                            r.done = True
                    if r.done:
                        # retired lane: feed the pad id so the lock-step cache stays clean
                        next_tok[i] = 0
                if all(r.done for r in requests):
                    break
                with obs.span("serve.decode"):
                    tokens = torch.from_numpy(next_tok).to(self.device)[:, None]
                    cache, logits = self._decode(self.params, cache, tokens)
                with obs.span("serve.sample"):
                    next_tok = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        return requests
