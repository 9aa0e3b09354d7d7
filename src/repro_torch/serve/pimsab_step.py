"""Integer attention decode programs (the port of the JAX package's
``serve/pimsab_step.py``).

One decode step appends the new token's quantized K/V rows to the caches,
scores the query against every cached key (q·Kᵀ), runs the bit-exact
fixed-point softmax and mixes the values (p·V with the ``SOFTMAX_F``
renormalizing shift): five registry kernels traced into one
:class:`~repro_torch.kernels.program.Program`.

Programs are traced per bucket ``(config, capacity)`` and cached, so every
request of a bucket compiles to one shared Executor (``api.compile`` hits).
The caches enter as plain slots 0 and 1; the step returns only the context,
so a caller carries each cache from step to step itself, e.g. with
``api.kv_append`` at the same selector.  On the pimsab backend the caches
bind as :class:`~repro_torch.kernels.program.ResidentState` handles instead
(``api.compile(decode_program(cfg, capacity), "pimsab", states={0: k, 1:
v})`` with :func:`kv_states`), kept CRAM-resident across steps:
:func:`decode_executor` compiles (or cache-hits) that Executor and binds a
request's handles, :func:`run_decode_step` runs one bound step.

Weights and caches are slots, not parameters: hand both packages the same
arrays (``torch.from_numpy``); a ``ResidentState.value`` becomes a slot
through ``to_array()``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.kernels import api
from repro_torch.kernels.program import Executor, Program, ResidentState


@dataclass(frozen=True)
class AttnServeConfig:
    """Static shape/precision envelope of the served attention head.

    ``score_bits``/``score_frac`` are the caller's quantization contract:
    every q·k score must fit ``score_bits`` signed bits and is interpreted
    with ``score_frac`` fraction bits by the fixed-point softmax.  The
    defaults hold whenever ``head_dim · 2^(q_bits-1) · 2^(kv_bits-1) <
    2^(score_bits-1)`` — size them from the quantizer's worst case.
    """

    head_dim: int = 4      # D — K rows and queries
    value_dim: int = 4     # Dv — V rows and the context output
    kv_bits: int = 8       # cache precision (int8 quantized K/V)
    q_bits: int = 4        # query magnitude envelope
    score_bits: int = 10   # q·k score envelope
    score_frac: int = 7    # fraction bits the softmax reads scores at

    def state_rows(self) -> int:
        """Wordlines the two cache regions reserve on the simulated
        machine's state tile."""
        return (self.head_dim + self.value_dim) * self.kv_bits


def kv_states(cfg: AttnServeConfig, capacity: int) -> Tuple[ResidentState, ResidentState]:
    """Fresh per-request K/V cache handles for one bucket.

    Names encode the bucket, not the request, so spec-identical handles
    share one compiled executor."""
    tag = f"{capacity}x{cfg.head_dim}v{cfg.value_dim}p{cfg.kv_bits}"
    return (
        ResidentState(f"kcache_{tag}", (capacity, cfg.head_dim), cfg.kv_bits),
        ResidentState(f"vcache_{tag}", (capacity, cfg.value_dim), cfg.kv_bits),
    )


_program_cache: Dict[Tuple[AttnServeConfig, int], Program] = {}


def decode_program(cfg: AttnServeConfig, capacity: int) -> Program:
    """The traced decode-step Program of one bucket (cached per bucket).

    Slot order: ``(kc, vc, q, k_new, v_new, onehot)``: the K and V caches
    ``(capacity, D)`` / ``(capacity, Dv)`` int8, the query ``(1, D)``, the
    new rows ``(D,)`` / ``(Dv,)`` and the ``(capacity,)`` row selector, all
    int8.  Returns the ``(1, Dv)`` int32 context."""
    key = (cfg, int(capacity))
    prog = _program_cache.get(key)
    if prog is not None:
        return prog

    def step(kc, vc, q, k_new, v_new, onehot):
        kc2 = api.kv_append(kc, k_new, onehot)
        vc2 = api.kv_append(vc, v_new, onehot)
        s = api.attention_qk(q, kc2, q_bits=cfg.q_bits, out_bits=cfg.score_bits)
        p = api.softmax_fixedpoint(s, in_frac=cfg.score_frac)
        return api.attention_pv(p, vc2)

    kst, vst = kv_states(cfg, capacity)
    traced = api.trace(step, name=f"decode_{capacity}x{cfg.head_dim}")
    prog = traced.trace(
        kst.placeholder(), vst.placeholder(),
        torch.zeros((1, cfg.head_dim), dtype=torch.int8),
        torch.zeros(cfg.head_dim, dtype=torch.int8),
        torch.zeros(cfg.value_dim, dtype=torch.int8),
        torch.zeros(capacity, dtype=torch.int8),
    )
    _program_cache[key] = prog
    return prog


def decode_layer_program(model_dim: int = 256, head_dim: int = 16,
                         ff_dim: int = 512, capacity: int = 8, *,
                         q_bits: int = 3, kv_bits: int = 3,
                         score_bits: int = 10, score_frac: int = 7,
                         w_bits: int = 4) -> Program:
    """One full transformer decode layer as a stateless traced Program.

    Attention (q·Kᵀ → fixed-point softmax → p·V) followed by the output
    projection and a two-layer ReLU FFN, all on the integer GEMM.  Slots:
    ``(kc, vc, q, wo, w1, w2)``, all int8: the caches ``(capacity,
    head_dim)``, the query ``(1, head_dim)``, ``wo (head_dim, model_dim)``,
    ``w1 (model_dim, ff_dim)``, ``w2 (ff_dim, model_dim)``; returns the
    ``(1, model_dim)`` int32 output (int32 wraps).

    ``score_bits`` must hold the worst-case q·k dot:
    ``head_dim · 2^(q_bits-1) · 2^(kv_bits-1) < 2^(score_bits-1)``."""

    def layer(kc, vc, q, wo, w1, w2):
        s = api.attention_qk(q, kc, q_bits=q_bits, k_bits=kv_bits,
                             out_bits=score_bits)
        p = api.softmax_fixedpoint(s, in_frac=score_frac)
        ctx = api.attention_pv(p, vc)
        h = api.int_matmul(ctx, wo, w_bits=w_bits)
        f = api.relu(api.int_matmul(h, w1, w_bits=w_bits))
        return api.int_matmul(f, w2, w_bits=w_bits)

    traced = api.trace(layer, name=f"decode_layer_{capacity}x{model_dim}")
    return traced.trace(
        torch.zeros((capacity, head_dim), dtype=torch.int8),
        torch.zeros((capacity, head_dim), dtype=torch.int8),
        torch.zeros((1, head_dim), dtype=torch.int8),
        torch.zeros((head_dim, model_dim), dtype=torch.int8),
        torch.zeros((model_dim, ff_dim), dtype=torch.int8),
        torch.zeros((ff_dim, model_dim), dtype=torch.int8),
    )


def decode_executor(cfg: AttnServeConfig, capacity: int,
                    k_state: ResidentState, v_state: ResidentState,
                    backend: str = "pimsab", tune: Any = None) -> Executor:
    """Compile (or cache-hit) the bucket's decode step on ``backend`` and
    bind the given request's cache handles.  Spec-identical handles hit the
    same cached Executor (``api.compile_cache_info()``).

    ``tune`` opts the bucket's timing plan into the mapping autotuner (as
    ``api.compile`` takes it): the search runs once per (cfg, capacity)
    bucket and every request decoding in that bucket replays the tuned
    schedule."""
    return api.compile(
        decode_program(cfg, capacity), backend,
        states={0: k_state, 1: v_state},
        tune=tune,
    )


def run_decode_step(ex: Executor, cfg: AttnServeConfig, capacity: int,
                    q: Any, k_new: Any, v_new: Any, pos: int) -> torch.Tensor:
    """Execute one bound decode step: append at row ``pos`` and return the
    ``(1, Dv)`` int32 context, on the device ``q`` lies on.  The one-hot
    selector and the caches' placeholders are made there too (the bound
    handles, not the placeholders, hold the caches)."""
    q = torch.as_tensor(q, dtype=torch.int8)
    dev = q.device
    onehot = torch.zeros(capacity, dtype=torch.int8, device=dev)
    onehot[pos] = 1
    ph_k = torch.zeros((capacity, cfg.head_dim), dtype=torch.int8, device=dev)
    ph_v = torch.zeros((capacity, cfg.value_dim), dtype=torch.int8, device=dev)
    return ex(
        ph_k, ph_v,
        q.reshape(1, cfg.head_dim),
        torch.as_tensor(k_new, dtype=torch.int8, device=dev),
        torch.as_tensor(v_new, dtype=torch.int8, device=dev),
        onehot,
    )
