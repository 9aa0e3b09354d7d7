"""Work of a dense decoder served with bit-sliced int8 linears, from its
configuration's shapes alone.

K4 (the port's bit-sliced GEMM) runs every quantized linear: per layer the
q, k, v and o projections and the SwiGLU FFN's gate, up and down; and the
head where it is not tied to the embedding.  Its least time for an
``(M, K) × (K, N)`` call is the larger of its operations, 2 · M · N · K for
every slice pair the precision needs (a pair whose shift reaches 32 bits
adds nothing mod 2**32), at the int8 tensor-core peak, and its bytes: each
int8 slice of the activations and the weights once and the int32 output
once.  M counts every row the kernel is handed, padding included.

The model's useful work (``mfu.llm``) counts real tokens only: the linears'
2 · multiply-adds at the int8 peak, causal attention (q·Kᵀ and p·V over the
lower triangle) and the tied head on the last position at the bf16 peak.
"""
from __future__ import annotations

import math
from typing import Iterable, List, Tuple

from perfbench.work import peaks


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]


def layer_linears(cfg: dict) -> List[Tuple[int, int]]:
    """(K, N) of each quantized linear of one layer."""
    d, f, hd = cfg["hidden_size"], cfg["intermediate_size"], head_dim(cfg)
    q, kv = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    return [(d, q), (d, kv), (d, kv), (q, d), (d, f), (d, f), (f, d)]


def slices(bits: int, slice_bits: int) -> int:
    return max(1, math.ceil(bits / slice_bits))


def live_pairs(cfg: dict) -> Tuple[int, int, int]:
    """(pairs, activation slices read, weight slices read) that K4 computes."""
    q = cfg["quant"]
    sb = q["slice_bits"]
    live = [(s, t) for s in range(slices(q["act_bits"], sb)) for t in range(slices(q["weight_bits"], sb))
            if sb * (s + t) < 32]
    return len(live), len({s for s, _ in live}), len({t for _, t in live})


def k4_call_least_s(cfg: dict, m: int, k: int, n: int) -> float:
    pairs, nx, nw = live_pairs(cfg)
    ops = 2 * m * n * k * pairs
    nbytes = nx * m * k + nw * k * n + 4 * m * n
    return max(ops / peaks.INT8_OPS_PER_S, nbytes / peaks.HBM_BYTES_PER_S)


def k4_least_s(cfg: dict, batch: int, padded_len: int) -> float:
    """K4's least time for one prefill of ``batch`` rows of ``padded_len``."""
    m = batch * padded_len
    t = cfg["num_hidden_layers"] * sum(k4_call_least_s(cfg, m, k, n) for k, n in layer_linears(cfg))
    if not cfg["tie_word_embeddings"]:
        t += k4_call_least_s(cfg, batch, cfg["hidden_size"], padded_vocab(cfg))
    return t


def padded_vocab(cfg: dict, multiple: int = 2048) -> int:
    return -(-cfg["vocab_size"] // multiple) * multiple


def useful_least_s(cfg: dict, lengths: Iterable[int]) -> float:
    """The useful work of prefilling prompts of ``lengths`` real tokens, each
    kind at its peak."""
    lin_macs = cfg["num_hidden_layers"] * sum(k * n for k, n in layer_linears(cfg))
    attn = cfg["num_hidden_layers"] * 4 * head_dim(cfg) * cfg["num_attention_heads"]
    head = 2 * cfg["hidden_size"] * cfg["vocab_size"]
    int8 = bf16 = 0.0
    for length in lengths:
        int8 += 2 * lin_macs * length
        bf16 += attn * length * (length + 1) / 2
        if cfg["tie_word_embeddings"]:
            bf16 += head
        else:
            int8 += head
    return int8 / peaks.INT8_OPS_PER_S + bf16 / peaks.BF16_FLOPS_PER_S
