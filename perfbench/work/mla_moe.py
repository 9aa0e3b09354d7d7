"""Work of a DeepSeek-V3-architecture decoder (latent attention, routed and
shared experts) served with bit-sliced int8 linears, from its
configuration's shapes alone.

K4 (the port's bit-sliced GEMM) runs every quantized linear but the routed
experts: per layer ``wq``, ``wkv_a``, ``wkv_b`` and ``wo``, then the dense
SwiGLU (the first ``first_k_dense_replace`` layers) or the shared experts'
SwiGLU; and the untied head on the last position.  K4G (its grouped path)
runs the routed experts: per expert layer one call for gate and up side by
side and one for down, over every routed pair's row (each slot of the
batch, padding included, times ``num_experts_per_tok``) and the weights of
all ``n_routed_experts``.  A call's least time is the larger of its
operations (2 · rows · K · N) at the int8 tensor-core peak and its bytes
(the int8 rows and weights once, the int32 output once) at the memory's.

The useful work (``mfu.moe``) counts real tokens only: every linear's
multiply-adds a token uses (its routed experts' and the shared ones', not
the idle experts') at the int8 peak, causal attention (q·Kᵀ at the query and
key head, p·V at the value head, over the lower triangle) at the bf16 peak,
and the head on the last position at the int8 peak.  The router's float32
product (2 · d · E a token, 0.01% of the rest) is not counted.
"""
from __future__ import annotations

from typing import Iterable, List, Tuple

from perfbench.work import peaks
from perfbench.work.transformer import k4_call_least_s


def attention_linears(cfg: dict) -> List[Tuple[int, int]]:
    """(K, N) of ``wq``, ``wkv_a``, ``wkv_b`` and ``wo`` (no query latent)."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rp, v, r = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    if cfg.get("q_lora_rank") is not None:
        raise NotImplementedError("a query latent (q_lora_rank) is not counted")
    return [(d, h * (nope + rp)), (d, r + rp), (r, h * (nope + v)), (h * v, d)]


def swiglu_linears(d: int, f: int) -> List[Tuple[int, int]]:
    return [(d, f), (d, f), (f, d)]


def k4_layer_linears(cfg: dict, dense: bool) -> List[Tuple[int, int]]:
    """(K, N) of each K4 call of one layer: a dense one, or an expert layer's
    (the shared experts: one SwiGLU of their summed width)."""
    d = cfg["hidden_size"]
    f = cfg["intermediate_size"] if dense else cfg["n_shared_experts"] * cfg["moe_intermediate_size"]
    return attention_linears(cfg) + swiglu_linears(d, f)


def expert_layers(cfg: dict) -> int:
    return cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]


def k4_least_s(cfg: dict, batch: int, padded_len: int) -> float:
    """K4's least time for one prefill of ``batch`` rows of ``padded_len``."""
    m, dense = batch * padded_len, cfg["first_k_dense_replace"]
    t = dense * sum(k4_call_least_s(cfg, m, k, n) for k, n in k4_layer_linears(cfg, True))
    t += expert_layers(cfg) * sum(k4_call_least_s(cfg, m, k, n) for k, n in k4_layer_linears(cfg, False))
    return t + k4_call_least_s(cfg, batch, cfg["hidden_size"], cfg["vocab_size"])


def k4g_call_least_s(rows: int, k: int, n: int, groups: int) -> float:
    """One grouped call's least time: ``rows`` int8 rows and ``groups``
    int8 (K, N) weights read once, the int32 output written once."""
    ops = 2 * rows * k * n
    nbytes = rows * k + groups * k * n + 4 * rows * n
    return max(ops / peaks.INT8_OPS_PER_S, nbytes / peaks.HBM_BYTES_PER_S)


def k4g_calls(cfg: dict, slots: int) -> List[Tuple[int, int, int, int]]:
    """(rows, K, N, groups) of the two grouped calls of one expert layer
    over ``slots`` token slots."""
    d, f, e = cfg["hidden_size"], cfg["moe_intermediate_size"], cfg["n_routed_experts"]
    rows = slots * cfg["num_experts_per_tok"]
    return [(rows, d, 2 * f, e), (rows, f, d, e)]


def k4g_least_s(cfg: dict, batch: int, padded_len: int) -> float:
    """K4G's least time for one prefill of ``batch`` rows of ``padded_len``."""
    return expert_layers(cfg) * sum(k4g_call_least_s(*c) for c in k4g_calls(cfg, batch * padded_len))


def token_macs(cfg: dict) -> int:
    """Multiply-adds of the linears a token goes through (the head apart)."""
    d, k = cfg["hidden_size"], cfg["num_experts_per_tok"]
    dense = sum(a * b for a, b in k4_layer_linears(cfg, True))
    expert = sum(a * b for a, b in k4_layer_linears(cfg, False))
    expert += k * sum(a * b for a, b in swiglu_linears(d, cfg["moe_intermediate_size"]))
    return cfg["first_k_dense_replace"] * dense + expert_layers(cfg) * expert


def useful_least_s(cfg: dict, lengths: Iterable[int]) -> float:
    """The useful work of prefilling prompts of ``lengths`` real tokens, each
    kind at its peak."""
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    attn = cfg["num_hidden_layers"] * 2 * (qk + cfg["v_head_dim"]) * cfg["num_attention_heads"]
    head = 2 * cfg["hidden_size"] * cfg["vocab_size"]
    int8 = bf16 = 0.0
    for length in lengths:
        int8 += 2 * token_macs(cfg) * length + head
        bf16 += attn * length * (length + 1) / 2
    return int8 / peaks.INT8_OPS_PER_S + bf16 / peaks.BF16_FLOPS_PER_S
