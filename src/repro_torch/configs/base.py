"""Architecture + shape configuration for the PIMSAB-framework reproduction.

Every assigned architecture is a :class:`ModelConfig`; every input-shape cell is
a :class:`ShapeCell`.  The dry-run, trainer, server and smoke tests all consume
these — there is exactly one source of truth for each (arch × shape) cell.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Quantization (the paper's bit-serial-aware computation, TPU-native form)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class QuantConfig:
    """Bit-plane / bit-slice quantization config (PIMSAB adaptive precision).

    ``act_bits``/``weight_bits`` choose the integer precision of the bit-plane
    matmul path; ``slice_bits`` is the hardware-native slice width (8 on the
    TPU int8 MXU path — the radix-256 analogue of PIMSAB's 1-bit PEs).
    ``skip_zero_slices`` statically skips all-zero weight slices, the
    ``mul_const`` zero-bit-skipping optimization.
    """

    enabled: bool = False
    act_bits: int = 8
    weight_bits: int = 8
    slice_bits: int = 8
    skip_zero_slices: bool = True

    @property
    def act_slices(self) -> int:
        return max(1, math.ceil(self.act_bits / self.slice_bits))

    @property
    def weight_slices(self) -> int:
        return max(1, math.ceil(self.weight_bits / self.slice_bits))


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    """A transformer-family architecture.

    ``block_pattern`` is the repeating unit of layer kinds; it is tiled to
    ``n_layers``.  Recognized kinds:

    * ``"attn"``        — full (causal for decoders) GQA attention block
    * ``"local_attn"``  — windowed attention block (``window`` tokens)
    * ``"rglru"``       — RG-LRU recurrent block (RecurrentGemma)
    * ``"mlstm"``       — xLSTM matrix-memory block
    * ``"slstm"``       — xLSTM scalar-memory block
    """

    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // n_heads
    qkv_bias: bool = False
    block_pattern: Tuple[str, ...] = ("attn",)
    window: int = 0  # local-attention window (tokens)
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    # --- encoder/decoder (whisper) ---
    n_enc_layers: int = 0  # >0 => encoder-decoder; n_layers is the decoder depth
    enc_seq_len: int = 1500  # whisper audio frames after conv frontend (stub)
    # --- modality frontend stubs ---
    frontend: Optional[str] = None  # "audio" | "vision"
    n_patches: int = 576  # vision stub: patch embeddings prepended to the prompt
    # --- misc ---
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # WSD (warmup-stable-decay) schedule flag — MiniCPM trains with it.
    wsd_schedule: bool = False
    # PIMSAB technique: bit-plane quantized matmuls for the big projections.
    quant: QuantConfig = field(default_factory=QuantConfig)
    # citation provenance [source; verified-tier]
    source: str = ""

    # ---- derived ----
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.resolved_head_dim

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def padded_vocab(self, multiple: int = 2048) -> int:
        """Vocab padded for clean TP sharding (MaxText practice)."""
        return ((self.vocab_size + multiple - 1) // multiple) * multiple

    @property
    def subquadratic(self) -> bool:
        """True if the arch never materializes full O(S^2) attention —
        required for the long_500k cell."""
        quadratic = {"attn"}
        return not any(k in quadratic for k in self.block_pattern)

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kinds, the pattern tiled to n_layers."""
        reps = -(-self.n_layers // len(self.block_pattern))
        return (self.block_pattern * reps)[: self.n_layers]

    def pattern_groups(self) -> int:
        """Number of scan groups (n_layers / pattern length)."""
        if self.n_layers % len(self.block_pattern) != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern length {len(self.block_pattern)}"
            )
        return self.n_layers // len(self.block_pattern)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, hd = self.d_model, self.resolved_head_dim
        n = 0
        n += self.vocab_size * d  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d  # lm head
        per_kind = {}
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.qkv_bias:
            attn += self.q_dim + 2 * self.kv_dim
        per_kind["attn"] = attn + 2 * d  # + norms
        per_kind["local_attn"] = per_kind["attn"]
        if self.is_moe:
            ffn = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
        else:
            ffn = 3 * d * self.d_ff  # gated SwiGLU
        # rglru block: in/out proj (d->2*rnn_w, rnn_w->d), conv, gates
        rnn_w = max(d, 1)
        per_kind["rglru"] = 2 * d * rnn_w + rnn_w * d + 4 * rnn_w + 2 * d
        # mlstm: up-proj x2 (factor 2), qkv in projected space, down-proj
        pf = 2 * d
        per_kind["mlstm"] = 2 * d * pf + 3 * pf * pf // max(1, self.n_heads) + pf * d + 2 * d
        per_kind["slstm"] = 4 * d * d + 4 * d * (d // max(1, self.n_heads)) + 2 * d
        for kind in self.layer_kinds():
            n += per_kind.get(kind, 0)
            if kind in ("attn", "local_attn") and self.d_ff > 0:
                n += ffn + d  # ffn norm
        enc_layers = self.n_enc_layers
        if enc_layers:
            n += enc_layers * (per_kind["attn"] + ffn + d)
            n += self.n_layers * (per_kind["attn"])  # cross-attention
        return n

    def active_param_count(self) -> int:
        """Params touched per token (== param_count for dense)."""
        if not self.is_moe:
            return self.param_count()
        dense = self.param_count()
        all_experts = self.n_layers * self.n_experts * 3 * self.d_model * self.d_ff
        active = self.n_layers * self.experts_per_token * 3 * self.d_model * self.d_ff
        return dense - all_experts + active


MLA_KINDS = ("mla", "mla_moe")


def mla_moe_pattern(n_layers: int, first_k_dense: int) -> Tuple[str, ...]:
    """The layer kinds of a DeepSeek-V3-architecture decoder, one pattern
    group: ``first_k_dense`` latent-attention layers with a dense SwiGLU
    (``"mla"``), then latent-attention layers with routed and shared experts
    (``"mla_moe"``)."""
    return ("mla",) * first_k_dense + ("mla_moe",) * (n_layers - first_k_dense)


@dataclass(frozen=True)
class MLAMoEConfig(ModelConfig):
    """A DeepSeek-V3-architecture decoder (arXiv:2405.04434, 2412.19437):
    multi-head latent attention in every layer and, past the leading dense
    layers, sigmoid-routed experts beside shared ones.  The fields
    :class:`ModelConfig` lacks sit here, so that the registered configs and
    their ``repr`` stay the JAX package's.

    Attention: ``wq`` gives each head ``qk_nope_head_dim +
    qk_rope_head_dim`` (``q_lora_rank`` null: no query compression);
    ``wkv_a`` gives a latent of ``kv_lora_rank`` (RMSNorm'd, the decode
    cache keeps it) and a ``qk_rope_head_dim`` key part that every head
    shares (RoPE'd, cached too); ``wkv_b`` expands the latent into each
    head's key part and its value of ``v_head_dim``.  ``head_dim`` is the
    query and key head, ``d_ff`` the dense layers' width.

    Experts: ``n_experts`` routed of width ``moe_d_ff``,
    ``experts_per_token`` chosen by sigmoid score plus a selection bias
    (``noaux_tc`` with ``n_group`` = ``topk_group`` = 1), weighted by their
    scores normalised over the chosen (``norm_topk_prob``) times
    ``routed_scaling_factor``; ``n_shared_experts`` always-on experts, one
    SwiGLU of width ``n_shared_experts * moe_d_ff``.  Routing is dropless:
    ``moe_capacity_factor`` is not read.  The embedding is not scaled."""

    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = True
    scoring_func: str = "sigmoid"
    n_group: int = 1
    topk_group: int = 1

    def param_count(self) -> int:
        d, h, e = self.d_model, self.n_heads, self.n_experts
        qk = self.qk_nope_head_dim + self.qk_rope_head_dim
        attn = (d * h * qk + d * (self.kv_lora_rank + self.qk_rope_head_dim) + self.kv_lora_rank
                + self.kv_lora_rank * h * (self.qk_nope_head_dim + self.v_head_dim) + h * self.v_head_dim * d)
        dense = 3 * d * self.d_ff
        moe = d * e + e + e * 3 * d * self.moe_d_ff + 3 * d * self.n_shared_experts * self.moe_d_ff
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2) + d
        for kind in self.layer_kinds():
            n += attn + 2 * d + (dense if kind == "mla" else moe)
        return n

    def active_param_count(self) -> int:
        idle = (self.n_experts - self.experts_per_token) * 3 * self.d_model * self.moe_d_ff
        return self.param_count() - idle * self.layer_kinds().count("mla_moe")


# ---------------------------------------------------------------------------
# Input-shape cells
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", "train", 4_096, 256),
    ShapeCell("prefill_32k", "prefill", 32_768, 32),
    ShapeCell("decode_32k", "decode", 32_768, 128),
    ShapeCell("long_500k", "decode", 524_288, 1),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def cell_supported(cfg: ModelConfig, cell: ShapeCell) -> Tuple[bool, str]:
    """(supported, reason).  long_500k needs sub-quadratic attention."""
    if cell.name == "long_500k" and not cfg.subquadratic:
        return False, "skipped(full-attention): 500k dense-KV decode is not run for pure full-attention archs"
    return True, "ok"
