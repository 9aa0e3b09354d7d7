"""Kimi-K2 1T-A32B — trillion-parameter MoE, 384 experts top-8 [arXiv:2501.kimi2; unverified].

Assignment specifies GQA kv=8 and per-expert d_ff=2048 (fine-grained experts).
"""
from repro_torch.configs.base import ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    block_pattern=("attn",),
    n_experts=384,
    experts_per_token=8,
    moe_capacity_factor=1.25,
    quant=QuantConfig(enabled=True, act_bits=8, weight_bits=8),
    source="[arXiv:2501.kimi2; unverified]",
)
