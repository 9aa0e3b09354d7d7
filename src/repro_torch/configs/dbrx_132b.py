"""DBRX-132B — 16-expert top-4 fine-grained MoE [hf:databricks/dbrx-base; unverified]."""
from repro_torch.configs.base import ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    block_pattern=("attn",),
    n_experts=16,
    experts_per_token=4,
    moe_capacity_factor=1.25,
    rope_theta=500_000.0,
    quant=QuantConfig(enabled=True, act_bits=8, weight_bits=8),
    source="[hf:databricks/dbrx-base; unverified]",
)
