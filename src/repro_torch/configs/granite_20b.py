"""Granite-20B (code) — llama-arch, MQA (kv=1) [arXiv:2405.04324; hf]."""
from repro_torch.configs.base import ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    block_pattern=("attn",),
    quant=QuantConfig(enabled=True, act_bits=8, weight_bits=8),
    source="[arXiv:2405.04324; hf]",
)
