"""Qwen2-0.5B — dense GQA with QKV bias [arXiv:2407.10671; hf]."""
from repro_torch.configs.base import ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    block_pattern=("attn",),
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    quant=QuantConfig(enabled=True, act_bits=8, weight_bits=8),
    source="[arXiv:2407.10671; hf]",
)
