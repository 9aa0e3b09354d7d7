"""MiniCPM-2B — llama-like dense (MHA: kv=36), WSD schedule [arXiv:2404.06395; hf]."""
from repro_torch.configs.base import ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    block_pattern=("attn",),
    tie_embeddings=True,
    wsd_schedule=True,
    quant=QuantConfig(enabled=True, act_bits=8, weight_bits=8),
    source="[arXiv:2404.06395; hf]",
)
