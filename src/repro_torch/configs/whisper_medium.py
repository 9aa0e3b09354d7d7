"""Whisper-medium — encoder-decoder audio backbone [arXiv:2212.04356; unverified].

24 encoder + 24 decoder layers; the conv frontend is a STUB — input_specs()
supplies precomputed (batch, 1500, d_model) frame embeddings.
"""
from repro_torch.configs.base import ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,  # decoder depth
    n_enc_layers=24,
    enc_seq_len=1500,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    block_pattern=("attn",),
    frontend="audio",
    quant=QuantConfig(enabled=True, act_bits=8, weight_bits=8),
    source="[arXiv:2212.04356; unverified]",
)
