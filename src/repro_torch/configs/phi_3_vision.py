"""Phi-3-Vision-4.2B — phi3-mini backbone + CLIP frontend STUB
[hf:microsoft/Phi-3-vision-128k-instruct; hf].

input_specs() provides precomputed patch embeddings (batch, 576, d_model);
they are fused into the first prompt positions.
"""
from repro_torch.configs.base import ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    block_pattern=("attn",),
    frontend="vision",
    n_patches=576,
    quant=QuantConfig(enabled=True, act_bits=8, weight_bits=8),
    source="[hf:microsoft/Phi-3-vision-128k-instruct; hf]",
)
