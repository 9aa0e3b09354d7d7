"""RecurrentGemma-2B — RG-LRU + local attention, 2:1 pattern [arXiv:2402.19427; hf].

Pattern is (rglru, rglru, local_attn) repeated; window 2048.  Sub-quadratic:
runs the long_500k cell.
"""
from repro_torch.configs.base import ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,  # 26 residual blocks; pattern padded below
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    # 26 = 8 full patterns of 3 + (rglru, rglru); we express the official
    # layout with a length-13 half-pattern repeated twice.
    block_pattern=("rglru", "rglru", "local_attn") * 4 + ("rglru",),
    window=2048,
    tie_embeddings=True,
    quant=QuantConfig(enabled=True, act_bits=8, weight_bits=8),
    source="[arXiv:2402.19427; hf]",
)
