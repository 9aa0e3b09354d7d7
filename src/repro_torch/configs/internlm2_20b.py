"""InternLM2-20B — dense GQA transformer [arXiv:2403.17297; hf]."""
from repro_torch.configs.base import ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92544,
    block_pattern=("attn",),
    rope_theta=1_000_000.0,
    quant=QuantConfig(enabled=True, act_bits=8, weight_bits=8),
    source="[arXiv:2403.17297; hf]",
)
