"""xLSTM-1.3B — alternating mLSTM/sLSTM blocks [arXiv:2405.04517; unverified].

d_ff=0: blocks carry their own projections (mLSTM pre-up-projection ×2,
sLSTM post-up gated FFN).  Sub-quadratic: runs the long_500k cell.
"""
from repro_torch.configs.base import ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "slstm", "mlstm"),
    quant=QuantConfig(enabled=True, act_bits=8, weight_bits=8),
    source="[arXiv:2405.04517; unverified]",
)
