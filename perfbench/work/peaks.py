"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense rates,
no sparsity; at the full 700 W power limit).  Frozen here, so that no change
to the program moves the yardstick."""

INT8_OPS_PER_S = 1979e12     # int8 tensor cores, dense
BF16_FLOPS_PER_S = 989e12    # bf16 / fp16 tensor cores, dense
HBM_BYTES_PER_S = 3.35e12
