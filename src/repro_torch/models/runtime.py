"""Runtime flags: knobs that change the *schedule*, not the architecture.

These are the levers the §Perf hillclimb turns: attention chunking/scheduling,
remat policy, quantized serving, MoE routing-group count.  They are orthogonal
to ModelConfig (which fixes the math) — the same arch can be lowered under
different RunFlags and compared in the roofline.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RunFlags:
    # attention
    attn_chunk: int = 1024          # kv/q chunk for flash-style attention
    triangular_attn: bool = True    # causal chunk scheduling (skip j>i chunks)
    flash_threshold: int = 2048     # seqs longer than this use chunked attention
    # memory
    remat: bool = True              # checkpoint each block in train mode
    grad_accum: int = 1             # microbatches per step (activation memory / k)
    # PIMSAB bit-slice serving path
    quant_serve: bool = True        # serve with int8 bit-sliced weights
    quant_kv: bool = False          # int8 KV cache (adaptive precision on state)
    seq_shard_kv: bool = False      # shard KV-cache sequence dim over "model"
                                    # when kv-heads don't divide tp (ring-
                                    # attention-style distributed decode)
    # MoE
    routing_groups: int = 0         # 0 => one group per data shard
    # distribution
    zero1: bool = False             # shard optimizer state over the data axis
    grad_compress: bool = False     # int8 error-feedback gradient allreduce
    scan_layers: bool = True        # lax.scan over pattern groups

DEFAULT_FLAGS = RunFlags()
