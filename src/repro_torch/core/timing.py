"""Analytic cycle-cost model (DESIGN.md §6 — the paper's formulas).

All costs are in cycles of the 1.5 GHz clock.  Compute costs are per
*micro-op stream* — every CRAM in a tile executes them simultaneously (SIMD),
so a compute instruction costs the same whether 1 or 256 CRAMs participate.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.machine import PimsabConfig


def cycles_copy(p: int) -> int:
    return p


def cycles_logical(pa: int, pb: int) -> int:
    return max(pa, pb)


def cycles_add(pa: int, pb: int) -> int:
    return max(pa, pb) + 1


def cycles_add_sliced(p: int, slices: int) -> int:
    """Bit-sliced add: `slices` independent chunks of p/slices bits running on
    disjoint bitline groups, chained through the carry latch (cen/cst):
    wall-cycles = p/slices + 1 per chunk wave."""
    chunk = -(-p // slices)
    return chunk + 1


def cycles_mul(pa: int, pb: int) -> int:
    """Shift-add with the (a+2)-cycle running window per partial product."""
    return pb * (pa + 2)


def cycles_mul_const(pa: int, const: int) -> int:
    """Zero-bit skipping: only set bits of the scalar issue adds (≤2× faster
    mul, ≤4× dot products — §III-B)."""
    z = bin(abs(int(const))).count("1")
    extra = pa + 2 if const < 0 else 0  # final negate
    return max(z, 1) * (pa + 2) + extra


def cycles_mac(pa: int, pb: int, pd: int) -> int:
    """Fused multiply-accumulate (Fig. 8a streaming): the mul's shift-add
    stream + the accumulator ripple — exactly the Mul+Add pair it fuses."""
    return cycles_mul(pa, pb) + max(pd, pa + pb) + 1


def cycles_mac_const(pa: int, const: int, pd: int) -> int:
    """Constant-operand fused MAC: zero-bit-skipped mul + accumulator ripple."""
    return cycles_mul_const(pa, const) + pd + 1


def cycles_reduce_intra(p: int, size: int) -> int:
    """Intra-CRAM tree over bitlines: stage s shifts 2^s lanes (P_s cycles)
    then adds (P_s + 1); precision grows 1/stage."""
    cycles = 0
    ps = p
    for _ in range(int(math.log2(size))):
        cycles += ps          # lane shift
        cycles += ps + 1      # add
        ps += 1
    return cycles


def cycles_htree_reduce(cfg: PimsabConfig, p: int) -> int:
    """Across the 256 CRAMs of a tile: log2(256)=8 levels, each moving one
    p-bit word per lane-group over 256-bit links + an add."""
    levels = int(math.log2(cfg.crams_per_tile))
    link = math.ceil(cfg.cram_cols * p / cfg.c2c_bw_bits)
    return levels * (link + p + 1)


def cycles_htree_bcast(cfg: PimsabConfig, bits: int) -> int:
    """Pipelined broadcast down the tree: payload + depth."""
    return math.ceil(bits / cfg.c2c_bw_bits) + int(math.log2(cfg.crams_per_tile))


def cycles_cram_shift(cfg: PimsabConfig, p: int, lanes: int = 1) -> int:
    return p * lanes


def cycles_dram(cfg: PimsabConfig, bits: int, bursts: int = 1) -> int:
    return math.ceil(bits / cfg.dram_bw_bits) + cfg.dram_latency_cycles * bursts


def cycles_dram_stream(cfg: PimsabConfig, bits: int) -> int:
    """Channel-occupancy cycles of a transfer: the streaming time alone.

    The access latency (``dram_latency_cycles``) delays the *completion* of
    each burst but does not hold the channel — back-to-back bursts pipeline —
    so the phase-timeline simulator charges occupancy and latency separately
    (``cycles_dram`` == stream + latency remains the serialized burst cost).
    """
    return math.ceil(bits / cfg.dram_bw_bits)


def cycles_noc_p2p(cfg: PimsabConfig, bits: int, hops: int) -> int:
    """Wormhole: head latency (hops) + serialization."""
    return hops + math.ceil(bits / cfg.t2t_bw_bits)


def cycles_noc_systolic_bcast(cfg: PimsabConfig, bits: int, n_dest: int) -> int:
    """Near-neighbour systolic broadcast: pipeline fill (n_dest hops) +
    payload once — vs naive one-to-many Σ (hops_k + payload)."""
    return n_dest + math.ceil(bits / cfg.t2t_bw_bits)


def cycles_noc_naive_bcast(cfg: PimsabConfig, bits: int, hops_list) -> int:
    return sum(h + math.ceil(bits / cfg.t2t_bw_bits) for h in hops_list)


def cycles_link_stream(cfg: PimsabConfig, bits: int) -> int:
    """Inter-chip link occupancy of a transfer: streaming time alone.

    Mirrors :func:`cycles_dram_stream`: the per-hop latency
    (``link_latency_cycles``) delays *completion* but does not hold the
    port — back-to-back rounds of a collective pipeline."""
    return math.ceil(bits / cfg.link_bw_bits)


def cycles_link(cfg: PimsabConfig, bits: int, hops: int = 1) -> int:
    """Serialized inter-chip transfer cost: stream + per-hop latency fill."""
    return cycles_link_stream(cfg, bits) + cfg.link_latency_cycles * max(1, hops)


def seconds(cfg: PimsabConfig, cycles: float) -> float:
    return cycles / (cfg.clock_ghz * 1e9)
