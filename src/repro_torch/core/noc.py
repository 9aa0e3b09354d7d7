"""2D-mesh NoC model: X-Y wormhole routing, DRAM controllers on the top row
(§III-A), systolic broadcast (§III-B) — plus the inter-chip interconnect
(:class:`ChipLink` / :class:`ChipCluster`) the multi-chip layer schedules
cross-chip collectives over."""
from __future__ import annotations

import math
from dataclasses import dataclass, replace as _dc_replace
from typing import List, Tuple

from repro_torch.core.machine import PimsabConfig
from repro_torch.core import timing


def tile_xy(cfg: PimsabConfig, tile: int) -> Tuple[int, int]:
    return tile % cfg.mesh_cols, tile // cfg.mesh_cols


def hops(cfg: PimsabConfig, src: int, dst: int) -> int:
    sx, sy = tile_xy(cfg, src)
    dx, dy = tile_xy(cfg, dst)
    return abs(sx - dx) + abs(sy - dy)


def dram_hops(cfg: PimsabConfig, tile: int) -> int:
    """Distance to the nearest top-row memory controller (same column)."""
    _, y = tile_xy(cfg, tile)
    return y


def avg_dram_hops(cfg: PimsabConfig) -> float:
    return sum(dram_hops(cfg, t) for t in range(cfg.num_tiles)) / cfg.num_tiles


def p2p_cycles(cfg: PimsabConfig, src: int, dst: int, bits: int) -> int:
    return timing.cycles_noc_p2p(cfg, bits, hops(cfg, src, dst))


def systolic_bcast_cycles(cfg: PimsabConfig, bits: int, n_dest: int) -> int:
    return timing.cycles_noc_systolic_bcast(cfg, bits, n_dest)


def systolic_gather_cycles(cfg: PimsabConfig, bits: int, n_src: int) -> int:
    """Reverse of the systolic broadcast: `n_src` tiles funnel their slices
    toward the memory-controller row through the same near-neighbour
    pipeline, so the cost is symmetric — fill (n_src hops) + payload once.
    Used by DramStore's gather path (the load/store timing symmetry)."""
    return timing.cycles_noc_systolic_bcast(cfg, bits, n_src)


def naive_bcast_cycles(cfg: PimsabConfig, src: int, dests: List[int], bits: int) -> int:
    return timing.cycles_noc_naive_bcast(cfg, bits, [hops(cfg, src, d) for d in dests])


def bisection_bits_per_cycle(cfg: PimsabConfig) -> int:
    return cfg.mesh_cols * cfg.t2t_bw_bits


# ---------------------------------------------------------------------------
# inter-chip interconnect (multi-chip scale-out)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ChipLink:
    """One full-duplex chip-to-chip link: SerDes bandwidth in bits per chip
    clock and the per-hop latency (SerDes + protocol + wire).  The defaults
    match ``PimsabConfig.link_bw_bits``/``link_latency_cycles`` — 192 GB/s
    at 1.5 GHz, NVLink-class."""

    bw_bits: int = 1024
    latency_cycles: int = 64

    def stream_cycles(self, bits: int) -> int:
        """Port-occupancy cycles of a ``bits``-sized transfer."""
        return math.ceil(bits / self.bw_bits)

    def transfer_cycles(self, bits: int, hops: int = 1) -> int:
        """Serialized transfer: stream + per-hop latency fill."""
        return self.stream_cycles(bits) + self.latency_cycles * max(1, hops)


@dataclass(frozen=True)
class ChipCluster:
    """N pimsab chips on an inter-chip mesh/ring.

    ``mesh`` is the (rows, cols) chip grid — ``(1, 2)``, ``(2, 2)``,
    ``(2, 4)`` are the scaling-suite shapes; a 1×N mesh is a ring.  Every
    chip owns one :class:`ChipLink` port; collectives are scheduled on the
    per-chip ``link`` timeline resource by the simulator."""

    mesh: Tuple[int, int] = (1, 1)
    link: ChipLink = ChipLink()

    def __post_init__(self):
        r, c = self.mesh
        if r < 1 or c < 1:
            raise ValueError(f"ChipCluster mesh must be positive, got {self.mesh}")

    @property
    def chips(self) -> int:
        return self.mesh[0] * self.mesh[1]

    def chip_xy(self, chip: int) -> Tuple[int, int]:
        return chip % self.mesh[1], chip // self.mesh[1]

    def chip_hops(self, src: int, dst: int) -> int:
        """X-Y routed hop count on the chip mesh."""
        sx, sy = self.chip_xy(src)
        dx, dy = self.chip_xy(dst)
        return abs(sx - dx) + abs(sy - dy)

    @property
    def diameter(self) -> int:
        return (self.mesh[0] - 1) + (self.mesh[1] - 1)

    def timing_cfg(self, cfg: PimsabConfig) -> PimsabConfig:
        """Project this cluster's link parameters into a per-chip machine
        config (the Simulator reads ``link_bw_bits``/``link_latency_cycles``
        when it schedules ChipSend/ChipRecv)."""
        return _dc_replace(
            cfg, link_bw_bits=self.link.bw_bits,
            link_latency_cycles=self.link.latency_cycles,
        )

    # -- collective cost shapes (the plan chooser's closed forms) -----------

    def allreduce_rounds(self) -> int:
        """Serial link-hop depth of a butterfly allreduce (recursive halving
        + doubling): 2·log2(N) exchange rounds, latency pipelined so the
        fill is ``2·log2(N) − 1`` hops deep; non-power-of-two falls back to
        a ring (2·(N−1) rounds)."""
        n = self.chips
        if n <= 1:
            return 0
        if n & (n - 1) == 0:
            return 2 * int(math.log2(n)) - 1
        return 2 * (n - 1) - 1

    def allreduce_port_bits(self, bits: int) -> int:
        """Bits each chip's link port transmits (== receives) during a
        butterfly/ring allreduce of a ``bits``-sized payload: the classic
        ``(N−1)/N · payload`` for each of the reduce-scatter and allgather
        halves."""
        n = self.chips
        if n <= 1:
            return 0
        return math.ceil(bits * (n - 1) / n)

    def allreduce_cycles(self, bits: int) -> int:
        """Serialized per-chip cost of one allreduce — the closed form the
        plan chooser scores before committing to a sharding (the timeline
        pass then schedules the same rounds as ChipSend/ChipRecv phases)."""
        if self.chips <= 1:
            return 0
        port = self.allreduce_port_bits(bits)
        return (
            2 * self.link.stream_cycles(port)
            + self.link.latency_cycles * (self.allreduce_rounds() + 1)
        )

    def p2p_cycles(self, src: int, dst: int, bits: int) -> int:
        """Point-to-point activation transfer (pipeline-parallel boundary)."""
        return self.link.transfer_cycles(bits, self.chip_hops(src, dst))
