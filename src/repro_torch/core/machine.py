"""PIMSAB machine configurations (paper Table II + §VI-B comparison configs)."""
from __future__ import annotations

import math
from dataclasses import dataclass, replace


@dataclass(frozen=True)
class PimsabConfig:
    # CRAM geometry (bits)
    cram_rows: int = 256          # wordlines
    cram_cols: int = 256          # bitlines == PEs per CRAM
    crams_per_tile: int = 256
    # chip
    mesh_cols: int = 12           # NoC X (memory controllers on the top row)
    mesh_rows: int = 10           # NoC Y
    clock_ghz: float = 1.5
    # bandwidths (bits per clock)
    # Table II says 12288 bits/clock at the 1215 MHz DRAM clock == 1866 GB/s;
    # normalized to the 1.5 GHz chip clock that timing.py divides by:
    dram_bw_bits: int = 9952      # 1866 GB/s ÷ 1.5 GHz — iso-A100 bandwidth
    t2t_bw_bits: int = 1024
    c2c_bw_bits: int = 256        # H-tree link / CRAM-to-CRAM ring
    # register file
    rf_regs: int = 32
    rf_bits: int = 32
    dram_latency_cycles: int = 100
    # inter-chip link interface (multi-chip scale-out): each chip exposes one
    # full-duplex SerDes port onto the cluster interconnect.  1024 bits/clock
    # at 1.5 GHz is 192 GB/s (NVLink-class); the latency covers SerDes +
    # protocol + wire per link hop.  Single-chip programs never issue
    # ChipSend/ChipRecv, so these fields are inert outside a ChipCluster run.
    link_bw_bits: int = 1024
    link_latency_cycles: int = 64

    @property
    def num_tiles(self) -> int:
        return self.mesh_cols * self.mesh_rows

    @property
    def pes_per_tile(self) -> int:
        return self.crams_per_tile * self.cram_cols

    @property
    def total_pes(self) -> int:
        return self.num_tiles * self.pes_per_tile

    @property
    def total_crams(self) -> int:
        return self.num_tiles * self.crams_per_tile

    @property
    def cram_bytes(self) -> int:
        return self.cram_rows * self.cram_cols // 8

    @property
    def onchip_mbytes(self) -> float:
        return self.total_crams * self.cram_bytes / 2**20

    @property
    def vector_width(self) -> int:
        """Bitlines across a tile — the full-utilization vectorization width."""
        return self.pes_per_tile


# Main configuration: iso-area/iso-bandwidth vs NVIDIA A100 (§VI-B).
PIMSAB = PimsabConfig()
# 30,720 CRAMs, 7.86M PEs, 512 MB on-chip (§VII-A).

# PIMSAB-D: throughput-matched to Duality Cache (1.14M PEs @2.6GHz → 30 tiles).
PIMSAB_D = replace(PIMSAB, mesh_cols=6, mesh_rows=5)

# PIMSAB-S: PE-count-matched to SIMDRAM's 1-bank configuration (1 tile).
PIMSAB_S = replace(PIMSAB, mesh_cols=1, mesh_rows=1)
