"""Energy model (22 nm-scaled constants, DESIGN.md §6).

Constants are calibrated so the per-benchmark *breakdown shapes* land on the
paper's Fig. 11 (DRAM-dominated for low-reuse kernels; compute ≈40% for
gemm/conv) — absolute joules are model outputs, not silicon measurements.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from repro_torch.core.machine import PimsabConfig

# pJ constants
E_CRAM_CYCLE = 2.4       # per CRAM per active compute cycle
E_HTREE_BIT_LEVEL = 0.02  # per bit per tree level
E_NOC_BIT_HOP = 0.06     # per bit per router hop
E_DRAM_BIT = 10.0        # per bit to/from HBM
E_CTRL_INSTR = 5.0       # instruction controller decode/issue
E_RF_ACCESS = 1.0        # register-file access
E_XPOSE_BIT = 0.05       # transpose unit per bit
E_LINK_BIT = 2.0         # inter-chip SerDes per bit (multi-chip scale-out)


@dataclass
class EnergyLedger:
    pj: Dict[str, float] = field(default_factory=lambda: {
        "compute": 0.0, "htree": 0.0, "noc": 0.0, "dram": 0.0,
        "controller": 0.0, "rf": 0.0,
    })

    def compute(self, cycles: float, active_crams: int) -> None:
        self.pj["compute"] += E_CRAM_CYCLE * cycles * active_crams

    def htree(self, bits: float, levels: int = 8) -> None:
        self.pj["htree"] += E_HTREE_BIT_LEVEL * bits * levels

    def noc(self, bits: float, hops: float) -> None:
        self.pj["noc"] += E_NOC_BIT_HOP * bits * hops

    def dram(self, bits: float, transpose: bool = True) -> None:
        self.pj["dram"] += E_DRAM_BIT * bits + (E_XPOSE_BIT * bits if transpose else 0.0)

    def controller(self, instrs: float, tiles: int) -> None:
        self.pj["controller"] += E_CTRL_INSTR * instrs * tiles

    def rf(self, accesses: float) -> None:
        self.pj["rf"] += E_RF_ACCESS * accesses

    def link(self, bits: float) -> None:
        # lazy key: single-chip ledgers keep the original breakdown shape
        self.pj["link"] = self.pj.get("link", 0.0) + E_LINK_BIT * bits

    @property
    def total_j(self) -> float:
        return sum(self.pj.values()) * 1e-12

    def breakdown(self) -> Dict[str, float]:
        t = max(sum(self.pj.values()), 1e-30)
        return {k: v / t for k, v in self.pj.items()}
