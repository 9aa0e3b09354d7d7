"""Intra-tile static H-tree network model (§III-A, §IV-B).

256 CRAMs are leaves of a binary H-tree (8 levels); switches are buffered
5-port crossbars configured per communication pattern.  Functional reduction
order (pairwise, adjacent-first) matches kernels/htree_reduce.py and
dist/collectives.htree_allreduce — one summation order across all three
layers, so numerics agree everywhere.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np

from repro_torch.core.machine import PimsabConfig
from repro_torch.core import timing


def levels(cfg: PimsabConfig) -> int:
    return int(math.log2(cfg.crams_per_tile))


def reduce_cycles(cfg: PimsabConfig, prec: int) -> int:
    return timing.cycles_htree_reduce(cfg, prec)


def bcast_cycles(cfg: PimsabConfig, bits: int) -> int:
    return timing.cycles_htree_bcast(cfg, bits)


def reduce_functional(values: List[np.ndarray]) -> np.ndarray:
    """Pairwise tree sum of per-CRAM vectors (H-tree order: adjacent leaves
    combine first).  A non-power-of-two leaf set — a tile whose data plane
    only populated some CRAMs — reduces the same way, the odd tail riding up
    a level unpaired (the switch forwards a single child unchanged)."""
    vals = [np.asarray(v, np.int64) for v in values]
    while len(vals) > 1:
        nxt = [vals[i] + vals[i + 1] for i in range(0, len(vals) - 1, 2)]
        if len(vals) % 2:
            nxt.append(vals[-1])
        vals = nxt
    return vals[0]


def reconfig_cycles(cfg: PimsabConfig) -> int:
    """Switch reconfiguration on a new communication pattern (rare; 2
    config bits per output port, loaded down the tree)."""
    return levels(cfg) + 2
