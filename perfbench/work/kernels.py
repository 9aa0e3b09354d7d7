"""The port's kernels as the device trace names them.

Each file ``port_kernels/<id>.json`` names one kernel of the port
(``{"kernel": "K1", "source": "csrc/int_gemm.cu", "symbols": [...]}``): the
``__global__`` functions it launches.  A traced operation belongs to a
kernel when one of its symbols is a whole identifier of the trace's name
(the profiler's names are demangled: ``void (anonymous namespace)::tc::
bitslice_mma_kernel<1, 1, 128, 32, 32>(...)``).  A later kernel of the port
is a new file here.
"""
from __future__ import annotations

import json
import re
from functools import lru_cache
from pathlib import Path
from typing import Dict, Optional, Tuple

DIR = Path(__file__).resolve().parent / "port_kernels"


@lru_cache(maxsize=None)
def symbols() -> Dict[str, Tuple[str, ...]]:
    """Kernel id → its symbols, from every file of ``port_kernels/``."""
    out = {}
    for path in sorted(DIR.glob("*.json")):
        with open(path) as f:
            entry = json.load(f)
        out[entry["kernel"]] = tuple(entry["symbols"])
    return out


@lru_cache(maxsize=None)
def _patterns() -> Tuple[Tuple[str, "re.Pattern[str]"], ...]:
    return tuple((k, re.compile(r"(?<![A-Za-z0-9_])(?:" + "|".join(map(re.escape, syms)) + r")(?![A-Za-z0-9_])"))
                 for k, syms in symbols().items())


@lru_cache(maxsize=4096)
def kernel_of(trace_name: str) -> Optional[str]:
    """The id of the port's kernel that launched ``trace_name``, or None for
    an operation of PyTorch's or the driver's."""
    for k, pat in _patterns():
        if pat.search(trace_name):
            return k
    return None
