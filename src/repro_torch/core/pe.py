"""The CoMeFa-style single-bit processing element (paper Fig. 4).

One PE sits under each bitline.  Per micro-op (one cycle) it sees one bit from
each of two wordlines, its carry latch, and its mask latch, and produces a
result bit + new carry.  ``pe_step`` is the exact dataflow: TR-mux (logic-op
select) → XOR stage (full-adder sum) → predication mux.

The CRAM simulator vectorizes this function across all 256 bitlines with
numpy; the bit-serial algorithms (ripple add, shift-add multiply) are loops of
``pe_step`` over wordlines — cycle counts fall straight out of the loop trip
counts, which is what timing.py mirrors analytically.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


def pe_logic(a: np.ndarray, b: np.ndarray, op: str) -> np.ndarray:
    """TR-mux: any 2-input logical function of the two wordline bits."""
    if op == "and":
        return a & b
    if op == "or":
        return a | b
    if op == "xor":
        return a ^ b
    if op == "not":
        return 1 - a
    if op == "b":
        return b
    if op == "a":
        return a
    raise ValueError(op)


def pe_full_adder(a: np.ndarray, b: np.ndarray, carry: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """XOR stage + majority: sum bit and carry-out (one micro-op)."""
    s = a ^ b ^ carry
    cout = (a & b) | (carry & (a ^ b))
    return s, cout


def pe_step(
    a: np.ndarray,
    b: np.ndarray,
    carry: np.ndarray,
    mask: np.ndarray,
    op: str,
    predicate: str = "none",
    old: np.ndarray | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """One micro-op across a vector of PEs.

    Returns (result_bits, new_carry).  With predication, lanes whose predicate
    bit is 0 keep ``old`` (the current contents of the destination wordline).
    """
    if op == "add":
        res, carry = pe_full_adder(a, b, carry)
    else:
        res = pe_logic(a, b, op)
    if predicate == "mask":
        assert old is not None
        res = np.where(mask.astype(bool), res, old)
    elif predicate == "carry":
        assert old is not None
        res = np.where(carry.astype(bool), res, old)
    return res.astype(np.uint8), carry.astype(np.uint8)
