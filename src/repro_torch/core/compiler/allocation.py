"""CRAM buffer allocation + the three bit-serial-aware optimizations (§V-C).

* adaptive precision — a-bit × b-bit product needs a+b bits; accumulating k
  values adds ⌈log₂k⌉; overrides the program's declared i32 accumulators.
* bit-level lifetime — a multiply feeding an accumulate keeps only a
  half-width live window (Fig. 8a): the i-th product bit is final after i
  cycles and is folded into the accumulator immediately.
* fragmented allocation — operands may straddle non-contiguous free wordline
  ranges (Fig. 8b); the allocator is first-fit over a free set and splits
  buffers when no contiguous range exists.

Graph programs add a fourth, *live-range* dimension (:func:`allocate_graph`):
buffers live only while their op executes — except intermediates that stay
CRAM-resident for a downstream consumer, whose wordlines are reserved from
the producing op through the consuming op.  A consumer's chained input is
*pinned* to the producer's output range (same wordlines, no new space), which
is what lets codegen elide the DRAM store/load pair at the boundary.

Double-buffered schedules (``distribute.mapping_buffer_reqs``) append
``<name>.alt`` requests — the second A/B chunk region the prefetched DRAM
transfer lands in while compute reads the primary.  They allocate like any
other buffer (first-fit, fragmentable) and simply drop out of the plan when
the capacity check fails: overlap is an upgrade, never a requirement.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


def adaptive_precision(pa: int, pb: int, k: int = 1, op: str = "mac") -> int:
    """Minimum result precision (§V-C): mul → a+b; k-term accumulate → +⌈log₂k⌉."""
    if op in ("map_add", "add"):
        base = max(pa, pb) + 1
    elif op in ("map_mul", "mul", "mac", "stencil_mac"):
        base = pa + pb
    elif op in ("relu", "maxpool", "copy", "kv_append"):
        base = max(pa, pb)
    elif op == "softmax":
        # probabilities in SOFTMAX_F fraction bits, values in [0, 2^F]
        base = SOFTMAX_F + 2
    elif op == "scan_mac":
        # the recurrence state keeps the wider operand's format: each step's
        # product is renormalized back (>> frac) before the add, so precision
        # does not grow with the sequential extent
        base = max(pa, pb)
    else:
        raise ValueError(op)
    if op in ("mac", "stencil_mac") and k > 1:
        base += math.ceil(math.log2(k))
    return base


def mul_live_window(p_mul: int) -> int:
    """Half-width live window for mul-feeding-add (Fig. 8a)."""
    return p_mul - p_mul // 2


# fixed-point softmax formats (shared by codegen emission, the distribute
# buffer model, and the JAX oracle — all three must agree bit-for-bit):
# exponentials carry SOFTMAX_F fraction bits, the range reduction divides by
# 2^SOFTMAX_K before the quadratic and squares K times after, and the
# reciprocal of the row sum is computed by restoring division to SOFTMAX_FI
# extra fraction bits.  Probabilities come out with SOFTMAX_F fraction bits
# in SOFTMAX_F + 2 total bits.
SOFTMAX_F = 6
SOFTMAX_K = 3
SOFTMAX_FI = 8


def softmax_out_prec() -> int:
    """Result precision of the fixed-point softmax (probs ∈ [0, 2^F])."""
    return SOFTMAX_F + 2


def softmax_scratch_layout(pin: int, in_frac: int, t_extent: int):
    """Per-lane scratch fields of the softmax emission as ``name -> (offset,
    prec)`` plus the total wordline count.

    The division block (r/c/rn/qn) only runs after the exponential loop
    retires, so it overlays the exponential scratch (t/tcl/tfl/mul/v1/w/onef)
    — the layout here is what both codegen (field addresses) and distribute
    (wordline budget) consume, keeping the two views of the same bytes in
    lockstep.  The range reduction clamps in the *t* domain (t >= -2^(F+σ)
    iff t>>σ >= -2^F, floor shift being monotone) so the shifted operand is
    read straight out of ``tcl`` via an address-offset window — no extra
    shifted field.
    """
    f, k, fi = SOFTMAX_F, SOFTMAX_K, SOFTMAX_FI
    sigma = in_frac - f + k
    if sigma < 0:
        raise ValueError(f"softmax in_frac={in_frac} must be >= {f - k}")
    if in_frac + k > pin:
        raise ValueError(
            f"softmax clamp floor -2^{f + sigma} does not fit {pin + 1} bits")
    pt = pin + 1                 # x - m, and the clamp floor -2^(F+sigma)
    pm_mul = f + fi + 2          # u*u <= 2^2F, w*w <= 2^2F, exp*inv <= 2^(F+FI)
    pv = f + 3
    ps = f + 1 + max(1, math.ceil(math.log2(max(2, t_extent)))) + 1
    pq = fi + 2                  # reciprocal, <= 2^FI
    pr = max(fi + f + 2, ps + fi)  # r and s<<b compare at one prec (CmpGE)
    exp_block = [("t", pt), ("tcl", pt), ("tfl", pt), ("mul", pm_mul),
                 ("v1", pv), ("w", pv), ("onef", f + 2)]
    div_block = [("r", pr), ("c", pr), ("rn", pr), ("qn", pq)]
    layout = {}
    off = 0
    # m/s/q/one survive across both phases, so they live outside the overlay
    for name, p in [("m", pin), ("s", ps), ("q", pq), ("one", 2)]:
        layout[name] = (off, p)
        off += p
    base = off
    for name, p in exp_block:
        layout[name] = (off, p)
        off += p
    exp_end = off
    off = base
    for name, p in div_block:
        layout[name] = (off, p)
        off += p
    total = max(exp_end, off)
    return layout, total


def signed_bits(lo: int, hi: int) -> int:
    """Minimum two's-complement width holding every value in ``[lo, hi]``.

    This is the value-level form of the §V-C growth law that
    :func:`adaptive_precision` applies to operand widths; the static
    verifier's overflow lint propagates exact ``(lo, hi)`` bounds through
    accumulator chains and converts them back to wordline counts here."""
    bits = 1
    if hi > 0:
        bits = max(bits, hi.bit_length() + 1)
    if lo < 0:
        bits = max(bits, ((-lo) - 1).bit_length() + 1)
    return bits


@dataclass
class BufferReq:
    name: str
    wordlines: int           # after adaptive precision + lifetime
    naive_wordlines: int     # the program-declared cost (for reporting)


@dataclass
class Allocation:
    ranges: Dict[str, List[Tuple[int, int]]] = field(default_factory=dict)
    used: int = 0
    capacity: int = 256
    feasible: bool = True
    fragmented: bool = False
    savings: Dict[str, int] = field(default_factory=dict)

    def to_json(self):
        return {
            "ranges": self.ranges, "used": self.used, "capacity": self.capacity,
            "feasible": self.feasible, "fragmented": self.fragmented,
            "savings": self.savings,
        }


class WordlineAllocator:
    """First-fit allocator over the 256 wordlines with explicit free-set and
    fragment splitting."""

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self.free: List[Tuple[int, int]] = [(0, capacity)]  # [start, end)

    def alloc(self, n: int) -> Optional[List[Tuple[int, int]]]:
        # contiguous first
        for i, (s, e) in enumerate(self.free):
            if e - s >= n:
                self.free[i] = (s + n, e)
                if self.free[i][0] == self.free[i][1]:
                    self.free.pop(i)
                return [(s, s + n)]
        # fragmented: gather pieces (divisible bit-serial operands, Fig. 8b)
        total = sum(e - s for s, e in self.free)
        if total < n:
            return None
        got: List[Tuple[int, int]] = []
        need = n
        while need > 0:
            s, e = self.free.pop(0)
            take = min(e - s, need)
            got.append((s, s + take))
            if take < e - s:
                self.free.insert(0, (s + take, e))
            need -= take
        return got

    def free_wordlines(self) -> int:
        return sum(e - s for s, e in self.free)

    def reserve(self, ranges: List[Tuple[int, int]]) -> None:
        """Carve ``ranges`` out of the free set (wordlines owned by a live
        buffer of another op — they must not be handed out here)."""
        for (rs, re) in ranges:
            nxt: List[Tuple[int, int]] = []
            for (s, e) in self.free:
                if re <= s or rs >= e:
                    nxt.append((s, e))
                    continue
                if s < rs:
                    nxt.append((s, rs))
                if re < e:
                    nxt.append((re, e))
            self.free = nxt


def allocate(
    reqs: List[BufferReq],
    capacity: int = 256,
    *,
    reserved: Optional[List[Tuple[int, int]]] = None,
    pinned: Optional[Dict[str, List[Tuple[int, int]]]] = None,
) -> Allocation:
    """First-fit allocation of ``reqs`` over the wordline space.

    ``reserved`` ranges are excluded from the free set (live buffers of other
    ops in a graph program).  ``pinned`` buffers take the given ranges
    verbatim instead of fresh space — a chained input aliasing its producer's
    output.
    """
    alloc = Allocation(capacity=capacity)
    wa = WordlineAllocator(capacity)
    if reserved:
        wa.reserve(reserved)
    pinned = pinned or {}
    for r in sorted(reqs, key=lambda r: -r.wordlines):
        if r.name in pinned:
            alloc.ranges[r.name] = [tuple(p) for p in pinned[r.name]]
            alloc.savings[r.name] = r.naive_wordlines  # no fresh space at all
            continue
        got = wa.alloc(r.wordlines)
        if got is None:
            alloc.feasible = False
            alloc.ranges[r.name] = []
            continue
        alloc.ranges[r.name] = got
        alloc.fragmented |= len(got) > 1
        alloc.used += r.wordlines
        alloc.savings[r.name] = r.naive_wordlines - r.wordlines
    return alloc


def allocate_graph(
    items: List[Tuple[str, List[BufferReq], Dict[str, str]]],
    capacity: int = 256,
    *,
    reserved: Optional[List[Tuple[int, int]]] = None,
    pinned_fixed: Optional[Dict[str, Dict[str, List[Tuple[int, int]]]]] = None,
) -> Dict[str, Allocation]:
    """Live-range-aware allocation for an ordered graph program.

    ``items`` is ``[(op_name, reqs, pins)]`` in execution order, where
    ``pins`` maps a buffer of this op to ``"producer_op:producer_buf"`` — the
    CRAM-resident intermediate it aliases.  A pinned source buffer stays
    reserved for every op between its producer and its last consumer; all
    other buffers are considered dead once their op retires, so later ops
    reuse their wordlines freely.

    Returns per-op Allocations; an op whose own buffers don't fit around the
    live intermediates comes back ``feasible=False`` (the caller drops the
    residency pin and retries).

    ``reserved`` carves fixed wordline ranges out of *every* op's free set —
    the CRAM-resident persistent-state regions (``ResidentState``) that must
    survive across whole program executions, not just across graph segments.
    ``pinned_fixed`` maps ``op -> buffer -> ranges`` for buffers pinned to
    those reserved regions verbatim (a state updater's in-place input/output).
    """
    globally_reserved = list(reserved or [])
    pinned_fixed = pinned_fixed or {}
    order = {name: i for i, (name, _, _) in enumerate(items)}
    # live interval of each pinned source buffer: (producer_idx, consumer_idx]
    live: Dict[Tuple[str, str], int] = {}  # (op, buf) -> last consumer idx
    for name, _, pins in items:
        for _, src in pins.items():
            src_op, src_buf = src.split(":")
            key = (src_op, src_buf)
            live[key] = max(live.get(key, -1), order[name])

    allocs: Dict[str, Allocation] = {}
    for idx, (name, reqs, pins) in enumerate(items):
        op_reserved: List[Tuple[int, int]] = list(globally_reserved)
        for (src_op, src_buf), last in live.items():
            if order[src_op] < idx <= last:
                op_reserved.extend(allocs[src_op].ranges.get(src_buf, []))
        pinned = {}
        for buf, src in pins.items():
            src_op, src_buf = src.split(":")
            pinned[buf] = allocs[src_op].ranges.get(src_buf, [])
        for buf, ranges in pinned_fixed.get(name, {}).items():
            pinned[buf] = [tuple(r) for r in ranges]
        allocs[name] = allocate(reqs, capacity, reserved=op_reserved, pinned=pinned)
    return allocs
