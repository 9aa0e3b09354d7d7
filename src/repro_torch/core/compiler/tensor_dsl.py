"""Tensor-expression DSL (§V-A) — the TVM-style front end, reduced to the
algebra the paper evaluates: elementwise maps, MAC reductions (gemv/gemm/
conv via im2col), and stencils (fir).

A Workload is loops + tensor refs + one op kind.  Scheduling = loop
organization: ``split`` and ``reorder`` produce new loop lists; binding to
hardware levels is the *compiler's* job (distribute.py), with the user's loop
order acting as the hint (§V: developers control organization/layout, the
compiler controls parallelism distribution + buffers).

Multi-op programs are a :class:`WorkloadGraph`: a topologically-ordered
sequence of Workloads plus producer→consumer edges.  An edge names the
consumer's *canonical input buffer* (``"in_a"``/``"in_b"`` — the compiler's
buffer names, not the Ref names) and may be flagged ``resident_ok``: the
lowering layer asserts the value crosses the boundary in the raw integer
domain, so the compiler is allowed to keep it CRAM-resident and elide the
producer's DRAM store + the consumer's DRAM load (the paper's spatially-aware
communication of intermediates, applied at the kernel boundary).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Loop:
    name: str
    extent: int
    kind: str = "data"  # "data" | "reduce"


@dataclass(frozen=True)
class Ref:
    """Tensor reference: which loops index it, at what precision (bits)."""
    name: str
    index: Tuple[str, ...]  # loop names, row-major
    prec: int = 8
    is_const: bool = False  # scalar/constant operand → RF + mul_const path
    const_value: Optional[int] = None
    stencil: int = 0        # fir/conv taps indexed via shifted loads
    frac: int = 0           # fixed-point fraction bits (scan_mac renormalizes
                            # products by reading the shifted wordline window)


@dataclass(frozen=True)
class Workload:
    name: str
    loops: Tuple[Loop, ...]
    out: Ref
    ins: Tuple[Ref, ...]
    # "map_add" | "map_mul" | "mac" | "stencil_mac" | "scan_mac" | "relu" |
    # "maxpool" | "softmax" | "kv_append"
    # scan_mac: out_t = a_t · out_{t-1} + b_t — the reduce loop is *sequential
    # per lane* (a linear recurrence), never split across lanes.
    # maxpool: fold the reduce window via CmpGE + masked copy (whole window
    # resident per lane — the fold mutates `out` in place, so it cannot chunk).
    # softmax: fixed-point row softmax (lane = row, fields = the row); the
    # reduce loop is the row extent, whole row resident like maxpool.
    # kv_append: out = in_a with the row selected by the one-hot in_c
    # replaced by in_b (lane = row, fields = head dim, in place when the
    # cache is a CRAM-resident persistent state).
    op: str
    acc_prec: int = 32  # the *program's* accumulator precision (pre-adaptive)
    # average pools are `mac` reductions against the constant 1 whose store
    # reads the accumulator `div_shift` wordlines up — a free arithmetic
    # >> div_shift (floor divide by the power-of-two window count)
    div_shift: int = 0

    def loop(self, name: str) -> Loop:
        for l in self.loops:
            if l.name == name:
                return l
        raise KeyError(name)

    @property
    def data_loops(self) -> List[Loop]:
        return [l for l in self.loops if l.kind == "data"]

    @property
    def reduce_loops(self) -> List[Loop]:
        return [l for l in self.loops if l.kind == "reduce"]

    def total_out_elems(self) -> int:
        n = 1
        for l in self.data_loops:
            n *= l.extent
        return n

    def reduce_extent(self) -> int:
        n = 1
        for l in self.reduce_loops:
            n *= l.extent
        return n


# ---------------------------------------------------------------------------
# multi-op graphs
# ---------------------------------------------------------------------------


def out_buffer(w: Workload) -> str:
    """The canonical allocation-buffer name holding ``w``'s output values."""
    return "acc" if w.op in ("mac", "scan_mac", "stencil_mac") else "out"


@dataclass(frozen=True)
class GraphEdge:
    """Producer→consumer dataflow edge between two graph nodes.

    ``dst_input`` is the consumer's canonical buffer ("in_a" = ins[0],
    "in_b" = ins[1]).  ``resident_ok`` is the *lowering layer's* assertion
    that the boundary value is domain-compatible for CRAM residency (raw
    integers, matching precision); the mapping layer still checks layout.
    """

    src: str
    dst: str
    dst_input: str
    resident_ok: bool = False


@dataclass(frozen=True)
class WorkloadGraph:
    """Topologically-ordered multi-op workload (one compiled program)."""

    name: str
    nodes: Tuple[Workload, ...]
    edges: Tuple[GraphEdge, ...] = ()
    outputs: Tuple[str, ...] = ()  # node names whose results leave the chip

    def __post_init__(self):
        names = [w.name for w in self.nodes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate node names in graph {self.name!r}: {names}")
        order = {n: i for i, n in enumerate(names)}
        for e in self.edges:
            if e.src not in order or e.dst not in order:
                raise ValueError(f"edge {e} references unknown node")
            if order[e.src] >= order[e.dst]:
                raise ValueError(f"edge {e} is not topologically ordered")

    def node(self, name: str) -> Workload:
        for w in self.nodes:
            if w.name == name:
                return w
        raise KeyError(name)

    def in_edges(self, dst: str) -> List["GraphEdge"]:
        return [e for e in self.edges if e.dst == dst]

    def out_edges(self, src: str) -> List["GraphEdge"]:
        return [e for e in self.edges if e.src == src]


# ---------------------------------------------------------------------------
# schedule primitives
# ---------------------------------------------------------------------------


def split(w: Workload, name: str, factor: int) -> Workload:
    """loop → (name.o, name.i) with extents (extent/factor, factor)."""
    new_loops: List[Loop] = []
    for l in w.loops:
        if l.name == name:
            assert l.extent % factor == 0, (l, factor)
            new_loops.append(Loop(f"{name}.o", l.extent // factor, l.kind))
            new_loops.append(Loop(f"{name}.i", factor, l.kind))
        else:
            new_loops.append(l)

    def fix(r: Ref) -> Ref:
        if name in r.index:
            idx = []
            for n in r.index:
                if n == name:
                    idx += [f"{name}.o", f"{name}.i"]
                else:
                    idx.append(n)
            return replace(r, index=tuple(idx))
        return r

    return replace(w, loops=tuple(new_loops), out=fix(w.out), ins=tuple(fix(r) for r in w.ins))


def reorder(w: Workload, order: Sequence[str]) -> Workload:
    by_name = {l.name: l for l in w.loops}
    assert set(order) == set(by_name), (order, list(by_name))
    return replace(w, loops=tuple(by_name[n] for n in order))
