"""Code generation: lower a distributed Mapping to the PIMSAB ISA (§V-D).

The emitted stream is the per-tile SIMD program (every tile executes it on
its own data slice; the simulator charges DRAM/NoC instructions with
chip-total bits).  Schedules are *phased*: every instruction carries a
``phase`` completion token and ``after`` dependency tokens (core.isa), so
the phase-timeline simulator can overlap DRAM streaming, the systolic NoC
broadcast pipeline (Fig. 5) and H-tree distribution with bit-serial compute
wherever the dependencies allow:

* multi-phase kernels (serial output chunks, k-chunked reductions) emit
  **double-buffered** schedules when the mapping allocated second A/B chunk
  regions (``Mapping.double_buffered``): the next chunk's DRAM load waits on
  the compute that is *two* chunks back, prefetching during the current
  chunk's MACs/adds;
* single-step streaming elementwise kernels split their tiles into
  staggered groups — each group's per-tile controllers start computing as
  soon as that group's DRAM slice lands, and its store drains while the next
  group computes (loads/stores still serialize on the one DRAM channel).

The emission *order* of dependent instructions is unchanged from the
serialized schedule — the functional machine executes in program order, so
results are bit-exact regardless of the modeled overlap; only the tags (and
buffer parity addresses) differ.

Programs are *functionally executable*: DRAM instructions carry a data-plane
``tag`` ("in_a"/"in_b"/"h0"/"out") and a ``fields`` count so a binder (see
``repro_torch.kernels.pimsab_backend``) can marry the instruction stream with real
operand slabs and run it on ``Simulator(functional=True)``.  That forces the
stream to be self-contained: accumulators are zeroed with the bit-serial
XOR idiom before each serial step, constants reach the RF through explicit
``RfLoad``s, and multiply-accumulates are the fused ``Mac``/``MacConst``
(Fig. 8a streaming — the Mul+Add pair they replace truncated the product to
the half-width live window and was not executable).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Tuple

from repro_torch.core import isa
from repro_torch.core.compiler.allocation import (
    SOFTMAX_F,
    SOFTMAX_FI,
    SOFTMAX_K,
    mul_live_window,
    softmax_scratch_layout,
)
from repro_torch.core.compiler.distribute import (
    GraphMapping,
    Mapping,
    distribute,
    distribute_graph,
)
from repro_torch.core.compiler.tensor_dsl import Workload, WorkloadGraph
from repro_torch.core.machine import PimsabConfig

# staggered tile groups for single-step streaming elementwise kernels: the
# DRAM stream is cut into this many per-tile-group slices so compute/store
# of one group overlaps the next group's load
_MAP_STREAM_GROUPS = 4


@dataclass
class CompiledProgram:
    program: List[isa.Instr]
    mapping: Mapping

    def __iter__(self):
        return iter(self.program)

    def verify(self, cfg: PimsabConfig):
        """Run the compile-time static verifier (liveness, schedule-hazard
        races, precision-overflow lint) over this stream and its mapping;
        returns the :class:`~repro_torch.core.compiler.verify.VerifyReport`."""
        from repro_torch.core.compiler.verify import verify_compiled

        return verify_compiled(self, cfg)


@dataclass
class CompiledGraph:
    """One fused instruction stream for a multi-op WorkloadGraph.

    ``segments`` maps each node to its [start, end) slice of ``program`` so
    the simulator can attribute cycles per kernel; DRAM instructions carry
    node-prefixed tags (``"node:in_a"``) for the data-plane binder.  Boundary
    DRAM store/load pairs of resident edges are *absent* from the stream —
    the consumer's compute reads the producer's accumulator wordlines.  The
    first instruction of every segment is a timeline **barrier**: nodes may
    reuse each other's dead wordlines, so modeling cross-node overlap would
    race the reuse.
    """

    program: List[isa.Instr]
    graph: WorkloadGraph
    gm: GraphMapping
    segments: Tuple[Tuple[str, int, int], ...]

    def __iter__(self):
        return iter(self.program)

    def verify(self, cfg: PimsabConfig):
        """Run the compile-time static verifier over the fused stream —
        per-node analyses plus the cross-node residency/live-range checks;
        returns the :class:`~repro_torch.core.compiler.verify.VerifyReport`."""
        from repro_torch.core.compiler.verify import verify_graph

        return verify_graph(self, cfg)


def _addr(mapping: Mapping, name: str) -> int:
    rng = mapping.allocation.ranges.get(name)
    return rng[0][0] if rng else 0


def _alt_addr(mapping: Mapping, name: str, fallback: int) -> int:
    """Start of the second (B) chunk region, or the primary when absent."""
    rng = mapping.allocation.ranges.get(f"{name}.alt") if mapping.allocation else None
    return rng[0][0] if rng else fallback


def _zero(addr: int, prec: int) -> isa.Instr:
    """Bit-serial zeroing idiom: x XOR x (one micro-op per wordline)."""
    return isa.Logical(dst=addr, src1=addr, prec1=prec, src2=addr, prec2=prec, op="xor")


def _tile_groups(tiles_used: int, n_groups: int) -> List[Tuple[int, ...]]:
    """Partition tiles [0, tiles_used) into contiguous streaming groups."""
    n = max(1, min(n_groups, tiles_used))
    bounds = [round(i * tiles_used / n) for i in range(n + 1)]
    return [
        tuple(range(bounds[i], bounds[i + 1]))
        for i in range(n)
        if bounds[i] < bounds[i + 1]
    ]


def compile_workload(
    w: Workload,
    cfg: PimsabConfig,
    hand_tuned: bool = False,
    *,
    mapping: Optional[Mapping] = None,
    elide: FrozenSet[str] = frozenset(),
    tag_prefix: str = "",
) -> CompiledProgram:
    """Lower one workload to its per-tile ISA stream.

    ``mapping`` reuses a precomputed (graph-constrained) distribution instead
    of re-running the search.  ``elide`` ⊆ {"in_a", "in_b", "out"} drops the
    corresponding DRAM instructions — the buffer is CRAM-resident across a
    graph edge and its addresses already alias the neighbour op's allocation.
    ``tag_prefix`` namespaces the data-plane tags *and* the phase tokens per
    graph node.
    """
    m = mapping if mapping is not None else distribute(w, cfg)
    tp = tag_prefix
    prog: List[isa.Instr] = []

    def emit(ins: isa.Instr, phase: Optional[str] = None,
             after: Tuple[Optional[str], ...] = (), barrier: bool = False) -> None:
        prog.append(dataclasses.replace(
            ins,
            phase=(tp + phase) if phase else None,
            after=tuple(tp + a for a in after if a),
            barrier=barrier,
        ))

    pa = w.ins[0].prec
    pb = w.ins[1].prec if len(w.ins) > 1 else pa
    d = w.total_out_elems()
    k = w.reduce_extent()
    a_addr, b_addr = _addr(m, "in_a"), _addr(m, "in_b")
    out_addr = _addr(m, "out") or _addr(m, "acc")
    tmp_addr = _addr(m, "mul_tmp")

    # DRAM totals come from the mapping's reuse-aware model; each loop
    # iteration moves its even share so emitted traffic == analytic traffic.
    a_total = m.dram_split.get("a", 0.0)
    b_total = m.dram_split.get("b", 0.0)
    out_total = m.dram_split.get("out", 0.0)

    if w.op in ("map_add", "map_mul", "relu"):
        pred_addr = _addr(m, "pred")
        const_b = len(w.ins) > 1 and w.ins[1].is_const
        loads_a = "in_a" not in elide
        loads_b = len(w.ins) > 1 and not const_b and "in_b" not in elide
        stores = "out" not in elide
        if const_b and w.op == "map_mul":
            emit(isa.RfLoad(reg=0, value=w.ins[1].const_value or 1), barrier=True)
        a_alt = _alt_addr(m, "in_a", a_addr)
        b_alt = _alt_addr(m, "in_b", b_addr)
        out_alt = _alt_addr(m, "out", out_addr)
        db_a = m.double_buffered and loads_a and a_alt != a_addr
        db_b = m.double_buffered and loads_b and b_alt != b_addr
        db_out = m.double_buffered and stores and out_alt != out_addr
        # single-step kernels stream via staggered tile groups (disjoint
        # tiles: no buffer hazard between groups); multi-step kernels stream
        # via double-buffered serial iterations on the same tiles.  Grouping
        # pays a (groups-1)-deep pipeline-fill tail, so it only engages when
        # the DRAM streams are long enough to amortize it — short transfers
        # already overlap their burst latencies on the pipelined channel.
        stream_est = max(
            a_total if loads_a else 0.0,
            b_total if loads_b else 0.0,
            out_total if stores else 0.0,
        ) / cfg.dram_bw_bits
        if (
            m.serial_iters == 1 and m.tiles_used > 1
            and (loads_a or loads_b or stores)
            and stream_est >= 4 * _MAP_STREAM_GROUPS
        ):
            groups = _tile_groups(m.tiles_used, _MAP_STREAM_GROUPS)
        else:
            # one group spanning the mapping's tiles — explicit, so energy
            # accounting (active tiles) is identical whether or not the
            # stream was split into staggered groups
            groups = [tuple(range(m.tiles_used))]
        n_slices = m.serial_iters * len(groups)
        # prefetching the next step's inputs while this one computes is only
        # *emittable* (program order == functional order) when every loaded
        # operand has a second buffer region to land in
        prefetch = (
            len(groups) == 1
            and (db_a or db_b)
            and (db_a or not loads_a)
            and (db_b or not loads_b)
        )

        def emit_map_loads(i: int, gt: Tuple[int, ...], same_tiles: bool) -> None:
            parity = i % 2
            if loads_a:
                j = (i - 2 if db_a else i - 1) if same_tiles else -1
                emit(isa.DramLoad(
                    tiles=gt, dram_addr=0,
                    cram_addr=a_alt if (db_a and parity) else a_addr,
                    bits=int(a_total / n_slices), prec=pa, tag=tp + "in_a",
                ), phase=f"la{i}", after=(f"cp{j}",) if j >= 0 else ())
            if loads_b:
                j = (i - 2 if db_b else i - 1) if same_tiles else -1
                emit(isa.DramLoad(
                    tiles=gt, dram_addr=0,
                    cram_addr=b_alt if (db_b and parity) else b_addr,
                    bits=int(b_total / n_slices), prec=pb, tag=tp + "in_b",
                ), phase=f"lb{i}", after=(f"cp{j}",) if j >= 0 else ())

        def emit_map_compute(i: int, gt: Tuple[int, ...], same_tiles: bool) -> str:
            parity = i % 2
            aa = a_alt if (db_a and parity) else a_addr
            bb = b_alt if (db_b and parity) else b_addr
            oa = out_alt if (db_out and parity) else out_addr
            war: Tuple[Optional[str], ...] = ()
            if stores and same_tiles:
                # the compute overwrites the out buffer the previous
                # step's store reads (two back when out is A/B-buffered)
                j = i - 2 if db_out else i - 1
                if j >= 0:
                    war = (f"st{j}",)
            cp_after: Tuple[Optional[str], ...] = war + (
                f"la{i}" if loads_a else None, f"lb{i}" if loads_b else None,
            )
            cp = f"cp{i}"
            if w.op == "map_add":
                emit(isa.Add(tiles=gt, dst=oa, prec_dst=m.out_prec,
                             src1=aa, prec1=pa, src2=bb, prec2=pb),
                     phase=cp, after=cp_after)
            elif w.op == "map_mul":
                if const_b:
                    emit(isa.MulConst(tiles=gt, dst=oa, prec_dst=m.out_prec,
                                      src1=aa, prec1=pa, reg=0),
                         phase=cp, after=cp_after)
                else:
                    emit(isa.Mul(tiles=gt, dst=oa, prec_dst=m.out_prec,
                                 src1=aa, prec1=pa, src2=bb, prec2=pb),
                         phase=cp, after=cp_after)
            else:  # relu: out = a where a >= 0 else 0 (predicated copy onto zeros)
                # the zeroing touches only the out buffer — it runs under the
                # DRAM fetch's shadow (no data dependence on the input)
                emit(dataclasses.replace(_zero(oa, m.out_prec), tiles=gt),
                     phase=cp, after=war)
                emit(isa.CmpGE(tiles=gt, dst=pred_addr, src1=aa, prec1=pa,
                               src2=oa, prec2=pa), phase=cp, after=cp_after)
                emit(isa.SetMask(tiles=gt, src=pred_addr), phase=cp, after=cp_after)
                emit(isa.Copy(tiles=gt, dst=oa, prec_dst=m.out_prec, src1=aa,
                              prec1=pa, pred=isa.Pred.MASK), phase=cp, after=cp_after)
            return cp

        def emit_map_store(i: int, gt: Tuple[int, ...]) -> None:
            oa = out_alt if (db_out and i % 2) else out_addr
            emit(isa.DramStore(
                tiles=gt, dram_addr=0, cram_addr=oa,
                bits=int(out_total / n_slices), prec=m.out_prec, tag=tp + "out",
            ), phase=f"st{i}", after=(f"cp{i}",))

        if len(groups) > 1:
            # all group loads first (back-to-back on the DRAM channel: a
            # store waiting on compute must not block a later group's load),
            # computes as each group's slice lands, stores as each finishes
            for g, gt in enumerate(groups):
                emit_map_loads(g, gt, same_tiles=False)
                emit_map_compute(g, gt, same_tiles=False)
            if stores:
                for g, gt in enumerate(groups):
                    emit_map_store(g, gt)
        else:
            gt = groups[0]
            for step in range(m.serial_iters):
                if step == 0 or not prefetch:
                    emit_map_loads(step, gt, same_tiles=True)
                if prefetch and step + 1 < m.serial_iters:
                    # next step's inputs land in the alt regions while this
                    # step computes and its store drains
                    emit_map_loads(step + 1, gt, same_tiles=True)
                emit_map_compute(step, gt, same_tiles=True)
                if stores:
                    emit_map_store(step, gt)

    elif w.op == "mac":
        k_lane = k // m.reduce_split
        n_chunks = max(1, k_lane // m.k_chunk)
        n_phases = m.serial_iters * n_chunks
        const_b = w.ins[1].is_const
        # a tuple const_value is a whole constant-operand *row*: per reduction
        # index j its own RF constant (the decode-GEMV mapping — the single
        # token's activations ride the zero-bit-skipped MacConst path instead
        # of a broadcast CRAM operand).  Requires reduce_split == 1: the RF is
        # shared per tile, so lanes cannot hold different k-slices.
        const_rows = const_b and isinstance(w.ins[1].const_value, tuple)
        if const_rows and m.reduce_split != 1:
            raise ValueError("constant-operand rows need reduce_split == 1")
        loads_a = "in_a" not in elide
        loads_b = (not const_b) and "in_b" not in elide
        stores = "out" not in elide
        if const_b and not const_rows:
            emit(isa.RfLoad(reg=0, value=w.ins[1].const_value or 1), barrier=True)
        a_alt = _alt_addr(m, "in_a", a_addr)
        b_alt = _alt_addr(m, "in_b", b_addr)
        db_a = m.double_buffered and loads_a and a_alt != a_addr
        db_b = m.double_buffered and loads_b and b_alt != b_addr
        # software-pipelined emission: the next chunk's loads are emitted
        # *before* the current chunk's MACs (and before the step's reduce +
        # store), so the DRAM channel never idles behind a store that is
        # itself waiting on compute.  Legal in program order only with A/B
        # buffers — the prefetch lands in the region the MACs are not reading.
        prefetch = (db_a or db_b) and (db_a or not loads_a) and (db_b or not loads_b)
        n_total = m.serial_iters * n_chunks

        def emit_mac_loads(ci: int) -> None:
            parity = ci % 2
            if loads_a:
                # WAR: don't overwrite the chunk the MACs still read —
                # two chunks back with A/B buffers (the prefetch window),
                # one back without
                j = ci - 2 if db_a else ci - 1
                emit(isa.DramLoad(
                    dram_addr=0, cram_addr=a_alt if (db_a and parity) else a_addr,
                    bits=int(a_total / n_phases), prec=pa,
                    tag=tp + "in_a", fields=m.k_chunk,
                ), phase=f"la{ci}", after=(f"cp{j}",) if j >= 0 else ())
            if loads_b:
                # shared operand: one DRAM load, systolic NoC broadcast,
                # H-tree shuffle-distribution to CRAMs (§III-B) — one
                # pipelined instruction (Fig. 5); the timeline lets the
                # receive overlap the previous chunk's compute
                j = ci - 2 if db_b else ci - 1
                emit(isa.DramLoad(
                    dram_addr=0, cram_addr=b_alt if (db_b and parity) else b_addr,
                    bits=int(b_total / n_phases), prec=pb,
                    shf=isa.ShufflePattern.STRIDE,
                    bcast_tiles=m.tiles_used,
                    tag=tp + "in_b", fields=m.k_chunk,
                ), phase=f"lb{ci}", after=(f"cp{j}",) if j >= 0 else ())

        prev_tail: Optional[str] = None  # store (or reduce) of the previous step
        for step in range(m.serial_iters):
            # fresh accumulator; its wordlines are still being read by the
            # previous step's store — wait for it
            emit(_zero(out_addr, m.out_prec), phase=f"z{step}",
                 after=(prev_tail,) if prev_tail else ())
            for kc in range(n_chunks):
                ci = step * n_chunks + kc
                if ci == 0 or not prefetch:
                    emit_mac_loads(ci)
                if prefetch and ci + 1 < n_total:
                    emit_mac_loads(ci + 1)
                aa = a_alt if (db_a and ci % 2) else a_addr
                bb = b_alt if (db_b and ci % 2) else b_addr
                la = f"la{ci}" if loads_a else None
                lb = f"lb{ci}" if loads_b else None
                for j in range(m.k_chunk):
                    if const_b:
                        if const_rows:
                            emit(isa.RfLoad(
                                reg=0,
                                value=int(w.ins[1].const_value[kc * m.k_chunk + j]),
                            ), phase=f"cp{ci}", after=(la, lb))
                        emit(isa.MacConst(
                            dst=out_addr, prec_dst=m.out_prec,
                            src1=aa + j * pa, prec1=pa, reg=0,
                        ), phase=f"cp{ci}", after=(la, lb))
                    else:
                        emit(isa.Mac(
                            dst=out_addr, prec_dst=m.out_prec,
                            src1=aa + j * pa, prec1=pa,
                            src2=bb + j * pb, prec2=pb,
                        ), phase=f"cp{ci}", after=(la, lb))
            tail = f"cp{step * n_chunks + n_chunks - 1}"
            if m.reduce_split > 1:
                emit(isa.ReduceIntra(dst=out_addr, src=out_addr, prec=m.out_prec,
                                     size=min(m.reduce_split, cfg.cram_cols)),
                     phase=f"ri{step}")
                tail = f"ri{step}"
                if m.reduce_split > cfg.cram_cols:
                    emit(isa.ReduceHTree(dst=out_addr, src=out_addr, prec=m.out_prec),
                         phase=f"rh{step}", after=(f"ri{step}",))
                    tail = f"rh{step}"
            if stores:
                # an average pool (div_shift > 0) stores the accumulator read
                # `div_shift` wordlines up: a free arithmetic >> div_shift —
                # the floor divide by the power-of-two window count (§V-C
                # bit-serial-awareness: division by 2^s is an address offset)
                emit(isa.DramStore(
                    dram_addr=0, cram_addr=out_addr + w.div_shift,
                    bits=int(out_total / m.serial_iters),
                    prec=m.out_prec - w.div_shift,
                    tag=tp + "out",
                ), phase=f"st{step}", after=(tail,))
                prev_tail = f"st{step}"
            else:
                prev_tail = tail

    elif w.op == "scan_mac":
        # linear recurrence h_t = a_t · h_{t-1} + b_t, fixed point: the
        # product (frac(a)+frac(h) fraction bits) is renormalized by reading
        # the wordline window shifted up by frac(a) — a free arithmetic >>
        ph = m.out_prec
        fa = w.ins[0].frac
        p_mul = pa + ph
        n_chunks = max(1, k // m.k_chunk)
        h0_total = m.dram_split.get("h0", 0.0)
        a_alt = _alt_addr(m, "in_a", a_addr)
        b_alt = _alt_addr(m, "in_b", b_addr)
        db_a = m.double_buffered and a_alt != a_addr
        db_b = m.double_buffered and b_alt != b_addr
        prefetch = db_a and db_b  # scan always loads both streams
        n_total = m.serial_iters * n_chunks
        chunk_tail: Dict[int, str] = {}  # global chunk -> its last Add token

        def emit_scan_loads(ci: int) -> None:
            parity = ci % 2
            ja = ci - 2 if db_a else ci - 1
            jb = ci - 2 if db_b else ci - 1
            emit(isa.DramLoad(
                dram_addr=0, cram_addr=a_alt if (db_a and parity) else a_addr,
                bits=int(a_total / n_total), prec=pa,
                tag=tp + "in_a", fields=m.k_chunk,
            ), phase=f"la{ci}", after=(chunk_tail.get(ja),))
            emit(isa.DramLoad(
                dram_addr=0, cram_addr=b_alt if (db_b and parity) else b_addr,
                bits=int(b_total / n_total), prec=pb,
                tag=tp + "in_b", fields=m.k_chunk,
            ), phase=f"lb{ci}", after=(chunk_tail.get(jb),))

        ti = 0  # global timestep counter
        for step in range(m.serial_iters):
            emit(isa.DramLoad(
                dram_addr=0, cram_addr=out_addr,
                bits=int(h0_total / m.serial_iters), prec=ph, tag=tp + "h0",
            ), phase=f"lh{step}", after=(f"st{ti - 1}",) if ti else ())
            for kc in range(n_chunks):
                ci = step * n_chunks + kc
                aa = a_alt if (db_a and ci % 2) else a_addr
                bb = b_alt if (db_b and ci % 2) else b_addr
                la, lb = f"la{ci}", f"lb{ci}"
                if ci == 0 or not prefetch:
                    emit_scan_loads(ci)
                if prefetch and ci + 1 < n_total:
                    # next chunk's gate/input streams land in the alt regions
                    # while this chunk's recurrence steps run
                    emit_scan_loads(ci + 1)
                for j in range(m.k_chunk):
                    emit(isa.Mul(
                        dst=tmp_addr, prec_dst=p_mul,
                        src1=aa + j * pa, prec1=pa, src2=out_addr, prec2=ph,
                    ), phase=f"mu{ti}",
                        after=(la, lb, f"lh{step}") if j == 0 and kc == 0 else (la, lb))
                    # the copy overwrites h while the previous timestep's
                    # store still reads it — wait for the CRAM read to drain
                    emit(isa.Copy(dst=out_addr, prec_dst=ph, src1=tmp_addr + fa,
                                  prec1=ph),
                         phase=f"cw{ti}", after=(f"st{ti - 1}",) if ti else ())
                    emit(isa.Add(
                        dst=out_addr, prec_dst=ph, src1=out_addr, prec1=ph,
                        src2=bb + j * pb, prec2=pb,
                    ), phase=f"ad{ti}")
                    emit(isa.DramStore(
                        dram_addr=0, cram_addr=out_addr,
                        bits=int(out_total / (m.serial_iters * k)), prec=ph,
                        tag=tp + "out",
                    ), phase=f"st{ti}", after=(f"ad{ti}",))
                    ti += 1
                chunk_tail[ci] = f"ad{ti - 1}"

    elif w.op == "maxpool":
        # window max: out = a_0, then per remaining window element a CmpGE
        # writes the predicate wordline, SetMask latches it, and a masked Copy
        # keeps the larger value — the paper's predicated-execution idiom
        # (same CmpGE/mask path relu uses).  The whole window is resident
        # (the fold mutates `out` in place), so there is no k-chunking.
        pred_addr = _addr(m, "pred")
        loads_a = "in_a" not in elide
        stores = "out" not in elide
        kk = max(1, k)
        prev_cp: Optional[str] = None
        prev_st: Optional[str] = None
        for step in range(m.serial_iters):
            if loads_a:
                # WAR: the load overwrites the window the previous step's
                # fold still reads
                emit(isa.DramLoad(
                    dram_addr=0, cram_addr=a_addr,
                    bits=int(a_total / m.serial_iters), prec=pa,
                    tag=tp + "in_a", fields=kk,
                ), phase=f"la{step}", after=(prev_cp,) if prev_cp else ())
            la = f"la{step}" if loads_a else None
            war: Tuple[Optional[str], ...] = (prev_st,) if prev_st else ()
            emit(isa.Copy(dst=out_addr, prec_dst=m.out_prec, src1=a_addr,
                          prec1=pa), phase=f"cp{step}", after=war + (la,))
            for j in range(1, kk):
                emit(isa.CmpGE(dst=pred_addr, src1=a_addr + j * pa, prec1=pa,
                               src2=out_addr, prec2=pa),
                     phase=f"cp{step}", after=(la,))
                emit(isa.SetMask(src=pred_addr), phase=f"cp{step}")
                emit(isa.Copy(dst=out_addr, prec_dst=m.out_prec,
                              src1=a_addr + j * pa, prec1=pa,
                              pred=isa.Pred.MASK), phase=f"cp{step}")
            prev_cp = f"cp{step}"
            if stores:
                emit(isa.DramStore(
                    dram_addr=0, cram_addr=out_addr,
                    bits=int(out_total / m.serial_iters), prec=m.out_prec,
                    tag=tp + "out",
                ), phase=f"st{step}", after=(f"cp{step}",))
                prev_st = f"st{step}"

    elif w.op == "kv_append":
        # append-one-row cache update: out = cache with the row selected by a
        # one-hot vector replaced by `new`.  Lanes = cache rows, fields = the
        # head dimension; the one-hot bit latches the PE mask and the new
        # row's fields overwrite only the masked lane — the relu/maxpool
        # predication idiom turned into a scatter.  When the cache is a
        # CRAM-resident persistent state, in_a and out are pinned to the same
        # wordlines (a_addr == out_addr): the update happens in place and the
        # cache never round-trips DRAM — only the new row and the one-hot
        # selector stream in.
        pc_in = w.ins[2].prec
        c_addr = _addr(m, "in_c")
        c_total = m.dram_split.get("c", 0.0)
        loads_a = "in_a" not in elide
        stores = "out" not in elide
        kk = max(1, k)
        prev_cp: Optional[str] = None
        prev_st: Optional[str] = None
        for step in range(m.serial_iters):
            war: Tuple[Optional[str], ...] = (prev_cp,) if prev_cp else ()
            if loads_a:
                emit(isa.DramLoad(
                    dram_addr=0, cram_addr=a_addr,
                    bits=int(a_total / m.serial_iters), prec=pa,
                    tag=tp + "in_a", fields=kk,
                ), phase=f"la{step}", after=war)
            # the new row is shared by every lane: one DRAM load, broadcast
            emit(isa.DramLoad(
                dram_addr=0, cram_addr=b_addr,
                bits=int(b_total / m.serial_iters), prec=pb,
                shf=isa.ShufflePattern.STRIDE, bcast_tiles=m.tiles_used,
                tag=tp + "in_b", fields=kk,
            ), phase=f"lb{step}", after=war)
            emit(isa.DramLoad(
                dram_addr=0, cram_addr=c_addr,
                bits=int(c_total / m.serial_iters), prec=pc_in,
                tag=tp + "in_c",
            ), phase=f"lc{step}", after=war)
            la = f"la{step}" if loads_a else None
            deps: Tuple[Optional[str], ...] = (la, f"lb{step}", f"lc{step}")
            cp = f"cp{step}"
            war_st: Tuple[Optional[str], ...] = (prev_st,) if prev_st else ()
            if a_addr != out_addr:
                for j in range(kk):
                    emit(isa.Copy(dst=out_addr + j * m.out_prec, prec_dst=pa,
                                  src1=a_addr + j * pa, prec1=pa),
                         phase=cp, after=war_st + deps)
            emit(isa.SetMask(src=c_addr), phase=cp, after=deps)
            for j in range(kk):
                emit(isa.Copy(dst=out_addr + j * m.out_prec, prec_dst=pb,
                              src1=b_addr + j * pb, prec1=pb,
                              pred=isa.Pred.MASK), phase=cp, after=deps)
            prev_cp = cp
            if stores:
                for j in range(kk):
                    emit(isa.DramStore(
                        dram_addr=0, cram_addr=out_addr + j * m.out_prec,
                        bits=int(out_total / (m.serial_iters * kk)),
                        prec=m.out_prec, tag=tp + "out",
                    ), phase=f"st{step}", after=(cp,))
                prev_st = f"st{step}"

    elif w.op == "softmax":
        # fixed-point row softmax, §V-C bit-serial-aware end to end:
        #   * exact row max by the CmpGE/SetMask/masked-Copy tournament
        #   * range reduction t>>σ as a *shifted window read* (free >>, the
        #     div_shift path), clamped in the t domain (floor shift is
        #     monotone, so t >= -2^(F+σ) iff t>>σ >= -2^F)
        #   * exp(u) ≈ (1 + u/2^K + u²/2^(2K+1))^(2^K): quadratic Taylor seed
        #     + K squarings, each renormalized by a shifted window read — the
        #     row max comes out as exactly 2^F, so the sum is never zero
        #   * reciprocal of the row sum by restoring division (masked
        #     conditional subtract — the same predication idiom), then one
        #     multiply per element renormalized through the window path
        f, fi = SOFTMAX_F, SOFTMAX_FI
        in_frac = w.ins[0].frac
        sigma = in_frac - f + SOFTMAX_K
        layout, _ = softmax_scratch_layout(pa, in_frac, k)
        sbase = _addr(m, "sm_scratch")
        pred_addr = _addr(m, "pred")

        def sf(name: str) -> Tuple[int, int]:
            off, p = layout[name]
            return sbase + off, p

        m_a, pmx = sf("m")
        s_a, ps = sf("s")
        q_a, pq = sf("q")
        one_a, _ = sf("one")
        t_a, pt = sf("t")
        tcl_a, _ = sf("tcl")
        tfl_a, _ = sf("tfl")
        mul_a, pm = sf("mul")
        v1_a, pv = sf("v1")
        w_a, _ = sf("w")
        onef_a, ponef = sf("onef")
        r_a, pr = sf("r")
        c_a, _ = sf("c")
        rn_a, _ = sf("rn")
        qn_a, _ = sf("qn")
        kk = max(1, k)
        po = m.out_prec
        loads_a = "in_a" not in elide
        stores = "out" not in elide
        prev_cp: Optional[str] = None
        prev_st: Optional[str] = None
        for step in range(m.serial_iters):
            if loads_a:
                emit(isa.DramLoad(
                    dram_addr=0, cram_addr=a_addr,
                    bits=int(a_total / m.serial_iters), prec=pa,
                    tag=tp + "in_a", fields=kk,
                ), phase=f"la{step}", after=(prev_cp,) if prev_cp else ())
            la = f"la{step}" if loads_a else None
            war: Tuple[Optional[str], ...] = (prev_st,) if prev_st else ()
            cp = f"cp{step}"
            dep = war + (la,)
            # constants per lane: one = 1 (the always-true predicate dropped
            # into a zeroed 2-bit field), then RF-multiplied into 2^F and the
            # clamp floor -2^(F+σ)
            emit(isa.Sub(dst=one_a, prec_dst=2, src1=a_addr, prec1=pa,
                         src2=a_addr, prec2=pa), phase=cp, after=dep)
            emit(isa.CmpGE(dst=one_a, src1=a_addr, prec1=pa,
                           src2=a_addr, prec2=pa), phase=cp, after=dep)
            emit(isa.RfLoad(reg=0, value=1 << f), phase=cp)
            emit(isa.MulConst(dst=onef_a, prec_dst=ponef, src1=one_a, prec1=2,
                              reg=0), phase=cp)
            emit(isa.RfLoad(reg=1, value=-(1 << (f + sigma))), phase=cp)
            emit(isa.MulConst(dst=tfl_a, prec_dst=pt, src1=one_a, prec1=2,
                              reg=1), phase=cp)
            # exact row max over the kk resident fields
            emit(isa.Copy(dst=m_a, prec_dst=pmx, src1=a_addr, prec1=pa),
                 phase=cp, after=dep)
            for j in range(1, kk):
                emit(isa.CmpGE(dst=pred_addr, src1=a_addr + j * pa, prec1=pa,
                               src2=m_a, prec2=pa), phase=cp, after=dep)
                emit(isa.SetMask(src=pred_addr), phase=cp)
                emit(isa.Copy(dst=m_a, prec_dst=pmx, src1=a_addr + j * pa,
                              prec1=pa, pred=isa.Pred.MASK), phase=cp)
            emit(isa.Sub(dst=s_a, prec_dst=ps, src1=a_addr, prec1=pa,
                         src2=a_addr, prec2=pa), phase=cp)
            for j in range(kk):
                emit(isa.Sub(dst=t_a, prec_dst=pt, src1=a_addr + j * pa,
                             prec1=pa, src2=m_a, prec2=pmx), phase=cp, after=dep)
                emit(isa.Copy(dst=tcl_a, prec_dst=pt, src1=tfl_a, prec1=pt),
                     phase=cp)
                emit(isa.CmpGE(dst=pred_addr, src1=t_a, prec1=pt,
                               src2=tcl_a, prec2=pt), phase=cp)
                emit(isa.SetMask(src=pred_addr), phase=cp)
                emit(isa.Copy(dst=tcl_a, prec_dst=pt, src1=t_a, prec1=pt,
                              pred=isa.Pred.MASK), phase=cp)
                # u = tcl >> σ read straight out of the shifted window
                emit(isa.Mul(dst=mul_a, prec_dst=pm,
                             src1=tcl_a + sigma, prec1=pt - sigma,
                             src2=tcl_a + sigma, prec2=pt - sigma), phase=cp)
                emit(isa.Add(dst=v1_a, prec_dst=pv,
                             src1=tcl_a + sigma, prec1=pt - sigma,
                             src2=onef_a, prec2=ponef), phase=cp)
                emit(isa.Add(dst=w_a, prec_dst=pv, src1=v1_a, prec1=pv,
                             src2=mul_a + f + 1, prec2=pm - (f + 1)), phase=cp)
                for _ in range(SOFTMAX_K):
                    emit(isa.Mul(dst=mul_a, prec_dst=pm, src1=w_a, prec1=pv,
                                 src2=w_a, prec2=pv), phase=cp)
                    emit(isa.Copy(dst=w_a, prec_dst=pv, src1=mul_a + f,
                                  prec1=pv), phase=cp)
                # exp_j parks in its out field; accumulate the row sum
                emit(isa.Copy(dst=out_addr + j * po, prec_dst=po, src1=w_a,
                              prec1=po), phase=cp)
                emit(isa.Add(dst=s_a, prec_dst=ps, src1=s_a, prec1=ps,
                             src2=out_addr + j * po, prec2=po), phase=cp)
            # inv = floor(2^(FI+F) / s) by restoring division; s >= 2^F
            # always (the max element's exponential is exactly 2^F)
            emit(isa.RfLoad(reg=0, value=1 << (fi + f)), phase=cp)
            emit(isa.MulConst(dst=r_a, prec_dst=pr, src1=one_a, prec1=2,
                              reg=0), phase=cp)
            emit(isa.Sub(dst=q_a, prec_dst=pq, src1=a_addr, prec1=pa,
                         src2=a_addr, prec2=pa), phase=cp)
            for b in range(fi, -1, -1):
                emit(isa.Sub(dst=c_a, prec_dst=pr, src1=a_addr, prec1=pa,
                             src2=a_addr, prec2=pa), phase=cp)
                emit(isa.Copy(dst=c_a + b, prec_dst=ps, src1=s_a, prec1=ps),
                     phase=cp)
                emit(isa.CmpGE(dst=pred_addr, src1=r_a, prec1=pr,
                               src2=c_a, prec2=pr), phase=cp)
                emit(isa.SetMask(src=pred_addr), phase=cp)
                emit(isa.Sub(dst=rn_a, prec_dst=pr, src1=r_a, prec1=pr,
                             src2=c_a, prec2=pr), phase=cp)
                emit(isa.Copy(dst=r_a, prec_dst=pr, src1=rn_a, prec1=pr,
                              pred=isa.Pred.MASK), phase=cp)
                emit(isa.Copy(dst=qn_a, prec_dst=pq, src1=q_a, prec1=pq),
                     phase=cp)
                emit(isa.RfLoad(reg=1, value=1 << b), phase=cp)
                emit(isa.MacConst(dst=qn_a, prec_dst=pq, src1=one_a, prec1=2,
                                  reg=1), phase=cp)
                emit(isa.Copy(dst=q_a, prec_dst=pq, src1=qn_a, prec1=pq,
                              pred=isa.Pred.MASK), phase=cp)
            # normalize in place: p_j = exp_j · inv >> FI (window read again)
            for j in range(kk):
                emit(isa.Mul(dst=mul_a, prec_dst=pm, src1=out_addr + j * po,
                             prec1=po, src2=q_a, prec2=pq), phase=cp)
                emit(isa.Copy(dst=out_addr + j * po, prec_dst=po,
                              src1=mul_a + fi, prec1=po), phase=cp)
            prev_cp = cp
            if stores:
                for j in range(kk):
                    emit(isa.DramStore(
                        dram_addr=0, cram_addr=out_addr + j * po,
                        bits=int(out_total / (m.serial_iters * kk)),
                        prec=po, tag=tp + "out",
                    ), phase=f"st{step}", after=(cp,))
                prev_st = f"st{step}"

    elif w.op == "stencil_mac":
        taps = max(r.stencil for r in w.ins)
        # filter coefficients live in the RF (constants): mul_const path
        for j in range(min(taps, cfg.rf_regs)):
            emit(isa.RfLoad(reg=j, value=2 * j + 1), barrier=True)
        prev_cp: Optional[str] = None
        prev_st: Optional[str] = None
        for step in range(m.serial_iters):
            emit(_zero(out_addr, m.out_prec), phase=f"z{step}",
                 after=(prev_st,) if prev_st else ())
            # the window slides in place (cross-CRAM shifts mutate in_a), so
            # the next load waits for the previous step's last MAC
            emit(isa.DramLoad(
                dram_addr=0, cram_addr=a_addr, bits=int(a_total / m.serial_iters),
                prec=pa, tag=tp + "in_a",
            ), phase=f"la{step}", after=(prev_cp,) if prev_cp else ())
            for j in range(taps):
                if j:
                    # slide the window one lane: cross-CRAM shift (§III-B)
                    emit(isa.Shift(dst=a_addr, src=a_addr, prec=pa, amount=1),
                         phase=f"cp{step}", after=(f"la{step}",))
                emit(isa.MacConst(
                    dst=out_addr, prec_dst=m.out_prec, src1=a_addr, prec1=pa,
                    reg=j % cfg.rf_regs,
                ), phase=f"cp{step}", after=(f"la{step}",))
            prev_cp = f"cp{step}"
            emit(isa.DramStore(
                dram_addr=0, cram_addr=out_addr, bits=int(out_total / m.serial_iters),
                prec=m.out_prec, tag=tp + "out",
            ), phase=f"st{step}", after=(f"cp{step}",))
            prev_st = f"st{step}"
    else:
        raise ValueError(w.op)

    return CompiledProgram(prog, m)


def _data_movement_cycles(w: Workload, m: Mapping, cfg: PimsabConfig,
                          elide: FrozenSet[str]) -> float:
    """Modeled DRAM+NoC cycles of one node under one plan — the residency
    planner's cost function: emit the node's stream (with the plan's elided
    boundaries) and charge it on the analytic simulator.  Uses the *charged*
    buckets (overlap-independent), so the gate is stable under scheduling."""
    from repro_torch.core.simulator import Simulator

    cp = compile_workload(w, cfg, mapping=m, elide=elide)
    res = Simulator(cfg).run(cp.program)
    return res.cycles["dram"] + res.cycles["noc"]


def emit_graph(
    g: WorkloadGraph, cfg: PimsabConfig, gm,
) -> Tuple[List[isa.Instr], Tuple[Tuple[str, int, int], ...]]:
    """Emit the fused per-tile stream for an already-planned ``gm``
    (:class:`GraphMapping`) — each node's segment with its resident
    boundaries elided, first instruction of each segment a barrier.  Shared
    by :func:`compile_graph` and the autotuner's candidate scoring (which
    re-emits the same graph under substituted mappings)."""
    prog: List[isa.Instr] = []
    segments: List[Tuple[str, int, int]] = []
    for w in g.nodes:
        dead = {e.dst_input for e in gm.resident if e.dst == w.name}
        if gm.store_elided(w.name):
            dead.add("out")
        dead |= gm.state_elides(w.name)
        start = len(prog)
        cp = compile_workload(
            w, cfg,
            mapping=gm.mappings[w.name],
            elide=frozenset(dead),
            tag_prefix=f"{w.name}:",
        )
        seg = list(cp.program)
        if seg:
            seg[0] = dataclasses.replace(seg[0], barrier=True)
        prog.extend(seg)
        segments.append((w.name, start, len(prog)))
    return prog, tuple(segments)


def compile_graph(
    g: WorkloadGraph, cfg: PimsabConfig,
    *,
    state_pins=None,
    gm=None,
) -> CompiledGraph:
    """Lower a WorkloadGraph to ONE fused per-tile stream (compile-once).

    Distribution, residency planning and live-range allocation run jointly
    (:func:`distribute_graph`, with the simulator-backed data-movement cost
    model gating each residency decision); each node then emits with the DRAM
    instructions of its resident boundaries elided.  The consumer's elided
    input needs no address fix-up: the live-range allocator pinned it to the
    producer's accumulator wordlines, so the emitted compute reads the value
    in place.  Segment boundaries are timeline barriers (wordline reuse
    across nodes must not race the modeled overlap).

    ``gm`` supplies a pre-planned :class:`GraphMapping` (the autotuner's
    winner) and skips the heuristic planning entirely.
    """
    if gm is None:
        gm = distribute_graph(
            g, cfg,
            cost_fn=lambda w, m, elide: _data_movement_cycles(w, m, cfg, elide),
            state_pins=state_pins,
        )
    prog, segments = emit_graph(g, cfg, gm)
    return CompiledGraph(prog, g, gm, segments)
