"""Multi-chip scale-out: shard a traced Program across a ChipCluster (the
port of the JAX package's ``kernels/multichip.py``).

One pimsab chip cannot serve millions of users.  This module runs an
``api.Program`` on N chips (:class:`repro_torch.core.noc.ChipCluster`) with the
inter-chip interconnect modeled as honestly as the intra-chip NoC/H-tree:

* **Tensor parallelism (TP)** — reduction-dimension (K) sharding of the
  gemm-family ops (``int_matmul``, ``conv2d`` input channels,
  ``bitslice_matmul``, ``decode_gemv``, ``attention_qk`` head dim).  Each
  chip computes a partial int32 accumulation over its K slice; a butterfly
  allreduce combines them.  Because int32 addition is associative mod 2^32,
  the host-modeled wrap-sum is bit-identical to the 1-chip wrap-accumulated
  value — sharding never approximates.
* **Pipeline parallelism (PP)** — contiguous op stages balanced by the
  per-node makespan shares of the 1-chip timing report, with boundary
  activations as point-to-point link transfers.
* **Data parallelism / weak scaling** — every chip replays the whole
  program on its own batch shard; no communication.

The plan (``plan="auto"``) is chosen by the same simulator-backed cost
model that gates residency today: both candidate plans are scheduled on
per-chip phase timelines (one :class:`~repro_torch.core.simulator.Simulator` per
chip sharing wall-clock t=0 and a cluster-wide ``x:``-token namespace) and
the smaller makespan wins.  Cross-chip allreduce lands on the per-resource
timeline as :class:`~repro_torch.core.isa.ChipSend`/``ChipRecv`` phases: the
consumer's *activation* loads gate on the receive token while weight
streaming and compute proceed under the link shadow, so communication
genuinely overlaps compute — and when it can't (no gateable consumer
loads), the plan declines with an ``N-PLAN-CHIP-SERIAL`` note and a
serializing receive.

Functional execution stays bit-exact by construction: each chip is a fresh
tile-batched ``CramBank`` simulator instance running its compiled segment
stream, plus host-modeled link transfers between segments.

As in :mod:`repro_torch.kernels.pimsab_backend`, the bodies are numpy and
torch appears only at the edges: a :class:`ClusterExecutor` copies its
operands to the host, runs every segment on the host's simulator and
returns fresh tensors on the device of its first tensor operand.  It
launches no card kernel, counts no launch, and refuses operands without
values and calls made while the current CUDA stream is captured
(``api.PimsabTracerError``).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import isa
from repro_torch.core.machine import PimsabConfig
from repro_torch.core.noc import ChipCluster, ChipLink
from repro_torch.core import timing as _timing
from repro_torch.core.simulator import Simulator
from repro_torch.kernels import pimsab_backend as pb
from repro_torch.kernels.program import (
    OpCall,
    Program,
    _CudaGraph,
    _dtype_name,
    cached_executable,
    compile_program,
    tree_flatten,
    tree_unflatten,
)

__all__ = [
    "ChipCluster",
    "ChipLink",
    "ClusterExecutor",
    "ClusterReport",
    "compile_cluster",
    "cluster_timing_report",
    "cluster_chip_streams",
    "weak_scaling_report",
    "plan_tp",
    "plan_pp",
    "NOTE_CHIP_TP",
    "NOTE_CHIP_PP",
    "NOTE_CHIP_REPL",
    "NOTE_CHIP_K_INDIVISIBLE",
    "NOTE_CHIP_SERIAL",
]


# plan-decision / plan-decline notes, same convention as
# compiler.distribute.NOTE_* (code prefix + ": " + explanation)
NOTE_CHIP_TP = "N-PLAN-CHIP-TP"                       # TP plan chosen
NOTE_CHIP_PP = "N-PLAN-CHIP-PP"                       # PP plan chosen/declined
NOTE_CHIP_REPL = "N-PLAN-CHIP-REPL"                   # nothing shardable
NOTE_CHIP_K_INDIVISIBLE = "N-PLAN-CHIP-K-INDIVISIBLE"  # K % chips != 0
NOTE_CHIP_SERIAL = "N-PLAN-CHIP-SERIAL"               # allreduce can't overlap


def _note(notes: List[str], code: str, text: str) -> None:
    entry = f"{code}: {text}"
    if entry not in notes:
        notes.append(entry)


# K-shard slice axes per kernel: ((input position, slice axis), ...).  Only
# reduction-dimension sharding is allowed — the per-chip partial sums then
# combine by plain (wrapping) addition, which is exact for the int32
# accumulators every kernel here finalizes into.  attention_pv and the
# average pools are deliberately absent: their floor-shift (``div_shift``)
# is non-linear, so partial-sum sharding would change the value.
_SHARD_AXES: Dict[str, Tuple[Tuple[int, int], ...]] = {
    "int_matmul": ((0, 1), (1, 0)),
    "conv2d": ((0, 1), (1, 1)),          # input channels C (im2col commutes)
    "bitslice_matmul": ((0, 2), (1, 1)),
    "decode_gemv": ((0, 1), (1, 0)),
    "attention_qk": ((0, 1), (1, 1)),    # head dim
}

# boundary-slot precision hints: a value crossing a segment boundary loses
# its producer's ValueMeta (boundary slots carry only an aval), so the
# original field width is re-injected through the lowering's static hint
# kwarg — keeping the sharded workloads identical to the 1-chip lowering
# (softmax's scratch pin in particular affects the computed value).
_HINT_KWARGS: Dict[str, Dict[int, str]] = {
    "int_matmul": {0: "x_bits", 1: "w_bits"},
    "conv2d": {0: "x_bits", 1: "w_bits"},
    "attention_qk": {0: "q_bits", 1: "k_bits"},
    "attention_pv": {0: "p_bits", 1: "v_bits"},
    "decode_gemv": {0: "w_bits", 1: "x_bits"},
    "softmax_fixedpoint": {0: "in_bits"},
}


def _in_aval(program: Program, ref) -> Tuple[Tuple[int, ...], str]:
    kind, j = ref
    if kind == "slot":
        return program.slot_avals[j]
    if kind == "const":
        c = program.consts[j]
        return (tuple(c.shape), _dtype_name(c.dtype))
    return program.ops[j].out_aval


def _dtype_bits(name: str) -> int:
    """Width in bits of a numpy dtype name (``"bfloat16"`` included, which
    numpy itself does not know)."""
    return 16 if name == "bfloat16" else int(np.dtype(name).itemsize * 8)


def _meta_prec(program: Program, lowerings, ref) -> int:
    """Field width of ``ref``'s value as the 1-chip lowering sees it: the
    producer's advertised ValueMeta precision when chainable, else the
    dtype width (exactly ``pimsab_backend._int_in_prec``)."""
    kind, j = ref
    if kind == "node":
        lw = lowerings[j]
        if lw.chainable:
            return int(lw.out_meta.prec)
    shape, dt = _in_aval(program, ref)
    return _dtype_bits(dt)


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Segment:
    """A contiguous (in trace order) slice of the program's ops that compiles
    into one sub-Program.  ``shard`` marks a K-sharded singleton."""

    idxs: Tuple[int, ...]
    shard: Optional[Tuple[Tuple[int, int], ...]] = None


def plan_tp(program: Program, chips: int,
            allow: Optional[set] = None) -> Tuple[Tuple[Segment, ...], List[str]]:
    """Tensor-parallel segmentation: every shardable op (reduction dim
    divisible by ``chips``, distinct operand refs) becomes its own sharded
    segment; maximal runs of everything else replicate on all chips.
    ``allow`` restricts sharding to a cost-model-approved op set."""
    notes: List[str] = []
    segs: List[Segment] = []
    run: List[int] = []
    n_sharded = 0
    for i, op in enumerate(program.ops):
        spec = _SHARD_AXES.get(op.kernel)
        ok = spec is not None and chips > 1
        if ok and allow is not None and i not in allow:
            ok = False
        if ok:
            refs = [op.inputs[pos] for pos, _ in spec]
            if len(set(refs)) != len(refs):
                ok = False  # one value feeding both shard operands
            for pos, ax in spec:
                shape, _ = _in_aval(program, op.inputs[pos])
                if ax >= len(shape) or shape[ax] < chips or shape[ax] % chips:
                    ok = False
            if not ok:
                _note(notes, NOTE_CHIP_K_INDIVISIBLE,
                      f"n{i}.{op.kernel}: reduction dim not divisible by "
                      f"{chips} chips; replicated")
        if ok:
            if run:
                segs.append(Segment(tuple(run)))
                run = []
            segs.append(Segment((i,), shard=spec))
            n_sharded += 1
        else:
            run.append(i)
    if run:
        segs.append(Segment(tuple(run)))
    if n_sharded == 0:
        _note(notes, NOTE_CHIP_REPL,
              f"no shardable op for {chips} chips; whole program replicated")
    else:
        _note(notes, NOTE_CHIP_TP,
              f"{n_sharded}/{len(program.ops)} ops K-sharded over {chips} chips")
    return tuple(segs), notes


def plan_pp(program: Program, per_node_cycles, chips: int
            ) -> Tuple[Optional[Tuple[Segment, ...]], List[str]]:
    """Pipeline-parallel stages: a contiguous partition of the op sequence
    balanced by each node's 1-chip makespan share (the simulator-backed
    cost that also gates residency)."""
    notes: List[str] = []
    n = len(program.ops)
    if n < chips or chips < 2:
        _note(notes, NOTE_CHIP_PP,
              f"declined: {n} ops cannot fill {chips} pipeline stages")
        return None, notes
    total = float(sum(per_node_cycles))
    target = total / chips
    bounds: List[Tuple[int, int]] = []
    start, acc = 0, 0.0
    for i, c in enumerate(per_node_cycles):
        acc += float(c)
        remaining = chips - len(bounds) - 1
        if acc >= target and remaining > 0 and (n - (i + 1)) >= remaining:
            bounds.append((start, i + 1))
            start, acc = i + 1, 0.0
    bounds.append((start, n))
    _note(notes, NOTE_CHIP_PP,
          f"{len(bounds)} stages over {chips} chips "
          f"(per-stage target {target:.0f} cycles)")
    return tuple(Segment(tuple(range(a, b))) for a, b in bounds), notes


# ---------------------------------------------------------------------------
# sub-Program surgery
# ---------------------------------------------------------------------------


def _tree_of(n: int):
    """The argument structure tracing ``n`` positional slots gives."""
    return tree_flatten((tuple(range(n)), {}))[1]


def _out_tree_of(n: int):
    return tree_flatten(tuple(range(n)))[1]


@dataclass
class CompiledSegment:
    seg: Segment
    sub: Program
    slot_srcs: Tuple[Tuple[str, int], ...]   # original ref feeding each slot
    slot_axes: Tuple[Optional[int], ...]     # slice axis per slot (sharded)
    out_srcs: Tuple[int, ...]                # original op idx per output
    ctp: Any = None                          # CompiledTracedProgram (functional)
    cg_t: Any = None                         # timing CompiledGraph
    report: Any = None                       # per-segment timing SimReport


def _sub_program(program: Program, lowerings, seg: Segment, chips: int,
                 name: str) -> CompiledSegment:
    """Extract ``seg`` into a standalone Program: in-segment node refs stay
    node refs, everything crossing the boundary becomes a slot (sliced for a
    sharded segment), consts are re-indexed, and boundary field widths are
    re-injected as static hint kwargs so the lowering matches the 1-chip
    compile."""
    idxs = seg.idxs
    inset = set(idxs)
    local = {j: i for i, j in enumerate(idxs)}
    shard = dict(seg.shard or ())
    slot_srcs: List[Tuple[str, int]] = []
    slot_avals: List[Tuple[Tuple[int, ...], str]] = []
    slot_axes: List[Optional[int]] = []
    slot_of: Dict[Tuple[str, int], int] = {}
    consts: List[torch.Tensor] = []
    const_of: Dict[int, int] = {}
    sub_ops: List[OpCall] = []

    def slot_for(ref, aval, axis) -> Tuple[str, int]:
        if ref not in slot_of:
            slot_of[ref] = len(slot_srcs)
            slot_srcs.append(ref)
            slot_avals.append(aval)
            slot_axes.append(axis)
        return ("slot", slot_of[ref])

    for i in idxs:
        op = program.ops[i]
        new_inputs: List[Tuple[str, int]] = []
        kw = dict(op.kwargs)
        hints = _HINT_KWARGS.get(op.kernel, {})
        for pos, ref in enumerate(op.inputs):
            kind, j = ref
            aval = _in_aval(program, ref)
            boundary = False
            if seg.shard is not None:
                # sharded singleton: every input becomes a (sliced) slot —
                # consts too, so one compiled sub-program serves all chips
                ax = shard.get(pos)
                shape = list(aval[0])
                if ax is not None:
                    shape[ax] //= chips
                new_inputs.append(slot_for(ref, (tuple(shape), aval[1]), ax))
                boundary = True
            elif kind == "node" and j in inset:
                new_inputs.append(("node", local[j]))
            elif kind == "const":
                if j not in const_of:
                    const_of[j] = len(consts)
                    consts.append(program.consts[j])
                new_inputs.append(("const", const_of[j]))
            else:
                new_inputs.append(slot_for(ref, aval, None))
                boundary = kind == "node"
            if boundary and pos in hints and kw.get(hints[pos]) is None:
                kw[hints[pos]] = _meta_prec(program, lowerings, ref)
        sub_ops.append(OpCall(
            kernel=op.kernel,
            inputs=tuple(new_inputs),
            kwargs=tuple(sorted(kw.items())),
            out_aval=op.out_aval,
        ))

    consumed = set()
    for k, op2 in enumerate(program.ops):
        if k in inset:
            continue
        for (kind, j) in op2.inputs:
            if kind == "node" and j in inset:
                consumed.add(j)
    for (kind, j) in program.out_refs:
        if kind == "node" and j in inset:
            consumed.add(j)
    out_idxs = [i for i in idxs if i in consumed]
    if seg.shard is not None or not out_idxs:
        out_idxs = [idxs[-1]] if seg.shard is None else [idxs[0]]
    out_refs = tuple(("node", local[i]) for i in out_idxs)
    sub = Program(
        name=name,
        ops=tuple(sub_ops),
        n_slots=len(slot_srcs),
        slot_avals=tuple(slot_avals),
        consts=tuple(consts),
        in_tree=_tree_of(len(slot_srcs)),
        out_tree=_out_tree_of(len(out_refs)),
        out_refs=out_refs,
    )
    return CompiledSegment(
        seg=seg, sub=sub, slot_srcs=tuple(slot_srcs),
        slot_axes=tuple(slot_axes), out_srcs=tuple(out_idxs),
    )


def _compile_segment(cs: CompiledSegment, *, functional: bool, verify: bool,
                     tc: Any, cfg_timing: Optional[PimsabConfig] = None
                     ) -> CompiledSegment:
    """Compile one segment, cached on the sub-program signature (the global
    compile cache, like every other executable)."""
    sub = cs.sub
    tune = tc if tc is not None else False
    if functional:
        key = ("mcseg-fn", sub.signature(), pb._functional_cfg(),
               cfg_timing, bool(verify), tc)
        ctp = cached_executable(key, lambda: pb.compile_traced_program(
            sub, cfg_timing=cfg_timing, verify=verify, tune=tune))
        return dataclasses.replace(cs, ctp=ctp, cg_t=ctp.cg_t, report=ctp.report)
    cfg = cfg_timing or pb.TIMING_CFG
    key = ("mcseg-t", sub.signature(), cfg, bool(verify), tc)
    cg_t, report = cached_executable(key, lambda: pb.compile_timing_program(
        sub, cfg, verify=verify, tune=tune))
    return dataclasses.replace(cs, cg_t=cg_t, report=report)


# ---------------------------------------------------------------------------
# cluster timeline (timing)
# ---------------------------------------------------------------------------


def _payload_bits(program: Program, op_idx: int) -> int:
    shape, _ = program.ops[op_idx].out_aval
    return int(np.prod(shape, dtype=np.int64)) * 32 if shape else 32


# how many segments ahead the scheduler may prefetch externally-fed DRAM
# streams (weights/consts) into an open allreduce window — one double-buffer
# of lookahead per intervening light segment, not unbounded staging
PREFETCH_LOOKAHEAD = 2


def _step_stream(sim: Simulator, instrs, prefix: str,
                 gates: Optional[List[Tuple[str, str]]] = None,
                 skip: Optional[set] = None) -> None:
    """Step a compiled segment stream, namespacing its phase tokens with
    ``prefix`` (segments reuse node names across sub-programs) and gating
    any DramLoad whose tag matches a pending cross-chip receive.  ``skip``
    holds stream indices already issued by the prefetch pass."""
    for idx, ins in enumerate(instrs):
        if skip and idx in skip:
            continue
        rep: Dict[str, Any] = {}
        if ins.phase is not None:
            rep["phase"] = prefix + ins.phase
        if ins.after:
            rep["after"] = tuple(prefix + a for a in ins.after)
        if gates and isinstance(ins, isa.DramLoad) and ins.tag:
            for base, tok in gates:
                if ins.tag == base or ins.tag.startswith(base + "."):
                    rep["after"] = rep.get("after", ()) + (tok,)
                    if ins.phase is None and not ins.after and not ins.barrier:
                        rep["barrier"] = True  # keep its barrier semantics
                    break
        sim.step(dataclasses.replace(ins, **rep) if rep else ins)


def _external_load_tags(cs: CompiledSegment) -> set:
    """Tag bases of DRAM streams fed by *external* values — original program
    slots or consts, which exist before the cluster schedule starts.  Only
    these may prefetch into an allreduce window: anything node-sourced is
    either allreduce-gated or ordered by the segment barriers."""
    tags = set()
    for li, op in enumerate(cs.sub.ops):
        for pos, (kind, j) in enumerate(op.inputs):
            ext = kind == "const" or (
                kind == "slot" and cs.slot_srcs[j][0] in ("slot", "const"))
            if ext:
                buf = ("in_a", "in_b", "in_c")[pos] if pos < 3 else f"in{pos}"
                tags.add(f"n{li}.{op.kernel}:{buf}")
    return tags


def _hoist_loads(sims: List[Simulator], cs: CompiledSegment, prefix: str,
                 window_end: float, done: set) -> None:
    """Issue the segment's externally-fed DramLoads early, filling the open
    allreduce window: greedy in stream order while the DRAM channel still
    frees up before the collective lands (prefetch past the window would
    push the on-chip frontier instead of hiding under the link).  TP
    timelines are symmetric, so one decision replays on every chip."""
    ext = _external_load_tags(cs)
    for idx, ins in enumerate(cs.cg_t.program):
        if idx in done or not isinstance(ins, isa.DramLoad) or not ins.tag:
            continue
        base = ins.tag.split(".alt", 1)[0]
        if base not in ext and ins.tag not in ext:
            continue
        if sims[0]._free.get("dram", 0.0) >= window_end:
            break
        rep: Dict[str, Any] = {}
        if ins.phase is not None:
            rep["phase"] = prefix + ins.phase
        if ins.after:
            rep["after"] = tuple(prefix + a for a in ins.after)
        hoisted_ins = dataclasses.replace(ins, **rep) if rep else ins
        for sim in sims:
            sim.step(hoisted_ins)
        done.add(idx)


def _consumer_gates(csegs: List[CompiledSegment], k: int
                    ) -> Dict[int, List[str]]:
    """Tag bases of every later-segment DramLoad streaming segment ``k``'s
    allreduced value (the activation loads that must wait for the receive;
    weight streams and compute keep going under the link shadow)."""
    p = csegs[k].seg.idxs[0]
    gates: Dict[int, List[str]] = {}
    for m in range(k + 1, len(csegs)):
        cs = csegs[m]
        for si, ref in enumerate(cs.slot_srcs):
            if ref != ("node", p):
                continue
            for li, op in enumerate(cs.sub.ops):
                for pos, r2 in enumerate(op.inputs):
                    if r2 == ("slot", si):
                        buf = ("in_a", "in_b", "in_c")[pos] if pos < 3 else f"in{pos}"
                        gates.setdefault(m, []).append(f"n{li}.{op.kernel}:{buf}")
    return gates


def _gates_present(csegs: List[CompiledSegment],
                   gates: Dict[int, List[str]]) -> bool:
    """A gate is usable only if the consumer segment's compiled stream
    actually carries a matching tagged load."""
    for m, bases in gates.items():
        tags = {i.tag for i in csegs[m].cg_t.program
                if isinstance(i, isa.DramLoad) and i.tag}
        for base in bases:
            if any(t == base or t.startswith(base + ".") for t in tags):
                return True
    return False


def _tp_timeline(program: Program, csegs: List[CompiledSegment],
                 cluster: ChipCluster, cfg: PimsabConfig, *, overlap: bool,
                 notes: Optional[List[str]] = None, record: bool = False
                 ) -> Tuple[List[Simulator], int]:
    """Schedule the TP plan on per-chip phase timelines sharing wall-clock
    t=0 and the cross-chip ``x:`` token namespace.  Returns the per-chip
    simulators and the total bits moved over the interconnect."""
    C = cluster.chips
    cfg = cluster.timing_cfg(cfg)
    shared: Dict[str, float] = {}
    sims = [Simulator(cfg, shared_tokens=shared, record_stream=record)
            for _ in range(C)]
    link_bits = 0
    gate_map: Dict[int, List[Tuple[str, str]]] = {}
    hoisted: Dict[int, set] = {}
    for k, cs in enumerate(csegs):
        for c in range(C):
            _step_stream(sims[c], cs.cg_t.program, f"s{k}|", gate_map.get(k),
                         skip=hoisted.get(k))
        if cs.seg.shard is None or C <= 1:
            continue
        bits = _payload_bits(program, cs.seg.idxs[0])
        port = cluster.allreduce_port_bits(bits)
        link_bits += port * C
        send_toks = tuple(f"x:ar{k}:c{c}" for c in range(C))
        for c in range(C):
            sims[c].step(isa.ChipSend(chip=c, peer=-1, bits=port, rounds=1,
                                      phase=f"x:ar{k}:c{c}", tag=f"ar{k}"))
        if overlap:
            # prefetch: stream the next segments' weight/const DRAM traffic
            # under the collective's link shadow
            window = max(shared.get(t, 0.0) for t in send_toks)
            window += cluster.link.stream_cycles(port)
            window += cluster.link.latency_cycles * (cluster.allreduce_rounds() + 1)
            for m in range(k + 1, min(k + 1 + PREFETCH_LOOKAHEAD, len(csegs))):
                _hoist_loads(sims, csegs[m], f"s{m}|", window,
                             hoisted.setdefault(m, set()))
        gates = _consumer_gates(csegs, k)
        gateable = overlap and bool(gates) and _gates_present(csegs, gates)
        if overlap and gates and not gateable and notes is not None:
            _note(notes, NOTE_CHIP_SERIAL,
                  f"allreduce after segment {k} has no gateable consumer "
                  "load; receive serializes")
        done_tok = f"ar{k}.done"
        for c in range(C):
            sims[c].step(isa.ChipRecv(
                chip=c, peer=-1, bits=port, rounds=cluster.allreduce_rounds(),
                sync=not gateable, phase=done_tok, after=send_toks,
                tag=f"ar{k}",
            ))
        if gateable:
            for m, bases in gates.items():
                gate_map.setdefault(m, []).extend(
                    (base, done_tok) for base in bases)
    return sims, link_bits


def _pp_timeline(program: Program, csegs: List[CompiledSegment],
                 cluster: ChipCluster, cfg: PimsabConfig, *,
                 record: bool = False) -> Tuple[List[Simulator], int]:
    """Pipeline stages: chip i runs stage i; boundary activations are
    point-to-point link transfers, received with ``sync=True`` (a stage
    cannot start before its input lands)."""
    C = cluster.chips
    cfg = cluster.timing_cfg(cfg)
    shared: Dict[str, float] = {}
    sims = [Simulator(cfg, shared_tokens=shared, record_stream=record)
            for _ in range(C)]
    link_bits = 0
    produced_by: Dict[int, int] = {}
    for i, cs in enumerate(csegs):
        for j in cs.seg.idxs:
            produced_by[j] = i
    for i, cs in enumerate(csegs):
        chip = min(i, C - 1)
        sim = sims[chip]
        if i > 0:
            bits = sum(
                _payload_bits(program, j)
                for (kind, j) in cs.slot_srcs
                if kind == "node" and produced_by.get(j, i) < i
            )
            if bits:
                hops = max(1, cluster.chip_hops(min(i - 1, C - 1), chip))
                sim.step(isa.ChipRecv(chip=chip, peer=min(i - 1, C - 1),
                                      bits=bits, rounds=hops, sync=True,
                                      phase=f"pp{i}.in", after=(f"x:pp{i}",),
                                      tag=f"pp{i}"))
                link_bits += bits
        for ins_prefix in (f"s{i}|",):
            _step_stream(sim, cs.cg_t.program, ins_prefix)
        if i < len(csegs) - 1:
            bits_out = sum(
                _payload_bits(program, j)
                for j in cs.out_srcs
                if any(
                    ("node", j) in csegs[m].slot_srcs
                    for m in range(i + 1, len(csegs))
                )
            )
            hops = max(1, cluster.chip_hops(chip, min(i + 1, C - 1)))
            sim.step(isa.ChipSend(chip=chip, peer=min(i + 1, C - 1),
                                  bits=max(bits_out, 32), rounds=hops,
                                  phase=f"x:pp{i + 1}", tag=f"pp{i + 1}"))
            link_bits += max(bits_out, 32)
    return sims, link_bits


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------


@dataclass
class ClusterReport:
    """Aggregated multi-chip timing: the overlapped cluster makespan, the
    overlap-declined (serializing receives) variant, and the fully
    serialized charged-bucket total, plus per-chip timeline views — the
    ``max(busy) <= makespan <= serialized`` invariant holds per chip."""

    workload: str
    plan: str                         # "tp" | "pp" | "replicated" | "single" | "dp"
    chips: int
    mesh: Tuple[int, int]
    total_cycles: float               # max over chips, overlap on
    serial_cycles: float              # max over chips, overlap declined
    serialized_cycles: float          # sum of charged buckets over chips
    overlapped_cycles: float          # serial_cycles - total_cycles
    link_bits: int
    per_chip: Tuple[Dict[str, Any], ...]
    energy_pj: Dict[str, float]
    energy_j: float
    modeled_seconds: float
    notes: Tuple[str, ...]
    segments: Tuple[Dict[str, Any], ...]
    baseline_cycles: float = 0.0      # 1-chip whole-program makespan

    @property
    def speedup(self) -> float:
        return self.baseline_cycles / self.total_cycles if self.total_cycles else 1.0

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["speedup"] = self.speedup
        return d


def _report_from(workload: str, plan: str, cluster: ChipCluster,
                 cfg: PimsabConfig, sims: List[Simulator],
                 serial_sims: Optional[List[Simulator]], link_bits: int,
                 notes: List[str], csegs: List[CompiledSegment],
                 baseline: float) -> ClusterReport:
    per_chip = tuple(
        {
            "chip": c,
            "makespan": s.res.makespan,
            "serialized_cycles": s.res.serialized_cycles,
            "busy": dict(s.res.busy),
            "cycles": dict(s.res.cycles),
        }
        for c, s in enumerate(sims)
    )
    total = max((p["makespan"] for p in per_chip), default=0.0)
    serial = (
        max((s.res.makespan for s in serial_sims), default=0.0)
        if serial_sims is not None else total
    )
    serialized = sum(p["serialized_cycles"] for p in per_chip)
    energy: Dict[str, float] = {}
    for s in sims:
        for kcat, v in s.res.energy.pj.items():
            energy[kcat] = energy.get(kcat, 0.0) + v
    segments = tuple(
        {
            "ops": list(cs.seg.idxs),
            "kind": "sharded" if cs.seg.shard is not None else "replicated",
            "name": cs.sub.name,
        }
        for cs in csegs
    )
    return ClusterReport(
        workload=workload,
        plan=plan,
        chips=cluster.chips,
        mesh=cluster.mesh,
        total_cycles=total,
        serial_cycles=serial,
        serialized_cycles=serialized,
        overlapped_cycles=max(0.0, serial - total),
        link_bits=link_bits,
        per_chip=per_chip,
        energy_pj=energy,
        energy_j=sum(energy.values()) * 1e-12,
        modeled_seconds=_timing.seconds(cfg, total),
        notes=tuple(notes),
        segments=segments,
        baseline_cycles=baseline,
    )


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def resolve_cluster(chips: Optional[int] = None,
                    cluster: Optional[ChipCluster] = None) -> ChipCluster:
    """Default cluster shape for N chips: 1×1, 1×2, 2×2, 2×4 — the scaling
    suite's mesh ladder."""
    if cluster is not None:
        return cluster
    c = int(chips or 1)
    if c < 1:
        raise ValueError(f"chips must be >= 1, got {c}")
    if c <= 2:
        mesh = (1, c)
    else:
        rows = 2
        if c % rows:
            mesh = (1, c)
        else:
            mesh = (rows, c // rows)
    return ChipCluster(mesh=mesh)


def _resolve_tc(tune: Any):
    from repro_torch.core.compiler import autotune

    return autotune.resolve(tune) if tune is not None else autotune.active()


def _plan_and_compile(program: Program, cluster: ChipCluster, *,
                      plan: str, verify: bool, tc: Any,
                      cfg_timing: Optional[PimsabConfig], functional: bool
                      ) -> Tuple[str, List[CompiledSegment], ClusterReport]:
    """Shared core of :func:`compile_cluster` and
    :func:`cluster_timing_report`: segment the program under each candidate
    plan, schedule both on the cluster timeline, and let the smaller
    makespan win (``plan="auto"``)."""
    cfg = cfg_timing or pb.TIMING_CFG
    C = cluster.chips
    _, lowerings, _ = pb._build_graph(program)

    # 1-chip baseline: the whole program as one segment (also the weak-
    # scaling / single-chip stream)
    whole = _sub_program(program, lowerings,
                         Segment(tuple(range(len(program.ops)))), C,
                         f"{program.name}.whole")
    whole = _compile_segment(whole, functional=functional, verify=verify,
                             tc=tc, cfg_timing=cfg_timing)
    baseline = float(whole.report.total_cycles)

    if C == 1:
        sims, _ = _tp_timeline(program, [whole], cluster, cfg, overlap=True)
        rep = _report_from(program.name, "single", cluster, cfg, sims, None,
                           0, [], [whole], baseline)
        return "single", [whole], rep

    candidates: List[Tuple[str, List[CompiledSegment], ClusterReport]] = []

    # --- replicated fallback ----------------------------------------------
    # always a candidate: N copies of the 1-chip stream, zero communication
    # (latency == baseline; throughput scales with N via batch replication)
    sims_repl, _ = _tp_timeline(program, [whole], cluster, cfg, overlap=True)
    repl_notes: List[str] = []
    _note(repl_notes, NOTE_CHIP_REPL,
          f"whole program replicated on {C} chips (no inter-chip traffic)")
    repl_rep = _report_from(program.name, "replicated", cluster, cfg,
                            sims_repl, None, 0, repl_notes, [whole], baseline)
    candidates.append(("replicated", [whole], repl_rep))

    # --- tensor parallel ---------------------------------------------------
    # two passes: feasibility (divisibility), then a per-op cost filter —
    # shard an op only when its sharded segment plus the full (unoverlapped)
    # allreduce beats the op compiled standalone.  Conservative on purpose:
    # the schedule may still hide part of the collective, so every approved
    # shard is a clear win and the strong-scaling curve stays monotone.
    tp_segs, tp_notes = plan_tp(program, C)
    notes_tp = list(tp_notes)
    keep: set = set()
    for s in tp_segs:
        if s.shard is None:
            continue
        i = s.idxs[0]
        cs_sh = _compile_segment(
            _sub_program(program, lowerings, s, C,
                         f"{program.name}.tp{C}.n{i}"),
            functional=False, verify=verify, tc=tc, cfg_timing=cfg_timing)
        cs_un = _compile_segment(
            _sub_program(program, lowerings, Segment((i,)), C,
                         f"{program.name}.solo.n{i}"),
            functional=False, verify=verify, tc=tc, cfg_timing=cfg_timing)
        ar = cluster.allreduce_cycles(_payload_bits(program, i))
        if cs_sh.report.total_cycles + ar < cs_un.report.total_cycles:
            keep.add(i)
        else:
            _note(notes_tp, NOTE_CHIP_TP,
                  f"n{i}.{program.ops[i].kernel}: sharding declined by cost "
                  f"model ({cs_sh.report.total_cycles:.0f}+{ar:.0f} allreduce "
                  f">= {cs_un.report.total_cycles:.0f} replicated)")
    if keep != {s.idxs[0] for s in tp_segs if s.shard is not None}:
        tp_segs, _ = plan_tp(program, C, allow=keep)
    sharded = any(s.shard is not None for s in tp_segs)
    if sharded:
        tp_csegs = [
            _compile_segment(
                _sub_program(program, lowerings, s, C,
                             f"{program.name}.tp{C}.s{i}"),
                functional=functional, verify=verify, tc=tc,
                cfg_timing=cfg_timing,
            )
            for i, s in enumerate(tp_segs)
        ]
        sims_ov, linkb = _tp_timeline(program, tp_csegs, cluster, cfg,
                                      overlap=True, notes=notes_tp)
        sims_ser, _ = _tp_timeline(program, tp_csegs, cluster, cfg,
                                   overlap=False)
        tp_rep = _report_from(program.name, "tp", cluster, cfg, sims_ov,
                              sims_ser, linkb, notes_tp, tp_csegs, baseline)
        candidates.append(("tp", tp_csegs, tp_rep))
    else:
        _note(repl_notes, NOTE_CHIP_REPL,
              "tensor-parallel sharding declined for every op")
        repl_rep.notes = tuple(repl_notes + notes_tp)

    # --- pipeline parallel -------------------------------------------------
    if plan in ("auto", "pp"):
        per_node = [pk["total_cycles"] for pk in whole.report.per_kernel]
        pp_segs, pp_notes = plan_pp(program, per_node, C)
        if pp_segs is not None:
            pp_csegs = [
                _compile_segment(
                    _sub_program(program, lowerings, s, C,
                                 f"{program.name}.pp{C}.s{i}"),
                    functional=functional, verify=verify, tc=tc,
                    cfg_timing=cfg_timing,
                )
                for i, s in enumerate(pp_segs)
            ]
            sims_pp, linkb_pp = _pp_timeline(program, pp_csegs, cluster, cfg)
            pp_rep = _report_from(program.name, "pp", cluster, cfg, sims_pp,
                                  sims_pp, linkb_pp, list(pp_notes),
                                  pp_csegs, baseline)
            candidates.append(("pp", pp_csegs, pp_rep))
        elif plan == "pp":
            raise ValueError(
                f"pipeline plan requested but declined: {pp_notes}")

    if plan == "tp":
        candidates = [c for c in candidates if c[0] in ("tp", "replicated")]
    elif plan == "pp":
        candidates = [c for c in candidates if c[0] == "pp"]
    if not candidates:
        raise ValueError(f"no feasible plan {plan!r} for {program.name!r}")
    chosen = min(candidates, key=lambda c: c[2].total_cycles)
    # the competing candidates' makespans are part of the decision record
    others = [
        f"{name}={rep.total_cycles:.0f}cyc"
        for name, _, rep in candidates
    ]
    notes = list(chosen[2].notes)
    _note(notes, NOTE_CHIP_TP if chosen[0] != "pp" else NOTE_CHIP_PP,
          f"plan {chosen[0]!r} chosen by cost model ({', '.join(others)})")
    chosen[2].notes = tuple(notes)
    return chosen


def cluster_timing_report(program: Program, chips: Optional[int] = None,
                          cluster: Optional[ChipCluster] = None, *,
                          plan: str = "auto", verify: bool = True,
                          tune: Any = None,
                          cfg_timing: Optional[PimsabConfig] = None
                          ) -> ClusterReport:
    """Timing-only multi-chip schedule (no functional compile) — how the
    paper-shaped networks (RESNET18) get their scaling curves."""
    cluster = resolve_cluster(chips, cluster)
    _, _, rep = _plan_and_compile(
        program, cluster, plan=plan, verify=verify, tc=_resolve_tc(tune),
        cfg_timing=cfg_timing, functional=False)
    return rep


def cluster_chip_streams(program: Program, chips: Optional[int] = None,
                         cluster: Optional[ChipCluster] = None, *,
                         plan: str = "auto", verify: bool = True,
                         tune: Any = None,
                         cfg_timing: Optional[PimsabConfig] = None
                         ) -> List[List[isa.Instr]]:
    """The exact per-chip instruction streams the chosen cluster plan
    schedules — segment streams with cluster-prefixed phases plus the
    ChipSend/ChipRecv collective rounds interleaved exactly where the
    timeline placed them.  ``scripts/check_isa.py`` re-runs the static
    verifier over each chip's stream, so the gate covers the link phases
    and not just the single-chip segment bodies."""
    cluster = resolve_cluster(chips, cluster)
    cfg = cfg_timing or pb.TIMING_CFG
    chosen, csegs, _ = _plan_and_compile(
        program, cluster, plan=plan, verify=verify, tc=_resolve_tc(tune),
        cfg_timing=cfg_timing, functional=False)
    if chosen == "pp":
        sims, _ = _pp_timeline(program, csegs, cluster, cfg, record=True)
    else:
        sims, _ = _tp_timeline(program, csegs, cluster, cfg, overlap=True,
                               record=True)
    return [list(sim.stream or ()) for sim in sims]


def weak_scaling_report(program: Program, chips: Optional[int] = None,
                        cluster: Optional[ChipCluster] = None, *,
                        verify: bool = True, tune: Any = None,
                        cfg_timing: Optional[PimsabConfig] = None
                        ) -> ClusterReport:
    """Weak scaling / data parallelism: every chip replays the whole
    program on its own batch shard — zero inter-chip communication, so the
    per-chip makespan is flat and throughput scales with N by construction."""
    cluster = resolve_cluster(chips, cluster)
    cfg = cfg_timing or pb.TIMING_CFG
    tc = _resolve_tc(tune)
    _, lowerings, _ = pb._build_graph(program)
    whole = _sub_program(program, lowerings,
                         Segment(tuple(range(len(program.ops)))),
                         cluster.chips, f"{program.name}.whole")
    whole = _compile_segment(whole, functional=False, verify=verify, tc=tc,
                             cfg_timing=cfg_timing)
    sim = Simulator(cluster.timing_cfg(cfg))
    _step_stream(sim, whole.cg_t.program, "s0|")
    sims = [sim] * cluster.chips
    notes: List[str] = []
    _note(notes, NOTE_CHIP_REPL,
          f"weak scaling: {cluster.chips} chips, one batch replica each, "
          "no inter-chip communication")
    rep = _report_from(program.name, "dp", cluster, cfg, sims, None, 0,
                       notes, [whole], float(whole.report.total_cycles))
    return rep


class ClusterExecutor:
    """A Program compiled for a ChipCluster.  Call it like the single-chip
    pimsab :class:`~repro_torch.kernels.program.Executor`; execution walks
    the segment schedule — each chip a fresh tile-batched ``CramBank``
    simulator instance — with host-modeled link transfers (the bit-exact
    wrap-sum allreduce) between segments.

    Operands are copied to the host; every output returns as a fresh tensor
    on the device of the first tensor operand (a slot output as the operand
    itself, a constant output as the captured constant).  A call while the
    current CUDA stream is captured, and an operand without values (a meta
    tensor or a trace placeholder), raise ``api.PimsabTracerError``."""

    def __init__(self, program: Program, cluster: ChipCluster, plan: str,
                 csegs: List[CompiledSegment], report: ClusterReport):
        self.program = program
        self.backend = "pimsab"
        self.cluster = cluster
        self.plan = plan
        self.report = report
        self._segments = csegs
        self.verify_reports = tuple(
            vr for cs in csegs for vr in (cs.ctp.verify_reports if cs.ctp else ())
        )

    @property
    def notes(self) -> Tuple[str, ...]:
        return self.report.notes

    def __call__(self, *args, **kwargs):
        leaves, in_tree = tree_flatten((args, kwargs))
        if in_tree != self.program.in_tree:
            raise TypeError(
                f"ClusterExecutor({self.program.name!r}) called with a "
                f"different argument structure than it was traced with:\n"
                f"  traced: {self.program.in_tree}\n  got:    {in_tree}"
            )
        out_leaves = self._run(leaves)
        return tree_unflatten(self.program.out_tree, out_leaves)

    def _run(self, leaves: List[Any]) -> List[Any]:
        from repro_torch.kernels.api import PimsabTracerError, static_value

        prog = self.program
        if _CudaGraph.capturing():
            raise PimsabTracerError(
                f"ClusterExecutor({prog.name!r}) runs on the 'pimsab' backend, "
                "which copies its operands to the host; a CUDA graph capture "
                "on the current stream cannot hold that: call it outside the "
                "capture"
            )
        C = self.cluster.chips
        env: Dict[int, np.ndarray] = {}

        def resolve(ref) -> np.ndarray:
            kind, j = ref
            if kind == "slot":
                v = static_value(leaves[j])
                if v is None:
                    raise PimsabTracerError(
                        f"cluster execution of {prog.name!r} needs operands "
                        f"that hold values, but input leaf {j} is a "
                        f"{type(leaves[j]).__name__} without them (a meta "
                        "tensor or a trace placeholder)"
                    )
                return pb._as_numpy(v)
            if kind == "const":
                return pb._as_numpy(prog.consts[j])
            return env[j]

        for cs in self._segments:
            in_vals = [resolve(r) for r in cs.slot_srcs]
            if cs.seg.shard is not None and C > 1:
                partial: Optional[np.ndarray] = None
                for c in range(C):
                    sliced = [
                        v if ax is None else _slice_leaf(v, ax, C, c)
                        for v, ax in zip(in_vals, cs.slot_axes)
                    ]
                    outs = pb.execute_traced_program(cs.ctp, sliced)
                    p = pb._as_numpy(outs[0]).astype(np.int64)
                    partial = p if partial is None else partial + p
                env[cs.out_srcs[0]] = _wrap_int32(partial)
            else:
                outs = pb.execute_traced_program(cs.ctp, in_vals)
                for out, j in zip(outs, cs.out_srcs):
                    env[j] = pb._as_numpy(out)
        like = next((l for l in leaves if isinstance(l, torch.Tensor)), None)
        out_leaves: List[Any] = []
        for kind, j in prog.out_refs:
            if kind == "node":
                out_leaves.append(pb._to_torch(env[j], like))
            elif kind == "slot":
                out_leaves.append(leaves[j])
            else:
                out_leaves.append(prog.consts[j])
        return out_leaves


def _slice_leaf(v: np.ndarray, ax: int, chips: int, c: int) -> np.ndarray:
    n = v.shape[ax] // chips
    idx = [slice(None)] * v.ndim
    idx[ax] = slice(c * n, (c + 1) * n)
    return v[tuple(idx)]


def _wrap_int32(s: np.ndarray) -> np.ndarray:
    """Mod-2^32 wrap of the int64 partial-sum — exactly the int32 value the
    1-chip CRAM accumulator would have wrapped to (associativity of addition
    mod 2^32 is what makes K-sharding bit-exact)."""
    return ((s.astype(np.int64) + 2**31) % 2**32 - 2**31).astype(np.int32)


def compile_cluster(program: Program, chips: Optional[int] = None,
                    cluster: Optional[ChipCluster] = None, *,
                    plan: str = "auto", verify: bool = True,
                    tune: Any = None) -> Any:
    """Compile ``program`` for a ChipCluster and return a callable executor.

    ``chips=1`` (or a 1×1 cluster) falls through to the ordinary
    single-chip :func:`~repro_torch.kernels.program.compile_program` path.  The
    executor is cached on (program signature, cluster, plan, verify, tune)
    like every other compiled artifact."""
    cluster = resolve_cluster(chips, cluster)
    if cluster.chips == 1:
        return compile_program(program, "pimsab", verify=verify, tune=tune)
    if plan not in ("auto", "tp", "pp"):
        raise ValueError(f"unknown cluster plan {plan!r}")
    tc = _resolve_tc(tune)
    key = ("cluster", program.signature(), cluster, plan, bool(verify), tc,
           pb._functional_cfg())

    def build() -> ClusterExecutor:
        chosen_plan, csegs, rep = _plan_and_compile(
            program, cluster, plan=plan, verify=verify, tc=tc,
            cfg_timing=None, functional=True)
        return ClusterExecutor(program, cluster, chosen_plan, csegs, rep)

    return cached_executable(key, build)
