"""Parallelism distribution (§V-B): exhaustive search over tilings.

Inter-tile: only *data-parallel* loops map across tiles (partial sums never
cross tiles — the H-tree makes intra-tile reduction cheap, the NoC makes
inter-tile reduction expensive).  Intra-tile: data loops map to the
256 CRAMs × 256 bitlines; reduction loops either run serially per lane
(accumulate in place) or split across lanes/CRAMs and fold through the
intra-CRAM tree + H-tree.

Each exploration point is checked against the two §V-B constraints
(parallel degree ≤ lanes; CRAM buffer ≤ 256 wordlines after the §V-C
optimizations) and scored by the two objectives in order: compute-resource
occupancy, then DRAM traffic.
"""
from __future__ import annotations

import math
import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from repro_torch.core.machine import PimsabConfig
from repro_torch.core.compiler.tensor_dsl import GraphEdge, Workload, WorkloadGraph, out_buffer
from repro_torch.core.compiler.allocation import (
    Allocation,
    BufferReq,
    adaptive_precision,
    allocate,
    allocate_graph,
    mul_live_window,
    softmax_scratch_layout,
)

# ---------------------------------------------------------------------------
# plan-note codes (the machine-readable channel)
#
# Every decline/decision note carries a stable ``N-PLAN-*`` code prefix so
# the autotuner and tests can key on the *kind* of decision without matching
# prose.  The verifier promotes the prefix into the Diagnostic code (see
# ``verify.note_code``); un-coded legacy notes fall back to plain ``N-PLAN``.
# ---------------------------------------------------------------------------
NOTE_RS_SPLIT = "N-PLAN-RS-SPLIT"          # reduction lane-split chosen
NOTE_DB_ON = "N-PLAN-DB-ON"                # double buffering engaged
NOTE_DB_DECLINED = "N-PLAN-DB-DECLINED"    # alt chunk regions don't fit
NOTE_DB_DROPPED = "N-PLAN-DB-DROPPED"      # joint allocator relief valve
NOTE_WORDLINES = "N-PLAN-WL"               # naive->optimized wordline count
NOTE_CHAIN_SHAPE = "N-PLAN-CHAIN-SHAPE"    # mac shared-operand shape mismatch
NOTE_PROD_LAYOUT = "N-PLAN-PROD-LAYOUT"    # producer can't go lane-contiguous
NOTE_CONS_LAYOUT = "N-PLAN-CONS-LAYOUT"    # consumer can't match producer tiling
NOTE_RES_PIN = "N-PLAN-RES-PIN"            # producer re-pinned for residency
NOTE_RES_COST = "N-PLAN-RES-COST"          # fused plan models no movement win
NOTE_RES_DROPPED = "N-PLAN-RES-DROPPED"    # joint allocator dropped residency
NOTE_STATE_TILE = "N-PLAN-STATE-TILE"      # updater pinned to one tile
NOTE_STATE_LAYOUT = "N-PLAN-STATE-LAYOUT"  # updater layout not in-place capable
NOTE_STATE_COST = "N-PLAN-STATE-COST"      # state pin models no movement win
NOTE_STATE_ON = "N-PLAN-STATE-ON"          # persistent state CRAM-resident
NOTE_STATE_DROPPED = "N-PLAN-STATE-DROPPED"  # allocator dropped the state pins
NOTE_TUNED = "N-PLAN-TUNED"                # mapping replaced by the autotuner


def _note(notes: List[str], code: str, text: str) -> None:
    """Append ``"{code}: {text}"``, deduping exact repeats — retried
    candidates (the tuner, the allocator relief valves) re-run the same
    decline paths and must not multiply identical notes."""
    n = f"{code}: {text}"
    if n not in notes:
        notes.append(n)


def note_code(note: str) -> str:
    """The stable machine-readable prefix of a plan note (``N-PLAN-*``),
    or plain ``"N-PLAN"`` for un-coded legacy notes."""
    head, sep, _ = note.partition(":")
    if sep and head.startswith("N-PLAN-") and " " not in head:
        return head
    return "N-PLAN"


@dataclass
class Mapping:
    workload: Workload
    tiles_used: int
    lanes_used: int           # bitlines busy per tile
    serial_iters: int         # output chunks executed serially
    k_chunk: int              # reduction chunk resident per serial step
    reduce_split: int         # lanes the reduction is split across (1 = none)
    out_prec: int             # adaptive-precision accumulator width
    allocation: Allocation = field(default=None)
    dram_bits: float = 0.0
    dram_split: Dict[str, float] = field(default_factory=dict)  # a/b/out bits
    occupancy: float = 0.0
    double_buffered: bool = False  # A/B operand chunks (second CRAM region)
    notes: List[str] = field(default_factory=list)

    def plan_notes(self) -> List[Tuple[str, str]]:
        """The plan's decline/decision notes as ``(node, note)`` pairs — the
        structured channel the verifier re-emits as ``N-PLAN`` diagnostics
        (and the compile cache records per entry)."""
        return [(self.workload.name, n) for n in self.notes]

    def to_json(self):
        return {
            "workload": self.workload.name,
            "tiles_used": self.tiles_used,
            "lanes_used": self.lanes_used,
            "serial_iters": self.serial_iters,
            "k_chunk": self.k_chunk,
            "reduce_split": self.reduce_split,
            "out_prec": self.out_prec,
            "occupancy": self.occupancy,
            "dram_bits": self.dram_bits,
            "double_buffered": self.double_buffered,
            "allocation": self.allocation.to_json() if self.allocation else None,
            "notes": self.notes,
        }


def _buffer_reqs(
    w: Workload, k_chunk: int, out_prec: int, use_lifetime: bool = True,
    reduce_split: int = 1, cram_cols: int = 256,
) -> List[BufferReq]:
    """Per-bitline wordline requirements for one serial step (Fig. 7 model)."""
    reqs: List[BufferReq] = []
    pa = w.ins[0].prec
    pb = w.ins[1].prec if len(w.ins) > 1 else pa
    # a lane-split reduction folds through the intra-CRAM tree in place: the
    # accumulator block must also hold the tree's sign-extended operand and
    # shift scratch — 2·(P + log2 stages) contiguous wordlines (§V-C); the
    # stage count must mirror codegen's ReduceIntra(size=min(rs, cram_cols))
    def acc_words(p: int) -> int:
        if reduce_split <= 1:
            return p
        stages = int(math.log2(min(reduce_split, cram_cols)))
        return 2 * (p + stages)

    if w.op in ("map_add", "map_mul", "relu"):
        reqs.append(BufferReq("in_a", pa, pa))
        if len(w.ins) > 1 and not w.ins[1].is_const:
            reqs.append(BufferReq("in_b", pb, pb))
        reqs.append(BufferReq("out", out_prec, w.acc_prec))
        if w.op == "relu":
            reqs.append(BufferReq("pred", 1, 1))  # CmpGE predicate wordline
    elif w.op == "maxpool":
        # the whole window is resident per lane: the CmpGE+masked-copy fold
        # mutates `out` in place, so the window cannot stream in chunks
        kk = max(1, w.reduce_extent())
        reqs.append(BufferReq("in_a", kk * pa, kk * pa))
        reqs.append(BufferReq("out", out_prec, w.acc_prec))
        reqs.append(BufferReq("pred", 1, 1))
    elif w.op == "scan_mac":
        # sequential recurrence: both streams are data-parallel per lane; the
        # product tmp is full-width (its high bits are read back for the
        # >> frac renormalization, so no half-width live window applies)
        reqs.append(BufferReq("in_a", k_chunk * pa, k_chunk * pa))
        reqs.append(BufferReq("in_b", k_chunk * pb, k_chunk * pb))
        reqs.append(BufferReq("acc", out_prec, w.acc_prec))
        p_mul = pa + out_prec
        reqs.append(BufferReq("mul_tmp", p_mul, p_mul))
    elif w.op == "stencil_mac":
        # the window slides via cross-CRAM lane shifts (§III-B) — only the
        # current element + a shifting copy are resident; taps live in the RF
        reqs.append(BufferReq("in_a", 2 * pa, 2 * pa))
        reqs.append(BufferReq("acc", out_prec, w.acc_prec))
        p_mul = pa + pb
        window = mul_live_window(p_mul) if use_lifetime else p_mul
        reqs.append(BufferReq("mul_tmp", window, p_mul))
    elif w.op == "mac":
        reqs.append(BufferReq("in_a", k_chunk * pa, k_chunk * pa))
        if not w.ins[1].is_const:
            reqs.append(BufferReq("in_b", k_chunk * pb, k_chunk * pb))
        reqs.append(BufferReq("acc", acc_words(out_prec), acc_words(w.acc_prec)))
        p_mul = pa + pb
        window = mul_live_window(p_mul) if use_lifetime else p_mul
        reqs.append(BufferReq("mul_tmp", window, p_mul))
    elif w.op == "kv_append":
        # in-place one-hot row scatter: the whole cache row set is resident
        # per lane (lane = row, fields = head dim), like maxpool's window
        kk = max(1, w.reduce_extent())
        reqs.append(BufferReq("in_a", kk * pa, kk * pa))
        reqs.append(BufferReq("in_b", kk * pb, kk * pb))
        reqs.append(BufferReq("in_c", w.ins[2].prec, w.ins[2].prec))
        reqs.append(BufferReq("out", kk * out_prec, kk * w.acc_prec))
    elif w.op == "softmax":
        # whole row resident per lane (the max/sum folds read every field);
        # scratch layout shared with codegen via softmax_scratch_layout
        kk = max(1, w.reduce_extent())
        reqs.append(BufferReq("in_a", kk * pa, kk * pa))
        reqs.append(BufferReq("out", kk * out_prec, kk * w.acc_prec))
        _, scratch = softmax_scratch_layout(pa, w.ins[0].frac, kk)
        reqs.append(BufferReq("sm_scratch", scratch, scratch))
        reqs.append(BufferReq("pred", 1, 1))
    else:
        raise ValueError(w.op)
    return reqs


# streamed operand buffers that may take a second (A/B) region so the next
# chunk's DRAM transfer overlaps the current chunk's compute; accumulators
# and in-place-shifted windows are excluded (their values carry across phases)
_DB_BUFFERS = {
    "mac": ("in_a", "in_b"),
    "scan_mac": ("in_a", "in_b"),
    "map_add": ("in_a", "in_b", "out"),
    "map_mul": ("in_a", "in_b", "out"),
    "relu": ("in_a", "out"),
}


def mapping_buffer_reqs(
    w: Workload, m: "Mapping", cfg: PimsabConfig, *,
    double_buffered: Optional[bool] = None,
) -> List[BufferReq]:
    """The wordline requirements of ``m``'s plan, including the second A/B
    chunk regions when the mapping is double-buffered."""
    reqs = _buffer_reqs(
        w, m.k_chunk, m.out_prec,
        reduce_split=m.reduce_split, cram_cols=cfg.cram_cols,
    )
    db = m.double_buffered if double_buffered is None else double_buffered
    if db:
        by = {r.name: r for r in reqs}
        for name in _DB_BUFFERS.get(w.op, ()):
            r = by.get(name)
            if r is not None:
                reqs.append(BufferReq(f"{name}.alt", r.wordlines, r.naive_wordlines))
    return reqs


def _dram_bits(w: Workload, cfg: PimsabConfig, tiles: int, bcast_b: bool) -> Dict[str, float]:
    """Total chip DRAM traffic (bits) with reuse: broadcast operands loaded
    once; data-parallel operands loaded once per element; out stored once.
    Returns the per-stream split {a, b, out}."""
    d = w.total_out_elems()
    k = w.reduce_extent()
    pa = w.ins[0].prec
    split = {"a": 0.0, "b": 0.0, "out": float(d * w.out.prec)}
    if w.op in ("map_add", "map_mul", "relu"):
        split["a"] = d * pa
        if len(w.ins) > 1 and not w.ins[1].is_const:
            split["b"] = d * w.ins[1].prec
    elif w.op == "maxpool":
        split["a"] = d * k * pa  # every window element streams in once
    elif w.op == "stencil_mac":
        split["a"] = d * pa  # each element loaded once; taps slide via shifts
    elif w.op == "scan_mac":
        # every timestep's (a_t, b_t) is loaded once and every state h_t is
        # stored (the recurrence output is the whole trajectory); the initial
        # state streams in once per lane
        split["a"] = d * k * pa
        split["b"] = d * k * w.ins[1].prec
        split["out"] = float(d * k * w.out.prec)
        split["h0"] = float(d * w.out.prec)
    elif w.op == "kv_append":
        # the cache streams in and the updated cache streams out — unless a
        # ResidentState pins both in place, which elides streams a and out
        # entirely; the new row is one broadcast load, the one-hot one per lane
        split["a"] = d * k * pa
        split["b"] = k * w.ins[1].prec
        split["c"] = float(d * w.ins[2].prec)
        split["out"] = float(d * k * w.out.prec)
    elif w.op == "softmax":
        split["a"] = d * k * pa
        split["out"] = float(d * k * w.out.prec)
    else:
        split["a"] = d * k * pa / max(_reuse_a(w), 1)  # loaded once per use÷reuse
        if len(w.ins) > 1 and not w.ins[1].is_const:
            pb = w.ins[1].prec
            # b is the shared operand: one DRAM load + on-chip broadcast
            split["b"] = k * pb * _reuse_b(w) if not bcast_b else k * pb * _b_width(w)
    return split


def _reuse_b(w: Workload) -> int:
    return 1


def _b_width(w: Workload) -> int:
    """Distinct b columns (e.g. gemm N): b tensor is k×N loaded once."""
    b_idx = {n.split(".")[0] for n in w.ins[1].index} if len(w.ins) > 1 else set()
    width = 1
    for l in w.data_loops:
        if l.name.split(".")[0] in b_idx:
            width *= l.extent
    return width


def _reuse_a(w: Workload) -> int:
    """How many outputs reuse one `a` element (e.g. gemm: N columns)."""
    a_idx = set(w.ins[0].index)
    reuse = 1
    for l in w.data_loops:
        base = l.name.split(".")[0]
        if base not in {n.split(".")[0] for n in a_idx}:
            reuse *= l.extent
    return reuse


def _b_tiles(w: Workload) -> int:
    """Distinct b-slices (broadcast granularity)."""
    return 1


def distribute(
    w: Workload,
    cfg: PimsabConfig,
    *,
    tile_constraint: Optional[int] = None,
    rs_constraint: Optional[int] = None,
    k_chunk_constraint: Optional[int] = None,
    strict: bool = True,
) -> Optional[Mapping]:
    """Pick the best feasible mapping of ``w`` onto ``cfg``.

    ``tile_constraint``/``rs_constraint``/``k_chunk_constraint`` restrict the
    exploration (graph compilation pins a consumer to its producer's tiling
    and a producer to the lane-contiguous ``reduce_split=1`` layout so the
    boundary value can stay CRAM-resident; a mac whose *shared* operand is
    resident additionally needs its whole reduction window in one chunk).
    With ``strict=False`` an empty feasible set returns ``None`` instead of
    raising (constrained probes fall back).
    """
    k = w.reduce_extent()

    best: Optional[Mapping] = None
    # --- exhaustive exploration (small space, §V-B) -----------------------
    tile_options = [t for t in range(1, cfg.num_tiles + 1)]
    if tile_constraint is not None:
        tile_options = [tile_constraint]
    rs_options = _rs_options(w, cfg)
    if rs_constraint is not None:
        rs_options = [r for r in rs_options if r == rs_constraint] or []
    for tiles in tile_options:
        for reduce_split in rs_options:
            if k % reduce_split:
                continue
            kc_opts = _k_chunk_options(w, k // reduce_split)
            if k_chunk_constraint is not None:
                kc_opts = [kc for kc in kc_opts if kc == k_chunk_constraint]
            for k_chunk in kc_opts:
                m = _mapping_at(w, cfg, tiles, reduce_split, k_chunk)
                if m is not None and (best is None or _better(m, best)):
                    best = m
    if best is None:
        if not strict:
            return None
        raise RuntimeError(
            f"{w.name}: no feasible parallelism distribution — the developer "
            "must supply a more conservative loop organization (§V-A feedback)"
        )
    if best.reduce_split > 1:
        _note(best.notes, NOTE_RS_SPLIT,
              f"reduction split {best.reduce_split}x across lanes, folded via intra-CRAM tree + H-tree")
    # --- double-buffering upgrade (§III overlap): a multi-phase schedule
    # gets second A/B chunk regions when the CRAM capacity allows, letting
    # codegen prefetch the next chunk's operands during the current compute.
    # If the alt regions don't fit at the chosen k_chunk, *shrink* the chunk
    # (more, smaller phases): half the resident reduction window buys the
    # second buffer, and the extra per-burst latencies pipeline away.
    if _phases(best) > 1 and _DB_BUFFERS.get(w.op):
        k_lane = max(1, w.reduce_extent() // best.reduce_split)
        kc_options = sorted(
            {kc for kc in range(1, best.k_chunk + 1) if k_lane % kc == 0},
            reverse=True,
        )
        if k_chunk_constraint is not None:
            kc_options = [kc for kc in kc_options if kc == k_chunk_constraint]
        for kc in kc_options:
            trial = dataclasses.replace(best, k_chunk=kc, notes=list(best.notes))
            db_alloc = allocate(
                mapping_buffer_reqs(w, trial, cfg, double_buffered=True),
                cfg.cram_rows,
            )
            if db_alloc.feasible:
                trial.double_buffered = True
                trial.allocation = db_alloc
                note = (
                    "double-buffered A/B operand chunks: next chunk's DRAM "
                    "transfer overlaps current compute"
                )
                if kc < best.k_chunk:
                    note += f" (k_chunk {best.k_chunk}->{kc} to fit the alt regions)"
                _note(trial.notes, NOTE_DB_ON, note)
                best = trial
                break
        else:
            _note(best.notes, NOTE_DB_DECLINED,
                  "double buffering declined: alt chunk buffers exceed CRAM rows")
    _note(best.notes, NOTE_WORDLINES, _wordlines_note(w, best, cfg))
    return best


def _wordlines_note(w: Workload, m: Mapping, cfg: PimsabConfig) -> str:
    naive = sum(r.naive_wordlines for r in _buffer_reqs(
        w, m.k_chunk, w.acc_prec, use_lifetime=False,
        reduce_split=m.reduce_split, cram_cols=cfg.cram_cols))
    opt = sum(r.wordlines for r in _buffer_reqs(
        w, m.k_chunk, m.out_prec,
        reduce_split=m.reduce_split, cram_cols=cfg.cram_cols))
    return f"wordlines {naive}->{opt} after adaptive precision + bit-level lifetime"


def _rs_options(w: Workload, cfg: PimsabConfig) -> List[int]:
    """Reduction lane-split choices: none, a CRAM sub-group, a full CRAM, or
    all lanes of the tile (the last folds through the H-tree across CRAMs);
    sequential scans never split — the recurrence carries per lane."""
    k = w.reduce_extent()
    if w.op == "mac" and k > 1:
        opts = sorted({1, 16, cfg.cram_cols, cfg.pes_per_tile})
    else:
        opts = [1]
    if (w.op == "mac" and len(w.ins) > 1 and w.ins[1].is_const
            and isinstance(w.ins[1].const_value, tuple)):
        # per-row constants ride the RF path, which is shared per tile: each
        # reduction index needs its own RfLoad, so the reduction stays whole
        # per lane (decode_gemv's constant-operand rows)
        opts = [1]
    return opts


def _mapping_at(
    w: Workload, cfg: PimsabConfig, tiles: int, reduce_split: int,
    k_chunk: int, *, double_buffered: bool = False,
    out_prec: Optional[int] = None,
) -> Optional[Mapping]:
    """One exploration point of the §V-B space, or ``None`` when the CRAM
    capacity constraint rejects it.  ``out_prec=None`` takes the adaptive-
    precision accumulator; a wider explicit value models the non-bit-serial-
    aware layout (a tuner axis — strictly more compute passes, but a valid
    verified schedule)."""
    lanes = cfg.pes_per_tile
    d = w.total_out_elems()
    k = w.reduce_extent()
    pa = w.ins[0].prec
    pb = w.ins[1].prec if len(w.ins) > 1 else pa
    if k % reduce_split:
        return None
    per_tile = -(-d // tiles)
    lanes_needed = per_tile * reduce_split
    lanes_used = min(lanes, lanes_needed)
    serial = -(-lanes_needed // lanes)
    if out_prec is None:
        out_prec = min(adaptive_precision(pa, pb, k, w.op), w.acc_prec)
    m = Mapping(
        workload=w, tiles_used=tiles, lanes_used=lanes_used,
        serial_iters=serial, k_chunk=k_chunk,
        reduce_split=reduce_split, out_prec=out_prec,
        double_buffered=double_buffered,
    )
    alloc = allocate(mapping_buffer_reqs(w, m, cfg), cfg.cram_rows)
    if not alloc.feasible:
        return None
    m.allocation = alloc
    m.occupancy = (tiles * lanes_used) / (cfg.num_tiles * lanes)
    dram = _dram_bits(w, cfg, tiles, bcast_b=True)
    m.dram_split = dram
    m.dram_bits = sum(dram.values())
    return m


def mapping_candidates(
    w: Workload,
    cfg: PimsabConfig,
    *,
    tile_constraint: Optional[int] = None,
    rs_constraint: Optional[int] = None,
    k_chunk_constraint: Optional[int] = None,
    db_constraint: Optional[bool] = None,
) -> List[Mapping]:
    """Every feasible mapping of ``w`` over the full search space — the
    candidate generator behind :mod:`repro_torch.core.compiler.autotune`.

    Axes: tile count × reduction lane-split × ``k_chunk`` × double-buffering
    × accumulator width (adaptive-precision narrow vs full ``acc_prec`` —
    the bit-serial-aware vs wider per-pass layouts).  The constraints mirror
    :func:`distribute`'s (graph residency pins them); ``db_constraint``
    additionally pins the double-buffering axis.  Feasibility is the same
    CRAM-capacity check ``distribute`` applies; scoring is the caller's job.
    """
    k = w.reduce_extent()
    pa = w.ins[0].prec
    pb = w.ins[1].prec if len(w.ins) > 1 else pa
    tile_options = (
        list(range(1, cfg.num_tiles + 1))
        if tile_constraint is None else [tile_constraint]
    )
    rs_options = _rs_options(w, cfg)
    if rs_constraint is not None:
        rs_options = [r for r in rs_options if r == rs_constraint]
    db_options = (False, True) if _DB_BUFFERS.get(w.op) else (False,)
    if db_constraint is not None:
        db_options = tuple(d for d in db_options if d == db_constraint)
    prec_options = sorted({
        min(adaptive_precision(pa, pb, k, w.op), w.acc_prec), w.acc_prec,
    })
    out: List[Mapping] = []
    for tiles in tile_options:
        for rs in rs_options:
            if k % rs:
                continue
            kc_opts = _k_chunk_options(w, k // rs)
            if k_chunk_constraint is not None:
                kc_opts = [kc for kc in kc_opts if kc == k_chunk_constraint]
            for kc in kc_opts:
                for db in db_options:
                    for op in prec_options:
                        m = _mapping_at(
                            w, cfg, tiles, rs, kc,
                            double_buffered=db, out_prec=op,
                        )
                        if m is not None:
                            out.append(m)
    return out


def _k_chunk_options(w: Workload, k_per_lane: int) -> List[int]:
    if w.op not in ("mac", "stencil_mac", "scan_mac") or k_per_lane <= 1:
        return [1]
    divs = [d for d in range(1, min(k_per_lane, 64) + 1) if k_per_lane % d == 0]
    return divs or [1]


def _phases(m: Mapping) -> int:
    k_lane = max(1, m.workload.reduce_extent() // m.reduce_split)
    return m.serial_iters * max(1, k_lane // m.k_chunk)


def _better(a: Mapping, b: Mapping) -> bool:
    """Primary: occupancy; secondary: DRAM traffic; tertiary: fewer transfer
    phases (each phase pays DRAM burst latency + broadcast serialization)."""
    if abs(a.occupancy - b.occupancy) > 1e-9:
        return a.occupancy > b.occupancy
    if abs(a.dram_bits - b.dram_bits) > 1:
        return a.dram_bits < b.dram_bits
    return _phases(a) < _phases(b)


# ---------------------------------------------------------------------------
# graph distribution: producer→consumer residency
# ---------------------------------------------------------------------------

# consumer ops that read their inputs lane-contiguously, one element per lane
# (maxpool is NOT one: each of its output lanes gathers a whole window of
# input elements, so it can never read a producer's output in place)
_MAP_OPS = ("map_add", "map_mul", "relu")


def _chain_candidate(w: Workload, e: GraphEdge) -> bool:
    """Can ``w`` read the producer of ``e`` in place, layout permitting?

    Map ops read any input one-element-per-lane.  A mac can chain its
    *shared* operand (in_b): the mac expects lane y to hold the reduction
    fields of output column y, which is exactly what a field-major producer
    (kv_append: lane = row, fields = head dim) leaves behind — provided the
    whole reduction window is one resident chunk (checked at plan time via
    ``k_chunk_constraint``) and the shapes line up (``_mac_chain_shape_ok``).
    """
    if w.op in _MAP_OPS:
        return e.dst_input in ("in_a", "in_b")
    if w.op == "mac" and len(w.ins) > 1 and not w.ins[1].is_const:
        return e.dst_input == "in_b"
    return False


def _mac_chain_shape_ok(w_dst: Workload, w_src: Workload) -> bool:
    """Producer lane t must be consumer output column t, producer field j
    must be consumer reduction index j — extents must match exactly."""
    return (
        w_src.total_out_elems() == w_dst.total_out_elems()
        and w_src.reduce_extent() == w_dst.reduce_extent()
    )


@dataclass
class GraphMapping:
    """Per-node mappings + the residency decisions for one WorkloadGraph."""

    graph: WorkloadGraph
    mappings: Dict[str, Mapping]
    resident: Tuple[GraphEdge, ...] = ()
    elided_bits: Dict[str, float] = field(default_factory=dict)  # "node:stream" -> bits
    notes: List[str] = field(default_factory=list)
    # node -> buffer -> fixed wordline ranges of a cross-program persistent
    # state (ResidentState): the state updater's input and output alias the
    # same reserved region, so both its DRAM streams are elided
    state_pins: Dict[str, Dict[str, List[Tuple[int, int]]]] = field(default_factory=dict)
    # nodes whose output must land in DRAM even if every consumer chains:
    # a DECLINED state updater's post-append cache is only visible to the
    # host through its store (the accepted path harvests the reserved
    # wordlines instead, so elision is safe there)
    must_store: Set[str] = field(default_factory=set)

    def is_resident(self, dst: str, dst_input: str) -> bool:
        return any(e.dst == dst and e.dst_input == dst_input for e in self.resident)

    def state_elides(self, name: str) -> set:
        """Streams of ``name`` elided because they alias a persistent-state
        region (seeded before the program runs, harvested after)."""
        return set(self.state_pins.get(name, ())) & {"in_a", "in_b", "out"}

    def state_reserved(self) -> List[Tuple[int, int]]:
        """Union of all persistent-state wordline ranges — carved out of
        every node's free set, and pre-marked live for the verifier."""
        out: List[Tuple[int, int]] = []
        for pins in self.state_pins.values():
            for ranges in pins.values():
                out.extend(tuple(r) for r in ranges)
        return sorted(set(out))

    def plan_notes(self) -> List[Tuple[str, str]]:
        """Graph-level + per-node plan notes as ``(node, note)`` pairs
        (graph-level notes use ``""``) — why residency or double buffering
        was declined lives here, and the verifier re-emits each pair as an
        ``N-PLAN`` diagnostic so ``compile_cache_info`` entries record it."""
        out: List[Tuple[str, str]] = [("", n) for n in self.notes]
        for m in self.mappings.values():
            out.extend(m.plan_notes())
        return out

    def store_elided(self, src: str) -> bool:
        """The producer's DRAM store is dropped only when *every* consumer
        reads the value in place and nothing outside the program needs it."""
        outs = self.graph.out_edges(src)
        return (
            bool(outs)
            and src not in self.graph.outputs
            and src not in self.must_store
            and all(e in self.resident for e in outs)
        )

    @property
    def total_elided_bits(self) -> float:
        return sum(self.elided_bits.values())

    def to_json(self) -> Dict:
        return {
            "graph": self.graph.name,
            "mappings": {n: m.to_json() for n, m in self.mappings.items()},
            "resident": [
                {"src": e.src, "dst": e.dst, "dst_input": e.dst_input}
                for e in self.resident
            ],
            "elided_bits": dict(self.elided_bits),
            "notes": list(self.notes),
            "state_pins": {
                n: {b: [list(r) for r in rr] for b, rr in pins.items()}
                for n, pins in self.state_pins.items()
            },
        }


def _producer_layout_ok(m: Mapping) -> bool:
    """Producer output must be lane-contiguous (element o at lane o) and fully
    resident in one serial step, or the consumer would read stale wordlines."""
    return m.serial_iters == 1 and m.reduce_split == 1


def _consumer_layout_ok(mc: Mapping, mp: Mapping) -> bool:
    return (
        mc.serial_iters == 1
        and mc.tiles_used == mp.tiles_used
        and mc.lanes_used == mp.lanes_used
    )


def _edge_prec_ok(g: WorkloadGraph, e: GraphEdge, mappings: Dict[str, Mapping]) -> bool:
    """The consumer must declare the chained input at exactly the precision
    the producer's accumulator holds, or the in-place read misparses bits."""
    w_dst = g.node(e.dst)
    idx = 0 if e.dst_input == "in_a" else 1
    if idx >= len(w_dst.ins):
        return False
    return w_dst.ins[idx].prec == mappings[e.src].out_prec


# cost_fn(workload, mapping, elide) -> modeled data-movement cycles of the
# node under that plan; injected by codegen.compile_graph (it owns the
# emit + simulate machinery, and importing it here would be circular)
CostFn = Optional[Callable[[Workload, Mapping, frozenset], float]]


def _store_may_elide(g: WorkloadGraph, src: str) -> bool:
    """Planning-time approximation of GraphMapping.store_elided: the store
    can only go away if nothing outside the program reads the value and every
    consumer is at least *eligible* for residency."""
    outs = g.out_edges(src)
    return bool(outs) and src not in g.outputs and all(e.resident_ok for e in outs)


def distribute_graph(
    g: WorkloadGraph, cfg: PimsabConfig, cost_fn: CostFn = None,
    *,
    state_pins: Optional[Dict[str, Dict[str, List[Tuple[int, int]]]]] = None,
) -> GraphMapping:
    """Distribute every node of ``g``, keeping eligible producer outputs
    CRAM-resident for their consumers.

    For each ``resident_ok`` edge the planner (1) re-pins the producer to the
    lane-contiguous single-step layout, (2) constrains the consumer to the
    producer's tiling, (3) checks — via ``cost_fn`` when provided — that the
    fused plan models strictly fewer data-movement cycles than the eager pair
    (re-pinning a lane-split reduction can add DRAM phases that outweigh the
    elided store/load, e.g. when the per-lane reduction no longer fits one
    k-chunk), and (4) runs the live-range allocator with the boundary buffer
    pinned.  Any failure drops the edge back to the DRAM round-trip — the
    program still compiles, just without the elision.

    ``state_pins`` maps a node to the fixed wordline ranges of a
    cross-program persistent state (``ResidentState``) its buffers alias —
    typically a kv_append updater with ``in_a`` and ``out`` pinned to the
    same region, making the append in place and DRAM-free.  Each pin is
    cost-model gated like edge residency: a layout that cannot update in
    place (multi-step, multi-tile) or that models no data-movement win is
    declined with an N-PLAN note and falls back to the DRAM round-trip.
    """
    mappings: Dict[str, Mapping] = {}
    resident: List[GraphEdge] = []
    notes: List[str] = []

    for w in g.nodes:
        incoming = [e for e in g.in_edges(w.name) if e.resident_ok]
        m = None
        m_free: Optional[Mapping] = None  # unconstrained best, if computed
        taken: List[GraphEdge] = []
        cand = [
            e for e in incoming
            if e.src in mappings and _chain_candidate(w, e)
        ]
        if cand:
            # producers must be lane-contiguous; re-pin them if they are not
            # (into `repins` — committed only if the plan is accepted)
            repins: Dict[str, Mapping] = {}
            ok: List[GraphEdge] = []
            for e in cand:
                mp = mappings[e.src]
                if (
                    w.op == "mac"
                    and e.dst_input == "in_b"
                    and not _mac_chain_shape_ok(w, g.node(e.src))
                ):
                    _note(notes, NOTE_CHAIN_SHAPE,
                          f"{e.src}->{e.dst}: producer field layout does not "
                          "match the mac's shared-operand shape, DRAM "
                          "round-trip kept")
                    continue
                if not _producer_layout_ok(mp):
                    repinned = distribute(
                        g.node(e.src), cfg,
                        tile_constraint=mp.tiles_used, rs_constraint=1,
                        strict=False,
                    )
                    if repinned is None or not _producer_layout_ok(repinned):
                        _note(notes, NOTE_PROD_LAYOUT,
                              f"{e.src}->{e.dst}: producer cannot take the "
                              "lane-contiguous layout, DRAM round-trip kept")
                        continue
                    _note(repinned.notes, NOTE_RES_PIN,
                          "reduce_split pinned to 1: output stays "
                          f"CRAM-resident for {e.dst}")
                    repins[e.src] = repinned
                ok.append(e)
            # all resident producers of this node must share a tiling
            if ok:
                pmap = lambda e: repins.get(e.src, mappings[e.src])
                tiles = pmap(ok[0]).tiles_used
                ok = [e for e in ok if pmap(e).tiles_used == tiles]
                chain_mac = w.op == "mac" and any(
                    e.dst_input == "in_b" for e in ok
                )
                m_try = distribute(
                    w, cfg, tile_constraint=tiles,
                    rs_constraint=1 if chain_mac else None,
                    k_chunk_constraint=w.reduce_extent() if chain_mac else None,
                    strict=False,
                )
                accept = m_try is not None and all(
                    _consumer_layout_ok(m_try, pmap(e)) for e in ok
                )
                if accept and cost_fn is not None:
                    m_free = distribute(w, cfg)
                    fused = cost_fn(
                        w, m_try, frozenset(e.dst_input for e in ok)
                    )
                    eager = cost_fn(w, m_free, frozenset())
                    for src in {e.src for e in ok}:
                        w_src = g.node(src)
                        src_elide = (
                            frozenset({"out"}) if _store_may_elide(g, src)
                            else frozenset()
                        )
                        fused += cost_fn(w_src, repins.get(src, mappings[src]), src_elide)
                        eager += cost_fn(w_src, mappings[src], frozenset())
                    if fused >= eager:
                        accept = False
                        _note(notes, NOTE_RES_COST,
                              f"{w.name}: residency declined — fused plan "
                              f"models {fused:.0f} data-movement cycles vs "
                              f"{eager:.0f} eager (re-pinned reduction adds "
                              "DRAM phases)")
                if accept:
                    m = m_try
                    taken = ok
                    mappings.update(repins)
                elif m_try is None or not all(
                    _consumer_layout_ok(m_try, pmap(e)) for e in ok
                ):
                    _note(notes, NOTE_CONS_LAYOUT,
                          f"{w.name}: consumer layout incompatible with "
                          "producer tiling, DRAM round-trip kept")
        if m is None and state_pins and w.name in state_pins:
            # a persistent-state updater must mutate its reserved wordlines
            # in place: one tile, one serial step, no reduce split.  Ask for
            # that layout up front — the free distribution spreads lanes
            # across tiles for parallelism and would force the decline below.
            m = distribute(w, cfg, tile_constraint=1, rs_constraint=1,
                           strict=False)
            if m is not None and (m.serial_iters != 1 or m.tiles_used != 1):
                m = None
            if m is not None:
                _note(m.notes, NOTE_STATE_TILE,
                      "tile pinned to 1: in-place persistent-state update")
        if m is None:
            m = m_free if m_free is not None else distribute(w, cfg)
        mappings[w.name] = m
        resident.extend(
            e for e in taken if _edge_prec_ok(g, e, mappings)
        )

    accepted: Dict[str, Dict[str, List[Tuple[int, int]]]] = {}
    for name, pins in (state_pins or {}).items():
        if name not in mappings:
            raise KeyError(f"state pin on unknown node {name!r}")
        m = mappings[name]
        if m.serial_iters != 1 or m.tiles_used != 1:
            _note(notes, NOTE_STATE_LAYOUT,
                  f"{name}: state residency declined — the update layout is "
                  f"not a single-step single-tile in-place pass "
                  f"(serial_iters={m.serial_iters}, tiles={m.tiles_used})")
            continue
        if cost_fn is not None:
            elide = frozenset(set(pins) & {"in_a", "in_b", "out"})
            fused = cost_fn(g.node(name), m, elide)
            eager = cost_fn(g.node(name), m, frozenset())
            if fused >= eager:
                _note(notes, NOTE_STATE_COST,
                      f"{name}: state residency declined — fused plan models "
                      f"{fused:.0f} data-movement cycles vs {eager:.0f} eager")
                continue
        _note(notes, NOTE_STATE_ON,
              f"{name}: persistent state CRAM-resident — the append updates "
              "the reserved wordlines in place, no DRAM round-trip")
        accepted[name] = {b: [tuple(r) for r in rr] for b, rr in pins.items()}

    declined_updaters = {n for n in (state_pins or {}) if n not in accepted}
    gm = GraphMapping(
        graph=g, mappings=mappings, resident=tuple(resident), notes=notes,
        state_pins=accepted, must_store=declined_updaters,
    )
    _allocate_graph_mappings(gm, cfg)
    _account_elision(gm)
    return gm


def _allocate_graph_mappings(gm: GraphMapping, cfg: PimsabConfig) -> None:
    """Joint live-range allocation; drops residency edges that don't fit."""
    g = gm.graph
    while True:
        items = []
        for w in g.nodes:
            m = gm.mappings[w.name]
            pins = {
                e.dst_input: f"{e.src}:{out_buffer(g.node(e.src))}"
                for e in gm.resident if e.dst == w.name
            }
            # a pinned (CRAM-resident) input issues no DRAM loads: its alt
            # chunk region would never be written, so don't allocate one
            reqs = [
                r for r in mapping_buffer_reqs(w, m, cfg)
                if not (r.name.endswith(".alt") and r.name[:-4] in pins)
            ]
            items.append((w.name, reqs, pins))
        allocs = allocate_graph(
            items, cfg.cram_rows,
            reserved=gm.state_reserved(), pinned_fixed=gm.state_pins,
        )
        bad = [n for n, a in allocs.items() if not a.feasible]
        if not bad:
            for name, a in allocs.items():
                gm.mappings[name].allocation = a
            return
        # first relief valve: give up double buffering on the failing nodes
        # (overlap is a luxury; residency elides whole DRAM round-trips)
        db_bad = [n for n in bad if gm.mappings[n].double_buffered]
        if db_bad:
            for n in db_bad:
                gm.mappings[n].double_buffered = False
            _note(gm.notes, NOTE_DB_DROPPED,
                  f"double buffering dropped on {db_bad}: alt chunk buffers "
                  "don't fit around the live intermediates")
            continue
        # drop every resident edge whose live intermediate squeezes a failing
        # node — including edges that merely *span* it (A→C reserving rows
        # while B allocates), not just edges ending there
        order = {w.name: i for i, w in enumerate(g.nodes)}
        bad_idx = {order[n] for n in bad}
        dropped = tuple(
            e for e in gm.resident
            if not any(order[e.src] < b <= order[e.dst] for b in bad_idx)
        )
        if dropped == gm.resident:
            # last relief valve: give up the persistent-state reservations
            # (the states fall back to host-side round-trips per step)
            if gm.state_pins:
                _note(gm.notes, NOTE_STATE_DROPPED,
                      f"state residency dropped around {bad}: reserved state "
                      "rows squeeze the node's own buffers out of CRAM")
                # the updaters now stream: their stores must reach DRAM so
                # the host-side state mirrors can harvest the new cache
                gm.must_store |= set(gm.state_pins)
                gm.state_pins = {}
                continue
            raise RuntimeError(
                f"graph {g.name}: allocation infeasible for {bad} even "
                "without residency — per-op distribute() admitted a mapping "
                "the joint allocator rejects"
            )
        _note(gm.notes, NOTE_RES_DROPPED,
              f"residency around {bad} dropped: live intermediates exceed "
              "CRAM rows")
        gm.resident = dropped


def _account_elision(gm: GraphMapping) -> None:
    """Record the DRAM bits each residency decision removes (the number the
    aggregated SimReport pins as the fused-vs-eager win)."""
    for e in gm.resident:
        stream = "a" if e.dst_input == "in_a" else "b"
        bits = gm.mappings[e.dst].dram_split.get(stream, 0.0)
        gm.elided_bits[f"{e.dst}:{stream}"] = bits
    for w in gm.graph.nodes:
        if gm.store_elided(w.name):
            gm.elided_bits[f"{w.name}:out"] = gm.mappings[w.name].dram_split.get("out", 0.0)
    for name, pins in gm.state_pins.items():
        split = gm.mappings[name].dram_split
        if "in_a" in pins:
            gm.elided_bits[f"{name}:a"] = split.get("a", 0.0)
        if "out" in pins:
            gm.elided_bits[f"{name}:out"] = split.get("out", 0.0)
