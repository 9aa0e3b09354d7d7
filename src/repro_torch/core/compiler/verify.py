"""ISA-level static verifier for compiled pimsab programs.

Three compile-time analyses over an ``isa.Instr`` stream plus its
``Mapping``/``Allocation``, driven entirely by the per-instruction
:class:`~repro_torch.core.isa.Effect` signatures (no interpretation):

1. **Liveness / def-use** — no read of a CRAM wordline range, RF register or
   the PE mask latch before its defining write; allocation ranges stay inside
   the CRAM and pairwise disjoint; resident producer→consumer edges of a
   graph program are actually covered by the producer's last write (at each
   segment boundary the initialized-wordline state is masked down to the
   live resident intermediates — nodes reuse each other's dead wordlines, so
   surviving state must be claimed by a residency pin).

2. **Schedule-hazard race detection** — reconstructs the happens-before
   relation of the phase-timeline clock (§III overlap): ``barrier``
   instructions (explicit, or untagged — no ``phase`` and no ``after``)
   order against everything; ``after`` tokens order against every earlier
   publisher of that ``phase``; instructions sharing a timeline resource
   (``compute``/``compute@t``, ``dram``, ``noc``, ``htree``, ``sync``)
   serialize in program order.  Any RAW/WAR/WAW pair on overlapping
   wordlines of intersecting tile sets that is *unordered* under that
   relation is flagged — e.g. a double-buffered prefetch into ``<buf>.alt``
   racing the chunk of MACs that still reads the primary region.  A program
   with no such pair is bit-exact under any schedule the tags admit.

3. **Precision-overflow lint** — propagates exact signed ``(lo, hi)`` value
   bounds through Mac/MacConst/ReduceIntra/ReduceHTree chains (constants
   come from tracked ``RfLoad`` values, operands from their declared
   precisions — the §V-C adaptive-precision inputs).  A write whose
   worst-case bits exceed its wordline count is an ``E-PREC-OVERFLOW``
   error when the destination is narrower than the mapping's planned
   ``out_prec`` (an undersized accumulator), and a ``W-PREC-CLAMP`` warning
   when the wrap happens at exactly the planned width — the declared
   int32-style clamp (or scan_mac's renormalized recurrence format) is
   load-bearing.

Diagnostic codes
----------------
=================  ========  ====================================================
code               severity  meaning
=================  ========  ====================================================
E-UNINIT-READ      error     wordline range read before any write covers it
E-RF-UNINIT        error     RF register read before its RfLoad (the static
                             twin of the runtime ``UninitializedRfError``)
E-MASK-UNINIT      error     predicated op before any SetMask
E-RACE-RAW         error     unordered read-after-write wordline overlap
E-RACE-WAR         error     unordered write-after-read wordline overlap
E-RACE-WAW         error     unordered write-after-write wordline overlap
E-ALLOC-OVERLAP    error     allocation ranges collide (within an op, or a
                             node's fresh buffer vs a live resident range)
E-ALLOC-BOUNDS     error     allocation range outside [0, cram_rows)
E-RESIDENT-PIN     error     consumer's pinned input ranges differ from the
                             producer's output ranges
E-STATE-PIN        error     persistent-state pins are not a single in-place
                             region (in_a and out must alias the same rows)
E-PREC-OVERFLOW    error     worst-case accumulator bits exceed the written
                             width, which is below the planned out_prec
E-NO-EFFECT        error     an Instr subclass lacks an effect signature
W-PREC-CLAMP       warning   wrap at the planned width — clamp is load-bearing
N-PLAN-*           note      distribute/distribute_graph plan notes (declined
                             residency, dropped double buffering, savings);
                             the suffix is the note's stable machine-readable
                             code (e.g. N-PLAN-RES-COST, N-PLAN-DB-DECLINED),
                             un-coded legacy notes stay plain N-PLAN
=================  ========  ====================================================
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from repro_torch.core import isa
from repro_torch.core.compiler.allocation import signed_bits as _signed_bits
from repro_torch.core.compiler.distribute import GraphMapping, Mapping, note_code
from repro_torch.core.compiler.tensor_dsl import out_buffer
from repro_torch.core.machine import PimsabConfig

__all__ = [
    "Diagnostic",
    "VerifyReport",
    "VerifierError",
    "VerifierWarning",
    "verify_stream",
    "verify_compiled",
    "verify_graph",
]


# ---------------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Diagnostic:
    """One structured verifier finding.

    ``instr`` (and ``other`` for hazard pairs) are indices into the verified
    program; ``wordlines`` are the half-open CRAM ranges involved; ``node``
    is the graph-segment name ("" for single-workload programs)."""

    code: str
    severity: str  # "error" | "warning" | "note"
    message: str
    instr: Optional[int] = None
    other: Optional[int] = None
    wordlines: Tuple[Tuple[int, int], ...] = ()
    node: str = ""

    def to_json(self) -> Dict:
        return {
            "code": self.code, "severity": self.severity,
            "message": self.message, "instr": self.instr, "other": self.other,
            "wordlines": [list(r) for r in self.wordlines], "node": self.node,
        }

    def __str__(self) -> str:
        where = f" {self.node}" if self.node else ""
        at = f" @i{self.instr}" if self.instr is not None else ""
        vs = f" (vs i{self.other})" if self.other is not None else ""
        wl = (
            " wl" + ",".join(f"[{s},{e})" for s, e in self.wordlines)
            if self.wordlines else ""
        )
        return f"[{self.code}]{where}{at}{vs}{wl}: {self.message}"


@dataclass(frozen=True)
class VerifyReport:
    """Outcome of one static-verification pass over a compiled program."""

    name: str
    instrs: int
    diagnostics: Tuple[Diagnostic, ...] = ()

    @property
    def errors(self) -> Tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics if d.severity == "error")

    @property
    def warnings(self) -> Tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics if d.severity == "warning")

    @property
    def notes(self) -> Tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics if d.severity == "note")

    @property
    def ok(self) -> bool:
        return not self.errors

    def summary(self) -> str:
        return (
            f"{self.name}: {self.instrs} instrs, "
            f"{len(self.errors)} errors, {len(self.warnings)} warnings, "
            f"{len(self.notes)} notes"
        )

    def to_json(self) -> Dict:
        return {
            "name": self.name, "instrs": self.instrs, "ok": self.ok,
            "diagnostics": [d.to_json() for d in self.diagnostics],
            "errors": [d.to_json() for d in self.errors],
            "warnings": [d.to_json() for d in self.warnings],
            "notes": [d.to_json() for d in self.notes],
        }

    def raise_on_error(self) -> "VerifyReport":
        """Raise :class:`VerifierError` if any error-severity diagnostic."""
        if not self.ok:
            raise VerifierError(self)
        return self


class VerifierError(RuntimeError):
    """A compiled program failed static verification; ``.report`` holds the
    full :class:`VerifyReport` with structured diagnostics."""

    def __init__(self, report: VerifyReport):
        self.report = report
        shown = [str(d) for d in report.errors[:4]]
        more = len(report.errors) - len(shown)
        tail = f" (+{more} more)" if more > 0 else ""
        super().__init__(
            f"static verification failed for {report.name}: "
            + "; ".join(shown) + tail
        )


class VerifierWarning(UserWarning):
    """Category for warning-severity verifier diagnostics (``W-*`` codes)
    when a caller chooses to surface them via the warnings machinery."""


# ---------------------------------------------------------------------------
# bitmask helpers (wordline sets as Python ints)
# ---------------------------------------------------------------------------


def _range_mask(ranges: Sequence[Tuple[int, int]]) -> int:
    m = 0
    for s, e in ranges:
        if e > s:
            m |= (1 << e) - (1 << s)
    return m


def _mask_ranges(m: int) -> Tuple[Tuple[int, int], ...]:
    out: List[Tuple[int, int]] = []
    off = 0
    while m:
        z = (m & -m).bit_length() - 1  # trailing zeros
        m >>= z
        off += z
        run = (m ^ (m + 1)).bit_length() - 1  # trailing ones
        out.append((off, off + run))
        m >>= run
        off += run
    return tuple(out)


def _full_range(width: int) -> Tuple[int, int]:
    if width <= 0:
        return (0, 0)
    return (-(1 << (width - 1)), (1 << (width - 1)) - 1)


def _mul_bounds(a: Tuple[int, int], b: Tuple[int, int]) -> Tuple[int, int]:
    prods = (a[0] * b[0], a[0] * b[1], a[1] * b[0], a[1] * b[1])
    return (min(prods), max(prods))


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _Segment:
    node: str
    start: int
    end: int
    mapping: Optional[Mapping] = None
    # planned adaptive-precision width (overrides mapping.out_prec; lets the
    # bad-program corpus verify bare streams without a full Mapping)
    out_prec: Optional[int] = None
    # wordline ranges live at segment entry (resident intermediates); None =
    # single-workload program, no cross-node reuse, keep everything
    keep: Optional[Tuple[Tuple[int, int], ...]] = None


class _Verifier:
    def __init__(self, name: str, program: Sequence[isa.Instr],
                 cfg: PimsabConfig, segments: Sequence[_Segment],
                 entry_live: Tuple[Tuple[int, int], ...] = ()):
        self.name = name
        self.program = list(program)
        self.cfg = cfg
        self.segments = list(segments)
        self.diags: List[Diagnostic] = []
        self._seen: Set[Tuple] = set()
        self.node = ""
        self.mapping: Optional[Mapping] = None
        self.planned: Optional[int] = None
        # liveness: initialized-wordline bitmask, shared default + per-tile
        # overrides (only staggered tile groups diverge).  ``entry_live``
        # ranges (cross-program persistent-state regions) count as written
        # before the first instruction: the executor seeds them.
        self.wl_all = _range_mask(entry_live)
        self.wl_over: Dict[int, int] = {}
        self.rf_all: Set[int] = set()
        self.rf_over: Dict[int, Set[int]] = {}
        self.mask_all = False
        self.mask_over: Dict[int, bool] = {}
        # race window (reset at every barrier)
        self.win_start = 0
        self.preds: Dict[int, int] = {}
        self.tok: Dict[str, int] = {}
        self.last_res: Dict[str, int] = {}
        self.writers: List[List] = []  # [idx, wordline-mask, tiles-frozenset|None]
        self.readers: List[List] = []
        # overflow lint: addr -> (width, lo, hi); RF constants
        self.bounds: Dict[int, Tuple[int, int, int]] = {}
        self.rf_val: Dict[int, int] = {}

    # -- reporting ---------------------------------------------------------

    def _diag(self, code: str, severity: str, message: str, *,
              instr: Optional[int] = None, other: Optional[int] = None,
              wordlines: Tuple[Tuple[int, int], ...] = (),
              dedup: Optional[Tuple] = None) -> None:
        if dedup is not None:
            key = (code, self.node) + dedup
            if key in self._seen:
                return
            self._seen.add(key)
        self.diags.append(Diagnostic(
            code=code, severity=severity, message=message,
            instr=instr, other=other, wordlines=wordlines, node=self.node,
        ))

    # -- liveness ----------------------------------------------------------

    def _wl_states(self, tiles: Optional[Tuple[int, ...]]) -> List[int]:
        if not tiles:
            return [self.wl_all] + list(self.wl_over.values())
        return [self.wl_over.get(t, self.wl_all) for t in tiles]

    def _wl_write(self, tiles: Optional[Tuple[int, ...]], wmask: int) -> None:
        if not tiles:
            self.wl_all |= wmask
            for t in self.wl_over:
                self.wl_over[t] |= wmask
        else:
            for t in tiles:
                self.wl_over[t] = self.wl_over.get(t, self.wl_all) | wmask

    def _check_liveness(self, i: int, ins: isa.Instr, eff: isa.Effect,
                        rmask: int) -> None:
        tiles = ins.tiles or None
        if rmask:
            missing = 0
            for st in self._wl_states(tiles):
                missing |= rmask & ~st
            if missing:
                self._diag(
                    "E-UNINIT-READ", "error",
                    f"{type(ins).__name__} reads wordlines never written "
                    "(or dead since the last segment boundary)",
                    instr=i, wordlines=_mask_ranges(missing),
                    dedup=(type(ins).__name__, _mask_ranges(missing)),
                )
        for reg in eff.rf_reads:
            states = (
                [self.rf_all] + list(self.rf_over.values()) if not tiles
                else [self.rf_over.get(t, self.rf_all) for t in tiles]
            )
            if any(reg not in st for st in states):
                self._diag(
                    "E-RF-UNINIT", "error",
                    f"{type(ins).__name__} reads RF[{reg}] before any RfLoad "
                    "initialized it (runtime would raise UninitializedRfError)",
                    instr=i, dedup=("rf", reg),
                )
        if eff.mask_read:
            states = (
                [self.mask_all] + list(self.mask_over.values()) if not tiles
                else [self.mask_over.get(t, self.mask_all) for t in tiles]
            )
            if not all(states):
                self._diag(
                    "E-MASK-UNINIT", "error",
                    f"{type(ins).__name__} is mask-predicated but no SetMask "
                    "ever latched a predicate",
                    instr=i, dedup=("mask",),
                )

    def _apply_writes(self, ins: isa.Instr, eff: isa.Effect, wmask: int) -> None:
        tiles = ins.tiles or None
        if wmask:
            self._wl_write(tiles, wmask)
        for reg in eff.rf_writes:
            if not tiles:
                self.rf_all.add(reg)
                for s in self.rf_over.values():
                    s.add(reg)
            else:
                for t in tiles:
                    self.rf_over.setdefault(t, set(self.rf_all)).add(reg)
        if eff.mask_write:
            if not tiles:
                self.mask_all = True
                for t in self.mask_over:
                    self.mask_over[t] = True
            else:
                for t in tiles:
                    self.mask_over[t] = True

    # -- happens-before race detection -------------------------------------

    def _bit(self, j: int) -> int:
        return 1 << (j - self.win_start)

    @staticmethod
    def _tiles_meet(a: Optional[FrozenSet[int]], b: Optional[FrozenSet[int]]) -> bool:
        if a is None or b is None:
            return True
        return bool(a & b)

    @staticmethod
    def _tiles_cover(new: Optional[FrozenSet[int]], old: Optional[FrozenSet[int]]) -> bool:
        if new is None:
            return True
        if old is None:
            return False
        return old <= new

    def _race_reset(self, i: int) -> None:
        self.win_start = i + 1
        self.preds.clear()
        self.tok.clear()
        self.last_res.clear()
        self.writers.clear()
        self.readers.clear()

    def _race(self, i: int, ins: isa.Instr, eff: isa.Effect,
              rmask: int, wmask: int) -> None:
        # mirrors Simulator._schedule: an instruction with no phase and no
        # after — or with barrier set — serializes against all earlier work
        if ins.barrier or (ins.phase is None and not ins.after):
            self._race_reset(i)
            return
        tiles = frozenset(ins.tiles) if ins.tiles else None
        pred = 0
        for t in ins.after:
            pred |= self.tok.get(t, 0)
        for r in eff.resources:
            j = self.last_res.get(r)
            if j is not None:
                pred |= self._bit(j) | self.preds.get(j, 0)
        # conflicts against unordered earlier accesses in this window
        if rmask or wmask:
            for idx, m, rtiles in self.writers:
                if not self._tiles_meet(rtiles, tiles) or pred & self._bit(idx):
                    continue
                if m & rmask:
                    self._report_race("E-RACE-RAW", i, idx, m & rmask, ins)
                elif m & wmask:
                    self._report_race("E-RACE-WAW", i, idx, m & wmask, ins)
        if wmask:
            for idx, m, rtiles in self.readers:
                if (m & wmask and self._tiles_meet(rtiles, tiles)
                        and not pred & self._bit(idx)):
                    self._report_race("E-RACE-WAR", i, idx, m & wmask, ins)
            # a covering write supersedes earlier access records
            for rec in self.writers:
                if self._tiles_cover(tiles, rec[2]):
                    rec[1] &= ~wmask
            for rec in self.readers:
                if self._tiles_cover(tiles, rec[2]):
                    rec[1] &= ~wmask
            self.writers = [r for r in self.writers if r[1]]
            self.readers = [r for r in self.readers if r[1]]
            self.writers.append([i, wmask, tiles])
        if rmask:
            self.readers.append([i, rmask, tiles])
        self.preds[i] = pred
        if ins.phase:
            self.tok[ins.phase] = self.tok.get(ins.phase, 0) | self._bit(i) | pred
        for r in eff.resources:
            self.last_res[r] = i

    def _report_race(self, code: str, i: int, j: int, overlap: int,
                     ins: isa.Instr) -> None:
        kind = {"E-RACE-RAW": "read-after-write", "E-RACE-WAW":
                "write-after-write", "E-RACE-WAR": "write-after-read"}[code]
        ranges = _mask_ranges(overlap)
        self._diag(
            code, "error",
            f"unordered {kind}: {type(self.program[j]).__name__} at i{j} and "
            f"{type(ins).__name__} at i{i} touch overlapping wordlines with "
            "no happens-before edge (token, barrier or shared resource) "
            "between them — the result depends on the schedule",
            instr=i, other=j, wordlines=ranges,
            dedup=(type(self.program[j]).__name__, type(ins).__name__, ranges),
        )

    # -- precision-overflow lint --------------------------------------------

    def _bound_read(self, addr: int, width: int) -> Tuple[int, int]:
        ent = self.bounds.get(addr)
        if ent is not None and ent[0] == width:
            return ent[1], ent[2]
        return _full_range(width)

    def _bound_kill(self, start: int, end: int) -> None:
        dead = [a for a, (w, _, _) in self.bounds.items()
                if not (a + w <= start or end <= a)]
        for a in dead:
            del self.bounds[a]

    def _bound_write(self, i: int, ins: isa.Instr, addr: int, width: int,
                     lo: int, hi: int) -> None:
        needed = _signed_bits(lo, hi)
        if needed > width:
            planned = self.planned
            if planned is not None and width < planned:
                self._diag(
                    "E-PREC-OVERFLOW", "error",
                    f"{type(ins).__name__} accumulates a worst-case "
                    f"{needed}-bit value into {width} wordlines at wl {addr} "
                    f"— below the mapping's adaptive-precision width "
                    f"({planned}): the accumulator is undersized",
                    instr=i, wordlines=((addr, addr + width),),
                    dedup=("oflow", addr, width),
                )
            else:
                self._diag(
                    "W-PREC-CLAMP", "warning",
                    f"{type(ins).__name__} worst-case value needs {needed} "
                    f"bits but wraps at the planned {width}-bit width at wl "
                    f"{addr} — the two's-complement clamp (int32-style, or a "
                    "renormalized recurrence format) is load-bearing",
                    instr=i, wordlines=((addr, addr + width),),
                    dedup=("clamp", addr, width),
                )
            lo, hi = _full_range(width)
        self._bound_kill(addr, addr + width)
        self.bounds[addr] = (width, lo, hi)

    def _htree_terms(self) -> int:
        m = self.mapping
        if m is not None and m.reduce_split > 1:
            spill = math.ceil(m.reduce_split / self.cfg.cram_cols)
            return max(1, min(self.cfg.crams_per_tile, spill))
        return max(1, self.cfg.crams_per_tile)

    def _lint(self, i: int, ins: isa.Instr) -> None:
        if isinstance(ins, isa.DramLoad):
            self._bound_kill(ins.cram_addr, ins.cram_addr + ins.fields * ins.prec)
            lo, hi = _full_range(ins.prec)
            for f in range(ins.fields):
                self.bounds[ins.cram_addr + f * ins.prec] = (ins.prec, lo, hi)
        elif isinstance(ins, isa.RfLoad):
            self.rf_val[ins.reg] = ins.value
        elif isinstance(ins, isa.ReduceIntra):
            stages = max(0, (ins.size - 1).bit_length())
            pf = ins.prec + stages
            lo, hi = self._bound_read(ins.src, ins.prec)
            self._bound_kill(ins.dst, ins.dst + 2 * pf)
            self._bound_write(i, ins, ins.dst, pf, lo * ins.size, hi * ins.size)
        elif isinstance(ins, isa.ReduceHTree):
            n = self._htree_terms()
            lo, hi = self._bound_read(ins.src, ins.prec)
            self._bound_write(i, ins, ins.dst, ins.prec, lo * n, hi * n)
        elif isinstance(ins, isa.MacConst):
            c = self.rf_val.get(ins.reg)
            a = self._bound_read(ins.src1, ins.prec1)
            acc = self._bound_read(ins.dst, ins.prec_dst)
            if c is None:
                lo, hi = _full_range(ins.prec_dst)
            else:
                p = _mul_bounds(a, (c, c))
                lo, hi = acc[0] + p[0], acc[1] + p[1]
            self._bound_write(i, ins, ins.dst, ins.prec_dst, lo, hi)
        elif isinstance(ins, isa.MulConst):
            c = self.rf_val.get(ins.reg)
            a = self._bound_read(ins.src1, ins.prec1)
            lo, hi = (
                _full_range(ins.prec_dst) if c is None
                else _mul_bounds(a, (c, c))
            )
            self._bound_write(i, ins, ins.dst, ins.prec_dst, lo, hi)
        elif isinstance(ins, isa.AddConst):
            c = self.rf_val.get(ins.reg)
            a = self._bound_read(ins.src1, ins.prec1)
            lo, hi = (
                _full_range(ins.prec_dst) if c is None
                else (a[0] + c, a[1] + c)
            )
            self._bound_write(i, ins, ins.dst, ins.prec_dst, lo, hi)
        elif isinstance(ins, isa.Mac):
            a = self._bound_read(ins.src1, ins.prec1)
            b = self._bound_read(ins.src2, ins.prec2)
            acc = self._bound_read(ins.dst, ins.prec_dst)
            p = _mul_bounds(a, b)
            self._bound_write(i, ins, ins.dst, ins.prec_dst,
                              acc[0] + p[0], acc[1] + p[1])
        elif isinstance(ins, isa.Mul):
            a = self._bound_read(ins.src1, ins.prec1)
            b = self._bound_read(ins.src2, ins.prec2)
            lo, hi = _mul_bounds(a, b)
            self._bound_write(i, ins, ins.dst, ins.prec_dst, lo, hi)
        elif isinstance(ins, isa.Add):
            a = self._bound_read(ins.src1, ins.prec1)
            b = self._bound_read(ins.src2, ins.prec2)
            self._bound_write(i, ins, ins.dst, ins.prec_dst,
                              a[0] + b[0], a[1] + b[1])
        elif isinstance(ins, isa.Sub):
            if ins.src2 == ins.src1 and ins.prec2 == ins.prec1:
                # x - x: the zeroing idiom — exactly 0, not a full range
                self._bound_write(i, ins, ins.dst, ins.prec_dst, 0, 0)
            else:
                a = self._bound_read(ins.src1, ins.prec1)
                b = self._bound_read(ins.src2, ins.prec2)
                self._bound_write(i, ins, ins.dst, ins.prec_dst,
                                  a[0] - b[1], a[1] - b[0])
        elif isinstance(ins, isa.Logical):
            pure_zero = (
                ins.op == "xor" and ins.src2 == ins.src1 and ins.dst == ins.src1
            )
            lo, hi = (0, 0) if pure_zero else _full_range(ins.prec1)
            self._bound_write(i, ins, ins.dst, ins.prec1, lo, hi)
        elif isinstance(ins, isa.CmpGE):
            self._bound_kill(ins.dst, ins.dst + 1)
            self.bounds[ins.dst] = (1, 0, 1)
        elif isinstance(ins, isa.Copy):
            lo, hi = self._bound_read(ins.src1, ins.prec1)
            if ins.pred is isa.Pred.MASK:
                old = self._bound_read(ins.dst, ins.prec1)
                lo, hi = min(lo, old[0]), max(hi, old[1])
            self._bound_write(i, ins, ins.dst, ins.prec1, lo, hi)
        elif isinstance(ins, isa.Shift):
            lo, hi = self._bound_read(ins.src, ins.prec)
            self._bound_write(i, ins, ins.dst, ins.prec, lo, hi)
        # SetMask / DramStore / NoC / sync: no value-producing wordline write

    # -- driver -------------------------------------------------------------

    def _enter_segment(self, seg: _Segment) -> None:
        self.node = seg.node
        self.mapping = seg.mapping
        self.planned = (
            seg.out_prec if seg.out_prec is not None
            else seg.mapping.out_prec if seg.mapping is not None else None
        )
        if seg.keep is not None:
            # graph segment boundary: nodes reuse dead wordlines, so only
            # resident intermediates survive — this is what makes a
            # consumer's in-place read prove the producer actually wrote it
            keep = _range_mask(seg.keep)
            self.wl_all &= keep
            for t in list(self.wl_over):
                self.wl_over[t] &= keep
            self.bounds = {
                a: ent for a, ent in self.bounds.items()
                if keep & ((1 << (a + ent[0])) - (1 << a))
                == ((1 << (a + ent[0])) - (1 << a))
            }

    def run(self) -> List[Diagnostic]:
        for seg in self.segments:
            self._enter_segment(seg)
            for i in range(seg.start, seg.end):
                ins = self.program[i]
                try:
                    eff = ins.effect()
                except NotImplementedError:
                    self._diag(
                        "E-NO-EFFECT", "error",
                        f"{type(ins).__name__} declares no effect signature; "
                        "the verifier cannot reason about it",
                        instr=i, dedup=(type(ins).__name__,),
                    )
                    continue
                rmask = _range_mask(eff.reads)
                wmask = _range_mask(eff.writes)
                self._check_liveness(i, ins, eff, rmask)
                self._race(i, ins, eff, rmask, wmask)
                self._apply_writes(ins, eff, wmask)
                self._lint(i, ins)
        return self.diags


# ---------------------------------------------------------------------------
# allocation / residency structural checks
# ---------------------------------------------------------------------------


def _check_allocation(alloc, node: str, capacity: int,
                      pinned: FrozenSet[str] = frozenset()) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    if alloc is None:
        return diags
    owner: Dict[str, int] = {}
    for name, ranges in alloc.ranges.items():
        m = _range_mask(ranges)
        for s, e in ranges:
            if s < 0 or e > capacity:
                diags.append(Diagnostic(
                    "E-ALLOC-BOUNDS", "error",
                    f"buffer '{name}' range [{s},{e}) exceeds the "
                    f"{capacity}-wordline CRAM", node=node,
                    wordlines=((s, e),),
                ))
        # two residency-pinned buffers may alias (a value fanning out to both
        # inputs of one op is pinned twice to the same producer wordlines);
        # any overlap involving a *fresh* buffer breaks disjointness
        others = {
            n: om & m for n, om in owner.items()
            if om & m and not (name in pinned and n in pinned)
        }
        if others:
            clash = 0
            for om in others.values():
                clash |= om
            diags.append(Diagnostic(
                "E-ALLOC-OVERLAP", "error",
                f"buffer '{name}' overlaps {sorted(others)} within one op's "
                "allocation — ranges the allocator claims are disjoint",
                node=node, wordlines=_mask_ranges(clash),
            ))
        owner[name] = m
    return diags


def _graph_structure_diags(cg, capacity: int) -> List[Diagnostic]:
    g, gm = cg.graph, cg.gm
    diags: List[Diagnostic] = []
    order = {w.name: idx for idx, w in enumerate(g.nodes)}
    pinned_bufs: Dict[str, Set[str]] = {}
    for e in gm.resident:
        pinned_bufs.setdefault(e.dst, set()).add(e.dst_input)
    for node, pins in gm.state_pins.items():
        pinned_bufs.setdefault(node, set()).update(pins)
    for w in g.nodes:
        diags.extend(_check_allocation(
            gm.mappings[w.name].allocation, w.name, capacity,
            pinned=frozenset(pinned_bufs.get(w.name, ())),
        ))
    # persistent-state pins: the updater's input and output must alias one
    # in-bounds region (the in-place contract), and no other node may land a
    # fresh buffer on those wordlines — they are live across the whole stream
    state_mask = 0
    for node, pins in gm.state_pins.items():
        rr = {buf: sorted(tuple(r) for r in ranges) for buf, ranges in pins.items()}
        if "in_a" in rr and "out" in rr and rr["in_a"] != rr["out"]:
            diags.append(Diagnostic(
                "E-STATE-PIN", "error",
                f"state pins on '{node}' differ between in_a {rr['in_a']} and "
                f"out {rr['out']}: the append would not update in place",
                node=node,
            ))
        for buf, ranges in rr.items():
            for s, e in ranges:
                if s < 0 or e > capacity:
                    diags.append(Diagnostic(
                        "E-STATE-PIN", "error",
                        f"state pin '{node}:{buf}' range [{s},{e}) exceeds "
                        f"the {capacity}-wordline CRAM",
                        node=node, wordlines=((s, e),),
                    ))
            state_mask |= _range_mask(ranges)
    if state_mask:
        # chained consumers of a state-pinned producer read the reserved
        # region in place — their pinned input legitimately aliases it
        state_readers: Dict[str, Set[str]] = {}
        for e in gm.resident:
            if e.src in gm.state_pins:
                state_readers.setdefault(e.dst, set()).add(e.dst_input)
        for w in g.nodes:
            alloc = gm.mappings[w.name].allocation
            if alloc is None:
                continue
            state_bufs = set(gm.state_pins.get(w.name, ()))
            state_bufs |= state_readers.get(w.name, set())
            for name, ranges in alloc.ranges.items():
                if name in state_bufs:
                    continue
                clash = _range_mask(ranges) & state_mask
                if clash:
                    diags.append(Diagnostic(
                        "E-ALLOC-OVERLAP", "error",
                        f"node '{w.name}' buffer '{name}' lands on persistent-"
                        "state wordlines that live across program executions",
                        node=w.name, wordlines=_mask_ranges(clash),
                    ))
    # resident pins alias the producer's output ranges exactly
    src_last: Dict[Tuple[str, str], int] = {}
    for e in gm.resident:
        buf = out_buffer(g.node(e.src))
        src_rng = [tuple(r) for r in
                   (gm.mappings[e.src].allocation.ranges.get(buf) or [])]
        dst_rng = [tuple(r) for r in
                   (gm.mappings[e.dst].allocation.ranges.get(e.dst_input) or [])]
        if src_rng != dst_rng or not src_rng:
            diags.append(Diagnostic(
                "E-RESIDENT-PIN", "error",
                f"resident edge {e.src}->{e.dst}:{e.dst_input} — consumer "
                f"pinned to {dst_rng} but producer's '{buf}' occupies "
                f"{src_rng}: the in-place read would misparse wordlines",
                node=e.dst,
                wordlines=tuple(dst_rng or src_rng),
            ))
        key = (e.src, buf)
        src_last[key] = max(src_last.get(key, -1), order[e.dst])
    # nodes executing while a resident intermediate is live must not have
    # fresh buffers on its wordlines (allocate_graph's disjointness claim)
    for (src, buf), last in src_last.items():
        src_mask = _range_mask(gm.mappings[src].allocation.ranges.get(buf) or [])
        pinned_to_src = {
            (e.dst, e.dst_input) for e in gm.resident
            if e.src == src and out_buffer(g.node(e.src)) == buf
        }
        for w in g.nodes:
            idx = order[w.name]
            if not (order[src] < idx <= last):
                continue
            alloc = gm.mappings[w.name].allocation
            for name, ranges in alloc.ranges.items():
                if (w.name, name) in pinned_to_src:
                    continue
                clash = _range_mask(ranges) & src_mask
                if clash:
                    diags.append(Diagnostic(
                        "E-ALLOC-OVERLAP", "error",
                        f"node '{w.name}' buffer '{name}' lands on wordlines "
                        f"of the live resident intermediate {src}:{buf} "
                        f"(live through '{g.nodes[last].name}')",
                        node=w.name, wordlines=_mask_ranges(clash),
                    ))
    return diags


def _plan_notes(plan) -> List[Diagnostic]:
    """Re-emit ``Mapping``/``GraphMapping`` plan notes (declined residency,
    dropped double buffering, fragmentation savings) as N-PLAN diagnostics —
    the structured channel ``compile_cache_info`` entries record.  Each
    note's machine-readable prefix (``N-PLAN-RES-COST: ...``) becomes the
    diagnostic code, so tooling keys on the decision kind, not the prose;
    un-coded legacy notes stay plain ``N-PLAN``."""
    return [
        Diagnostic(note_code(note), "note", note, node=node)
        for node, note in plan.plan_notes()
    ]


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def verify_stream(program: Sequence[isa.Instr], cfg: PimsabConfig, *,
                  name: str = "program",
                  mapping: Optional[Mapping] = None,
                  allocation=None,
                  out_prec: Optional[int] = None) -> VerifyReport:
    """Verify a bare instruction stream (no graph segmentation).

    ``mapping`` supplies the planned adaptive-precision width (overflow-lint
    severity) and the allocation whose ranges are structurally checked;
    ``allocation``/``out_prec`` override either piece individually — bare
    streams (e.g. the bad-program corpus) can be checked without a full
    Mapping."""
    diags: List[Diagnostic] = []
    node = mapping.workload.name if mapping is not None else name
    if mapping is not None:
        if allocation is None:
            allocation = mapping.allocation
        if out_prec is None:
            out_prec = mapping.out_prec
        diags.extend(_plan_notes(mapping))
    if allocation is not None:
        diags.extend(_check_allocation(allocation, node, cfg.cram_rows))
    seg = _Segment(
        node=node, start=0, end=len(program),
        mapping=mapping, out_prec=out_prec, keep=None,
    )
    diags.extend(_Verifier(name, program, cfg, [seg]).run())
    return VerifyReport(name=name, instrs=len(program), diagnostics=tuple(diags))


def verify_compiled(cp, cfg: PimsabConfig) -> VerifyReport:
    """Verify a ``codegen.CompiledProgram`` (one workload's stream + mapping)."""
    return verify_stream(
        cp.program, cfg,
        name=cp.mapping.workload.name, mapping=cp.mapping,
    )


def verify_graph(cg, cfg: PimsabConfig) -> VerifyReport:
    """Verify a ``codegen.CompiledGraph``: per-node analyses plus the
    cross-node residency/live-range checks over the fused stream."""
    g, gm = cg.graph, cg.gm
    diags = _plan_notes(gm) + _graph_structure_diags(cg, cfg.cram_rows)
    order = {w.name: idx for idx, w in enumerate(g.nodes)}
    # live interval of each resident source buffer: (producer, last consumer]
    src_last: Dict[Tuple[str, str], int] = {}
    for e in gm.resident:
        key = (e.src, out_buffer(g.node(e.src)))
        src_last[key] = max(src_last.get(key, -1), order[e.dst])
    # cross-program persistent-state wordlines (ResidentState): seeded before
    # the stream runs and harvested after it, so they are live at entry and
    # must survive *every* segment boundary
    state_keep = tuple(tuple(r) for r in gm.state_reserved())
    segments: List[_Segment] = []
    for idx, (node, start, end) in enumerate(cg.segments):
        keep: List[Tuple[int, int]] = list(state_keep)
        for (src, buf), last in src_last.items():
            if order[src] < idx <= last:
                keep.extend(
                    tuple(r) for r in
                    (gm.mappings[src].allocation.ranges.get(buf) or [])
                )
        segments.append(_Segment(
            node=node, start=start, end=end,
            mapping=gm.mappings.get(node), keep=tuple(keep),
        ))
    diags.extend(_Verifier(
        g.name, cg.program, cfg, segments, entry_live=state_keep
    ).run())
    return VerifyReport(
        name=g.name, instrs=len(cg.program), diagnostics=tuple(diags),
    )
