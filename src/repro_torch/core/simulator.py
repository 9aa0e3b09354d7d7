"""PIMSAB simulator: executes ISA programs.

Two coupled modes, selected per run:

* ``timing``     (always on) — analytic cycle & energy accounting per
  instruction using core.timing / core.energy / core.noc; produces the
  Fig-11-style per-category breakdowns at full machine scale.
* ``functional`` — bit-exact execution, lazily allocating CRAM state as
  instructions touch it.  By default every touched CRAM is a slot of one
  tile-batched ``core.cram.CramBank`` and each compute instruction runs as a
  single vectorized kernel over all tiles × lanes at once (cross-tile ops —
  H-tree reduce, systolic broadcast, DRAM gather — index per tile); with
  ``exact_bits=True`` each CRAM is an independent ``Cram`` running the
  literal per-bit ``pe_step`` loops, the differential reference the fuzz
  harness compares against.  Cycles and energy are charged analytically
  before functional dispatch either way, so both paths produce identical
  ``SimResult`` numbers by construction.

**The clock is a phase-timeline engine, not a bucket sum.**  Each
instruction occupies one or more *resources* (the compute micro-op
sequencer — per staggered tile group when the compiler splits one —, the
DRAM channel, the NoC, the H-tree, the sync network) for its stage
durations; it may start once its declared ``after`` dependency tokens have
completed and its resources are free.  Chip time (``SimResult.makespan`` ==
``total_cycles``) is the completion time of the last instruction, so
schedules whose phases carry explicit dependency tokens (``Instr.phase`` /
``Instr.after`` — codegen emits prefetch-next-chunk-during-compute,
double-buffered schedules) model DRAM↔compute overlap, while untagged
programs — or any program run with ``serialize=True`` — reproduce the old
fully-serialized totals exactly (every instruction is a barrier).

Three views of the same run:

* ``cycles``        — *charged* cycles per category, exactly the legacy
  buckets (each DRAM burst pays its full stream + latency here);
  ``serialized_cycles`` is their sum, the no-overlap clock.
* ``busy``          — per-resource *occupancy* on the timeline (a DRAM
  burst occupies the channel only for its streaming cycles; its access
  latency delays the dependent's start, pipelined across bursts).
* ``critical_path`` — the makespan attributed to the category that was
  advancing the clock when it moved.

Functional execution is order-based and never consults the timeline: the
tags change the clock model only, so results are bit-exact regardless of
modeled overlap.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import htree, isa, noc, timing
from repro_torch.core.cram import Cram, CramBank, CramView
from repro_torch.core.energy import EnergyLedger
from repro_torch.core.machine import PimsabConfig


class UninitializedRfError(RuntimeError):
    """A MacConst/MulConst consulted an RF register never RfLoad-ed —
    the program would silently compute with an arbitrary constant."""


@dataclass
class SimResult:
    # charged cycles per category — the legacy buckets (serialized view)
    cycles: Dict[str, float] = field(default_factory=lambda: {
        "compute": 0.0, "dram": 0.0, "noc": 0.0, "htree": 0.0, "sync": 0.0,
    })
    energy: EnergyLedger = field(default_factory=EnergyLedger)
    instrs: int = 0
    # phase-timeline views
    makespan: float = 0.0                      # modeled chip time
    busy: Dict[str, float] = field(default_factory=dict)           # per resource
    critical_path: Dict[str, float] = field(default_factory=dict)  # per category
    timeline: Optional[List[Dict]] = None      # populated when recording

    @property
    def total_cycles(self) -> float:
        """Modeled chip time = the timeline makespan (== the serialized sum
        for fully-dependent schedules)."""
        return self.makespan

    @property
    def serialized_cycles(self) -> float:
        """What a fully-serialized machine would pay: the charged-bucket sum
        (the pre-timeline ``total_cycles``)."""
        return sum(self.cycles.values())

    @property
    def overlapped_cycles(self) -> float:
        """Cycles the schedule hid behind other resources' work."""
        return max(0.0, self.serialized_cycles - self.makespan)

    def seconds(self, cfg: PimsabConfig) -> float:
        return timing.seconds(cfg, self.total_cycles)

    def breakdown(self) -> Dict[str, float]:
        """Charged-cycle fraction per category (busy share of the serialized
        clock — the Fig-11 view; overlap does not change it)."""
        t = max(self.serialized_cycles, 1e-30)
        return {k: v / t for k, v in self.cycles.items()}

    def critical_breakdown(self) -> Dict[str, float]:
        """Fraction of the *makespan* each category was responsible for
        advancing — the critical-path view of the pipelined machine."""
        t = max(self.makespan, 1e-30)
        return {k: v / t for k, v in self.critical_path.items()}

    def utilization(self) -> Dict[str, float]:
        """Per-resource busy fraction of the makespan (≤ 1 by construction:
        a resource cannot be occupied longer than the clock ran)."""
        t = max(self.makespan, 1e-30)
        return {k: v / t for k, v in self.busy.items()}


def _category(resource: str) -> str:
    return resource.split("@", 1)[0]


class Simulator:
    def __init__(
        self,
        cfg: Optional[PimsabConfig] = None,
        functional: bool = False,
        exact_bits: bool = False,
        serialize: bool = False,
        record_timeline: bool = False,
        shared_tokens: Optional[Dict[str, float]] = None,
        record_stream: bool = False,
    ):
        from repro_torch.core.machine import PIMSAB

        self.cfg = cfg if cfg is not None else PIMSAB
        self.functional = functional
        self.exact_bits = exact_bits
        self.serialize = serialize  # compat mode: ignore phase tags entirely
        self.crams: Dict[tuple, Cram] = {}  # (tile, cram) -> Cram, lazy
        # batched functional state: every touched CRAM is a slot of one
        # (slots, rows, cols) bank and each instruction executes as a single
        # numpy op across all of them; exact_bits keeps per-tile Cram objects
        # running the literal per-bit pe_step loops (the reference path)
        self.bank: Optional[CramBank] = None
        if functional and not exact_bits:
            self.bank = CramBank(self.cfg.cram_rows, self.cfg.cram_cols)
        self._slot_cache: Dict[tuple, tuple] = {}  # tiles -> (slots, owners)
        self.rf: Dict[tuple, int] = {}      # (tile, reg) -> value
        self.res = SimResult()
        if record_timeline:
            self.res.timeline = []
        # timeline state
        self._free: Dict[str, float] = {}    # resource -> channel-free time
        self._tokens: Dict[str, float] = {}  # phase token -> completion time
        self._floor: float = 0.0             # last barrier's completion
        # multi-chip: per-chip Simulators share wall-clock t=0 and publish
        # tokens whose phase starts with "x:" into this cluster-wide dict, so
        # a ChipRecv's `after` can wait on peers' ChipSend completions.  The
        # on-chip frontier tracks everything *except* in-flight link
        # transfers — barriers serialize behind local work but not behind
        # link streaming, which is how cross-chip collectives genuinely
        # overlap compute (single-chip: _onchip == makespan, so behavior is
        # unchanged).
        self._shared_tokens = shared_tokens
        self._onchip: float = 0.0            # frontier excluding pure-link work
        # opt-in: keep the exact instruction sequence stepped through this
        # simulator (the ISA gate re-verifies per-chip cluster streams)
        self.stream: Optional[list] = [] if record_stream else None

    # -- functional state access (tests drive these) -----------------------
    def cram(self, tile: int = 0, idx: int = 0) -> Cram:
        key = (tile, idx)
        if key not in self.crams:
            if self.bank is not None:
                self.crams[key] = CramView(self.bank, self.bank.add_slot())
            else:
                self.crams[key] = Cram(
                    self.cfg.cram_rows, self.cfg.cram_cols, exact_bits=self.exact_bits
                )
            self._slot_cache.clear()  # the active SIMD set just grew
        return self.crams[key]

    def _tiles(self, ins: isa.Instr) -> List[int]:
        return list(ins.tiles) if ins.tiles else list(range(self.cfg.num_tiles))

    def _active_crams(self, tile: int) -> List[int]:
        """CRAM indices to execute SIMD compute on: the ones holding data.

        Every CRAM of a tile executes the same micro-op stream; functionally
        only the CRAMs the data plane has touched can produce observable
        results, so the lazy dict doubles as the active set (cram 0 always
        participates, preserving the single-CRAM test idiom)."""
        idxs = sorted({c for (t, c) in self.crams if t == tile} | {0})
        return idxs

    # -- the timeline scheduler --------------------------------------------
    def _token_get(self, tok: str) -> float:
        at = self._tokens.get(tok, 0.0)
        if self._shared_tokens is not None and tok.startswith("x:"):
            at = max(at, self._shared_tokens.get(tok, 0.0))
        return at

    def _token_put(self, tok: str, at: float) -> None:
        self._tokens[tok] = max(self._tokens.get(tok, 0.0), at)
        if self._shared_tokens is not None and tok.startswith("x:"):
            self._shared_tokens[tok] = max(self._shared_tokens.get(tok, 0.0), at)

    def _schedule(
        self,
        ins: isa.Instr,
        stages: Dict[str, float],
        charge: Dict[str, float],
        latency: float = 0.0,
        early_token: bool = False,
        floor_onchip: bool = False,
        charge_stall: bool = False,
    ) -> None:
        """Place ``ins`` on the timeline.

        ``stages`` maps each resource the instruction occupies to its
        occupancy; the instruction completes ``max(stages) + latency`` after
        it starts (``latency`` delays dependents without holding a channel —
        the pipelined DRAM-burst model).  ``charge`` is the legacy bucket
        accounting.  ``early_token`` publishes the completion token at
        occupancy end instead (a DramStore's WAR hazard on its source buffer
        ends when the CRAM read finishes, not when DRAM acknowledges).
        ``floor_onchip`` floors the start at the on-chip frontier even for
        phase-tagged instructions (a ChipSend cannot stream a payload the
        chip hasn't finished computing).  ``charge_stall`` books the idle
        wait before ``start`` into the ``sync`` bucket — a synchronizing
        cross-chip receive stalls the whole chip on another chip's clock,
        time no local bucket would otherwise account for (keeps the
        ``makespan <= serialized_cycles`` invariant true per chip).
        """
        res = self.res
        for k, v in charge.items():
            res.cycles[k] = res.cycles.get(k, 0.0) + v
        dur = max(stages.values(), default=0.0)
        is_barrier = (
            self.serialize or ins.barrier or (ins.phase is None and not ins.after)
        )
        if is_barrier:
            # after all *on-chip* work issued so far (== makespan when no
            # link transfers are in flight) + any cross-chip tokens it names
            start = self._onchip
            for tok in ins.after:
                start = max(start, self._token_get(tok))
            for r in stages:
                start = max(start, self._free.get(r, 0.0))
        else:
            start = self._floor
            for tok in ins.after:
                start = max(start, self._token_get(tok))
            for r in stages:
                start = max(start, self._free.get(r, 0.0))
            if floor_onchip:
                start = max(start, self._onchip)
        if charge_stall:
            stall = max(0.0, start - self._onchip)
            res.cycles["sync"] = res.cycles.get("sync", 0.0) + stall
        for r, v in stages.items():
            self._free[r] = start + v
            res.busy[r] = res.busy.get(r, 0.0) + v
        done = start + dur + latency
        if not self.serialize and ins.phase is not None:
            token_at = start + dur if early_token else done
            self._token_put(ins.phase, token_at)
        if is_barrier:
            self._floor = done
        pure_link = bool(stages) and all(r == "link" for r in stages)
        if not pure_link or getattr(ins, "sync", False) or is_barrier:
            self._onchip = max(self._onchip, done)
        if done > res.makespan:
            primary = _category(max(stages, key=stages.__getitem__)) if stages else "sync"
            res.critical_path[primary] = (
                res.critical_path.get(primary, 0.0) + done - res.makespan
            )
            res.makespan = done
        if res.timeline is not None:
            res.timeline.append({
                "i": res.instrs - 1,
                "op": type(ins).__name__,
                "phase": ins.phase,
                "after": list(ins.after),
                "start": start,
                "end": done,
                "stages": {r: start + v for r, v in stages.items()},
            })

    # -- execution ----------------------------------------------------------
    def run(self, program) -> SimResult:
        for ins in program:
            self.step(ins)
        return self.res

    def _crams(self, tiles: List[int]):
        for t in tiles:
            for c in self._active_crams(t):
                yield t, self.cram(t, c)

    def _slots(self, tiles: List[int]):
        """Bank slots of the active CRAMs of ``tiles`` (+ owning tile per
        slot, for per-tile RF constants).  Cached per tile set — the active
        set only changes when the data plane lazily touches a new CRAM."""
        key = tuple(tiles)
        hit = self._slot_cache.get(key)
        if hit is None:
            slots, owners = [], []
            for t in tiles:
                self.cram(t, 0)  # CRAM 0 always participates
                for c in self._active_crams(t):
                    slots.append(self.cram(t, c)._slot)
                    owners.append(t)
            hit = (np.asarray(slots, np.intp), tuple(owners))
            self._slot_cache[key] = hit
        return hit

    def _rf_value(self, tile: int, reg: int, ins: isa.Instr) -> int:
        key = (tile, reg)
        if key not in self.rf:
            raise UninitializedRfError(
                f"{type(ins).__name__} reads RF[{reg}] on tile {tile} but no "
                "RfLoad ever initialized it — the constant-operand path would "
                "silently compute with an arbitrary value"
            )
        return self.rf[key]

    def step(self, ins: isa.Instr) -> None:
        cfg, res = self.cfg, self.res
        if self.stream is not None:
            self.stream.append(ins)
        res.instrs += 1
        tiles = self._tiles(ins)
        res.energy.controller(1, len(tiles))

        if isinstance(ins, isa.Add) or isinstance(ins, isa.Sub):
            c = timing.cycles_add(ins.prec1, ins.prec2)
            self._compute(ins, c)
            if self.functional:
                if self.bank is not None:
                    sl, _ = self._slots(tiles)
                    if isinstance(ins, isa.Sub):
                        self.bank.sub(sl, ins.dst, ins.src1, ins.src2,
                                      ins.prec1, ins.prec2, ins.prec_dst)
                    else:
                        self.bank.add(sl, ins.dst, ins.src1, ins.src2, ins.prec1,
                                      ins.prec2, ins.prec_dst, cen=ins.cen,
                                      cst=ins.cst, pred=ins.pred.value)
                else:
                    for _, cr in self._crams(tiles):
                        if isinstance(ins, isa.Sub):
                            cr.sub(ins.dst, ins.src1, ins.src2, ins.prec1, ins.prec2, ins.prec_dst)
                        else:
                            cr.add(ins.dst, ins.src1, ins.src2, ins.prec1, ins.prec2,
                                   ins.prec_dst, cen=ins.cen, cst=ins.cst, pred=ins.pred.value)
        elif isinstance(ins, isa.MacConst):
            c = timing.cycles_mac_const(
                ins.prec1, self._rf_value(tiles[0], ins.reg, ins), ins.prec_dst
            )
            self._compute(ins, c)
            res.energy.rf(len(tiles))
            if self.functional:
                if self.bank is not None:
                    sl, owners = self._slots(tiles)
                    consts = np.asarray(
                        [self._rf_value(t, ins.reg, ins) for t in owners], np.int64
                    )
                    self.bank.mac_const(sl, ins.dst, ins.src1, consts,
                                        ins.prec1, ins.prec_dst)
                else:
                    for t, cr in self._crams(tiles):
                        cr.mac_const(ins.dst, ins.src1, self._rf_value(t, ins.reg, ins),
                                     ins.prec1, ins.prec_dst)
        elif isinstance(ins, isa.MulConst):
            z_cycles = timing.cycles_mul_const(
                ins.prec1, self._rf_value(tiles[0], ins.reg, ins)
            )
            self._compute(ins, z_cycles)
            res.energy.rf(len(tiles))
            if self.functional:
                if self.bank is not None:
                    sl, owners = self._slots(tiles)
                    consts = np.asarray(
                        [self._rf_value(t, ins.reg, ins) for t in owners], np.int64
                    )
                    self.bank.mul_const(sl, ins.dst, ins.src1, consts,
                                        ins.prec1, ins.prec_dst)
                else:
                    for t, cr in self._crams(tiles):
                        cr.mul_const(ins.dst, ins.src1, self._rf_value(t, ins.reg, ins),
                                     ins.prec1, ins.prec_dst)
        elif isinstance(ins, isa.Mac):
            c = timing.cycles_mac(ins.prec1, ins.prec2, ins.prec_dst)
            self._compute(ins, c)
            if self.functional:
                if self.bank is not None:
                    sl, _ = self._slots(tiles)
                    self.bank.mac(sl, ins.dst, ins.src1, ins.src2,
                                  ins.prec1, ins.prec2, ins.prec_dst)
                else:
                    for _, cr in self._crams(tiles):
                        cr.mac(ins.dst, ins.src1, ins.src2, ins.prec1, ins.prec2, ins.prec_dst)
        elif isinstance(ins, isa.Mul):
            c = timing.cycles_mul(ins.prec1, ins.prec2)
            self._compute(ins, c)
            if self.functional:
                if self.bank is not None:
                    sl, _ = self._slots(tiles)
                    self.bank.mul(sl, ins.dst, ins.src1, ins.src2,
                                  ins.prec1, ins.prec2, ins.prec_dst)
                else:
                    for _, cr in self._crams(tiles):
                        cr.mul(ins.dst, ins.src1, ins.src2, ins.prec1, ins.prec2, ins.prec_dst)
        elif isinstance(ins, isa.Logical):
            self._compute(ins, timing.cycles_logical(ins.prec1, ins.prec2))
            if self.functional:
                if self.bank is not None:
                    sl, _ = self._slots(tiles)
                    self.bank.logical(sl, ins.dst, ins.src1, ins.src2, ins.prec1, ins.op)
                else:
                    for _, cr in self._crams(tiles):
                        cr.logical(ins.dst, ins.src1, ins.src2, ins.prec1, ins.op)
        elif isinstance(ins, isa.Copy):
            self._compute(ins, timing.cycles_copy(ins.prec1))
            if self.functional:
                if self.bank is not None:
                    sl, _ = self._slots(tiles)
                    self.bank.copy(sl, ins.dst, ins.src1, ins.prec1, pred=ins.pred.value)
                else:
                    for _, cr in self._crams(tiles):
                        cr.copy(ins.dst, ins.src1, ins.prec1, pred=ins.pred.value)
        elif isinstance(ins, isa.CmpGE):
            self._compute(ins, ins.prec1 + 2)
            if self.functional:
                if self.bank is not None:
                    sl, _ = self._slots(tiles)
                    self.bank.cmp_ge(sl, ins.dst, ins.src1, ins.src2, ins.prec1)
                else:
                    for _, cr in self._crams(tiles):
                        cr.cmp_ge(ins.dst, ins.src1, ins.src2, ins.prec1)
        elif isinstance(ins, isa.SetMask):
            self._compute(ins, 1)
            if self.functional:
                if self.bank is not None:
                    sl, _ = self._slots(tiles)
                    self.bank.set_mask(sl, ins.src)
                else:
                    for _, cr in self._crams(tiles):
                        cr.set_mask(ins.src)
        elif isinstance(ins, isa.ReduceIntra):
            self._compute(ins, timing.cycles_reduce_intra(ins.prec, ins.size))
            if self.functional:
                if self.bank is not None:
                    sl, _ = self._slots(tiles)
                    self.bank.reduce_intra(sl, ins.dst, ins.src, ins.prec, ins.size)
                else:
                    for _, cr in self._crams(tiles):
                        cr.reduce_intra(ins.dst, ins.src, ins.prec, ins.size)
        elif isinstance(ins, isa.ReduceHTree):
            c = timing.cycles_htree_reduce(cfg, ins.prec)
            bits = cfg.crams_per_tile * cfg.cram_cols * ins.prec
            res.energy.htree(bits * len(tiles))
            self._schedule(ins, {"htree": c}, {"htree": c})
            if self.functional:
                # elementwise per-bitline sum over the tile's populated CRAMs
                # in the H-tree's pairwise order (integers, so the order is
                # immaterial — matching htree.reduce_functional keeps one
                # summation story across all layers); the result lands in
                # CRAM 0 as the paper's designated root.  Cross-tile ops stay
                # per-tile: only the intra-tile leaf read is batched.
                for t in tiles:
                    idxs = self._active_crams(t)
                    if self.bank is not None:
                        sl = np.asarray([self.cram(t, c)._slot for c in idxs], np.intp)
                        leaves = self.bank.field(sl, ins.src, ins.prec)
                    else:
                        leaves = [self.cram(t, c).read(ins.src, ins.prec) for c in idxs]
                    total = htree.reduce_functional(list(leaves))
                    self.cram(t, 0).write(ins.dst, total, ins.prec)
        elif isinstance(ins, isa.Shift):
            self._compute(ins, timing.cycles_cram_shift(cfg, ins.prec, abs(ins.amount)))
            if self.functional:
                if self.bank is not None:
                    sl, _ = self._slots(tiles)
                    self.bank.shift_lanes(sl, ins.dst, ins.src, ins.prec, ins.amount)
                else:
                    for _, cr in self._crams(tiles):
                        cr.shift_lanes(ins.dst, ins.src, ins.prec, ins.amount)
        elif isinstance(ins, isa.RfLoad):
            res.energy.rf(len(tiles))
            self._schedule(ins, {"compute": 1.0}, {"compute": 1.0})
            for t in tiles:
                self.rf[(t, ins.reg)] = ins.value
        elif isinstance(ins, isa.DramLoad):
            lat = cfg.dram_latency_cycles
            stream = timing.cycles_dram_stream(cfg, ins.bits)
            if ins.bcast_tiles > 1:
                # broadcast path is a pipeline: DRAM → systolic NoC ring →
                # per-tile H-tree (each tile's shuffle slice = bits/tiles);
                # the slowest stage bounds throughput, + burst latency fill
                noc_c = noc.systolic_bcast_cycles(cfg, ins.bits, ins.bcast_tiles)
                tree_c = timing.cycles_htree_bcast(cfg, ins.bits // max(ins.bcast_tiles, 1))
                c = max(stream, noc_c, tree_c) + lat
                res.energy.noc(ins.bits, ins.bcast_tiles)
                res.energy.htree(ins.bits)
                self._schedule(
                    ins,
                    {"dram": stream, "noc": noc_c, "htree": tree_c},
                    {"dram": stream + lat, "noc": c - stream - lat},
                    latency=lat,
                )
            else:
                self._schedule(ins, {"dram": stream}, {"dram": stream + lat}, latency=lat)
            res.energy.dram(ins.bits, transpose=ins.tr)
            res.energy.noc(ins.bits, noc.avg_dram_hops(cfg))
        elif isinstance(ins, isa.DramStore):
            # symmetric with DramLoad: explicit stream/latency split, and the
            # gather funnel (per-tile H-tree collect → systolic NoC → DRAM
            # stream) mirrors the broadcast pipeline when gather_tiles > 1
            lat = cfg.dram_latency_cycles
            stream = timing.cycles_dram_stream(cfg, ins.bits)
            if ins.gather_tiles > 1:
                noc_c = noc.systolic_gather_cycles(cfg, ins.bits, ins.gather_tiles)
                tree_c = timing.cycles_htree_bcast(cfg, ins.bits // max(ins.gather_tiles, 1))
                c = max(stream, noc_c, tree_c) + lat
                res.energy.noc(ins.bits, ins.gather_tiles)
                res.energy.htree(ins.bits)
                self._schedule(
                    ins,
                    {"dram": stream, "noc": noc_c, "htree": tree_c},
                    {"dram": stream + lat, "noc": c - stream - lat},
                    latency=lat,
                    early_token=True,
                )
            else:
                self._schedule(
                    ins, {"dram": stream}, {"dram": stream + lat},
                    latency=lat, early_token=True,
                )
            res.energy.dram(ins.bits, transpose=ins.tr)
            res.energy.noc(ins.bits, noc.avg_dram_hops(cfg))
        elif isinstance(ins, isa.TileBcast):
            c = noc.systolic_bcast_cycles(cfg, ins.bits, ins.n_dest)
            res.energy.noc(ins.bits, ins.n_dest)
            self._schedule(ins, {"noc": c}, {"noc": c})
        elif isinstance(ins, isa.TileSend):
            c = noc.p2p_cycles(cfg, ins.src_tile, ins.dst_tile, ins.bits)
            res.energy.noc(ins.bits, noc.hops(cfg, ins.src_tile, ins.dst_tile))
            self._schedule(ins, {"noc": c}, {"noc": c})
        elif isinstance(ins, isa.CramBcast):
            c = timing.cycles_htree_bcast(cfg, ins.bits)
            res.energy.htree(ins.bits)
            self._schedule(ins, {"htree": c}, {"htree": c})
        elif isinstance(ins, isa.CramCopy):
            c = math.ceil(ins.bits / cfg.c2c_bw_bits)
            res.energy.htree(ins.bits, levels=2)
            self._schedule(ins, {"htree": c}, {"htree": c})
        elif isinstance(ins, (isa.Signal, isa.Wait)):
            self._schedule(ins, {"sync": 2.0}, {"sync": 2.0})
        elif isinstance(ins, (isa.ChipSend, isa.ChipRecv)):
            # inter-chip link: the port streams `bits` (occupancy); the
            # serial hop latency (`rounds` deep) delays completion only —
            # back-to-back collective rounds pipeline, like DRAM bursts.
            stream = timing.cycles_link_stream(cfg, ins.bits)
            lat = cfg.link_latency_cycles * max(1, ins.rounds)
            res.energy.link(ins.bits)
            self._schedule(
                ins, {"link": float(stream)}, {"link": float(stream + lat)},
                latency=float(lat),
                floor_onchip=isinstance(ins, isa.ChipSend),
                charge_stall=bool(getattr(ins, "sync", False)),
            )
        else:
            raise ValueError(f"unhandled instruction {ins}")

    def _compute(self, ins, cycles: float) -> None:
        active = self.cfg.crams_per_tile * len(self._tiles(ins))
        self.res.energy.compute(cycles, active)
        # staggered tile groups compute independently: a tiles-restricted
        # instruction occupies its group's micro-op sequencer, not the chip's
        resource = "compute" if not ins.tiles else f"compute@{ins.tiles[0]}"
        self._schedule(ins, {resource: float(cycles)}, {"compute": float(cycles)})
