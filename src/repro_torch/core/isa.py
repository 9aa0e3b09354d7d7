"""The PIMSAB ISA (§IV-A) as typed instructions.

Programs are lists of instructions; each carries the tile set it is issued to
(the per-tile instruction controller broadcasts micro-ops to that tile's
CRAMs, which execute in SIMD lock-step).

Addresses are *wordline* indices inside a CRAM (data is transposed: an
operand of precision P at bitline b occupies wordlines [addr, addr+P) of
column b).  ``size`` is the number of bitlines involved across the tile.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field, fields as _dc_fields, replace
from typing import Dict, Optional, Sequence, Tuple, Union


class Pred(enum.Enum):
    NONE = "none"
    MASK = "mask"    # predicate on the PE mask latch
    CARRY = "carry"  # predicate on the PE carry latch


class ShufflePattern(enum.Enum):
    """`shf` field of load_bcast / tile_bcast (§IV-B shuffle logic)."""
    NONE = "none"            # contiguous
    REPLICATE = "replicate"  # scalar duplicated on every bitline
    STRIDE = "stride"        # element e → CRAM e, duplicated across bitlines
    INTERLEAVE = "interleave"


@dataclass(frozen=True)
class Effect:
    """Declared effect signature of one instruction — the contract the static
    verifier (:mod:`repro_torch.core.compiler.verify`) reasons about.

    ``reads``/``writes`` are half-open CRAM wordline ranges ``(start, end)``
    (identical on every CRAM the instruction's tile set touches — SIMD).
    ``rf_reads``/``rf_writes`` name RF registers, ``mask_read``/``mask_write``
    track the PE mask latch, ``dram`` is ``"load"``/``"store"``/``""`` for
    the DRAM side, and ``resources`` mirrors the phase-timeline resource
    names the simulator's clock model charges (``compute``/``compute@t``,
    ``dram``, ``noc``, ``htree``, ``sync``)."""

    reads: Tuple[Tuple[int, int], ...] = ()
    writes: Tuple[Tuple[int, int], ...] = ()
    rf_reads: Tuple[int, ...] = ()
    rf_writes: Tuple[int, ...] = ()
    mask_read: bool = False
    mask_write: bool = False
    dram: str = ""
    resources: Tuple[str, ...] = ()


@dataclass(frozen=True)
class Instr:
    tiles: Tuple[int, ...] = ()  # empty = all tiles
    # --- phase-timeline scheduling tags (§III overlap) ---------------------
    # The *functional* machine executes instructions in program order; these
    # tags only drive the clock model.  ``phase`` publishes a completion
    # token; ``after`` lists tokens that must complete before this
    # instruction may start (on top of its resource being free).  An
    # instruction with no ``phase`` and no ``after`` — or with ``barrier``
    # set — serializes against *all* earlier work, reproducing the legacy
    # bucket-sum clock exactly.
    phase: Optional[str] = None
    after: Tuple[str, ...] = ()
    barrier: bool = False

    def effect(self) -> Effect:
        """Declared :class:`Effect` signature of this instruction.

        Every concrete subclass must override this (``scripts/check_api.py``
        enforces it) so the static verifier can run liveness, race and
        overflow analyses without interpreting the instruction."""
        raise NotImplementedError(
            f"{type(self).__name__} declares no effect signature; every "
            "concrete Instr subclass must override effect() so the static "
            "verifier (repro_torch.core.compiler.verify) can reason about it"
        )

    def _exec_resources(self) -> Tuple[str, ...]:
        # mirrors Simulator._compute: a tiles-restricted instruction occupies
        # its staggered group's micro-op sequencer, not the chip's
        return ("compute",) if not self.tiles else (f"compute@{self.tiles[0]}",)


# --- compute -------------------------------------------------------------


@dataclass(frozen=True)
class Compute(Instr):
    dst: int = 0
    prec_dst: int = 8
    src1: int = 0
    prec1: int = 8
    src2: Optional[int] = None
    prec2: int = 8
    pred: Pred = Pred.NONE
    size: Optional[int] = None  # bitlines involved (None = all)

    def effect(self) -> Effect:
        reads = [(self.src1, self.src1 + self.prec1)]
        if self.src2 is not None:
            reads.append((self.src2, self.src2 + self.prec2))
        if self.pred is not Pred.NONE:
            # predicated lanes keep the old destination bits — a read-modify
            # merge, so dst is a data input too
            reads.append((self.dst, self.dst + self.prec_dst))
        return Effect(
            reads=tuple(reads),
            writes=((self.dst, self.dst + self.prec_dst),),
            mask_read=self.pred is Pred.MASK,
            resources=self._exec_resources(),
        )


@dataclass(frozen=True)
class Add(Compute):
    cen: bool = False  # use stored carry as carry-in (bit-slicing)
    cst: bool = False  # store carry-out (bit-slicing)


@dataclass(frozen=True)
class Sub(Compute):
    pass


@dataclass(frozen=True)
class Mul(Compute):
    pass


@dataclass(frozen=True)
class Mac(Compute):
    """Fused multiply-accumulate: dst += src1 · src2 (Fig. 8a streaming —
    product bits fold into the accumulator as they become final, so only the
    half-width ``mul_tmp`` live window is resident)."""

    def effect(self) -> Effect:
        base = super().effect()  # accumulate: dst is read-modify-write
        return replace(base, reads=base.reads + ((self.dst, self.dst + self.prec_dst),))


@dataclass(frozen=True)
class Logical(Compute):
    op: str = "and"  # and | or | xor | not

    def effect(self) -> Effect:
        # functional model reads both operands and writes dst at prec1; the
        # xor-self idiom (codegen's _zero) is a pure definition, not a read
        pure_zero = (
            self.op == "xor" and self.src2 == self.src1 and self.dst == self.src1
        )
        reads: Tuple[Tuple[int, int], ...] = ()
        if not pure_zero:
            reads = ((self.src1, self.src1 + self.prec1),)
            if self.src2 is not None:
                reads += ((self.src2, self.src2 + self.prec1),)
        return Effect(
            reads=reads,
            writes=((self.dst, self.dst + self.prec1),),
            mask_read=self.pred is Pred.MASK,
            resources=self._exec_resources(),
        )


@dataclass(frozen=True)
class Copy(Compute):
    def effect(self) -> Effect:
        # writes prec1 bits; a predicated copy merges into dst (read too)
        reads: Tuple[Tuple[int, int], ...] = ((self.src1, self.src1 + self.prec1),)
        if self.pred is not Pred.NONE:
            reads += ((self.dst, self.dst + self.prec1),)
        return Effect(
            reads=reads,
            writes=((self.dst, self.dst + self.prec1),),
            mask_read=self.pred is Pred.MASK,
            resources=self._exec_resources(),
        )


@dataclass(frozen=True)
class CmpGE(Compute):
    """dst(1 bit) = src1 >= src2 — used for ReLU/pooling predication."""

    def effect(self) -> Effect:
        reads = [(self.src1, self.src1 + self.prec1)]
        if self.src2 is not None:
            reads.append((self.src2, self.src2 + self.prec1))
        return Effect(
            reads=tuple(reads),
            writes=((self.dst, self.dst + 1),),
            resources=self._exec_resources(),
        )


@dataclass(frozen=True)
class SetMask(Instr):
    """Copy a wordline into the PE mask latches (§IV-A)."""
    src: int = 0

    def effect(self) -> Effect:
        return Effect(
            reads=((self.src, self.src + 1),),
            mask_write=True,
            resources=self._exec_resources(),
        )


@dataclass(frozen=True)
class ReduceIntra(Instr):
    """Tree-reduce the `size` bitlines of each CRAM to bitline 0 (log2 steps
    of cross-bitline shift + add)."""
    dst: int = 0
    src: int = 0
    prec: int = 8
    size: int = 256

    def effect(self) -> Effect:
        # grows by log2(size) carry bits; the exact-bits path additionally
        # uses [dst+pf, dst+2·pf) as scratch — the allocation contract
        stages = max(0, (self.size - 1).bit_length())
        pf = self.prec + stages
        return Effect(
            reads=((self.src, self.src + self.prec),),
            writes=((self.dst, self.dst + 2 * pf),),
            resources=self._exec_resources(),
        )


@dataclass(frozen=True)
class ReduceHTree(Instr):
    """Reduce across the CRAMs of a tile over the H-tree into one CRAM."""
    dst: int = 0
    src: int = 0
    prec: int = 8

    def effect(self) -> Effect:
        return Effect(
            reads=((self.src, self.src + self.prec),),
            writes=((self.dst, self.dst + self.prec),),
            resources=("htree",),
        )


@dataclass(frozen=True)
class Shift(Instr):
    """Cross-bitline (and cross-CRAM via the ring) shift by `amount` lanes."""
    dst: int = 0
    src: int = 0
    prec: int = 8
    amount: int = 1

    def effect(self) -> Effect:
        return Effect(
            reads=((self.src, self.src + self.prec),),
            writes=((self.dst, self.dst + self.prec),),
            resources=self._exec_resources(),
        )


# --- RF / constants -------------------------------------------------------


@dataclass(frozen=True)
class RfLoad(Instr):
    reg: int = 0
    value: int = 0

    def effect(self) -> Effect:
        return Effect(rf_writes=(self.reg,), resources=("compute",))


@dataclass(frozen=True)
class MulConst(Compute):
    """dst = src1 * RF[reg] with zero-bit skipping (§IV-B)."""
    reg: int = 0

    def effect(self) -> Effect:
        return replace(super().effect(), rf_reads=(self.reg,))


@dataclass(frozen=True)
class MacConst(Compute):
    """Fused dst += src1 · RF[reg] — the constant-operand (mul_const) flavor
    of :class:`Mac`, zero-bit skipping included."""
    reg: int = 0

    def effect(self) -> Effect:
        base = super().effect()  # accumulate: dst is read-modify-write
        return replace(
            base,
            reads=base.reads + ((self.dst, self.dst + self.prec_dst),),
            rf_reads=(self.reg,),
        )


@dataclass(frozen=True)
class AddConst(Compute):
    reg: int = 0

    def effect(self) -> Effect:
        return replace(super().effect(), rf_reads=(self.reg,))


# --- data transfer --------------------------------------------------------


@dataclass(frozen=True)
class DramLoad(Instr):
    dram_addr: int = 0
    cram_addr: int = 0
    bits: int = 0              # payload size
    prec: int = 8
    tr: bool = True            # run through the transpose unit
    shf: ShufflePattern = ShufflePattern.NONE
    bcast_tiles: int = 1       # >1: systolic broadcast to this many tiles
    tag: str = ""              # data-plane binding ("in_a"/"in_b"/"h0"/...):
    fields: int = 1            # consecutive `prec`-bit operands at cram_addr

    def effect(self) -> Effect:
        res = ("dram", "noc", "htree") if self.bcast_tiles > 1 else ("dram",)
        return Effect(
            writes=((self.cram_addr, self.cram_addr + self.fields * self.prec),),
            dram="load",
            resources=res,
        )


@dataclass(frozen=True)
class DramStore(Instr):
    dram_addr: int = 0
    cram_addr: int = 0
    bits: int = 0
    prec: int = 8
    tr: bool = True
    tag: str = ""              # data-plane binding ("out")
    gather_tiles: int = 1      # >1: funnel from this many tiles (reverse of
                               # DramLoad's systolic broadcast pipeline)

    def effect(self) -> Effect:
        res = ("dram", "noc", "htree") if self.gather_tiles > 1 else ("dram",)
        return Effect(
            reads=((self.cram_addr, self.cram_addr + self.prec),),
            dram="store",
            resources=res,
        )


@dataclass(frozen=True)
class TileBcast(Instr):
    """One tile broadcasts a CRAM region to `n_dest` tiles (systolic)."""
    src_tile: int = 0
    n_dest: int = 1
    bits: int = 0
    shf: ShufflePattern = ShufflePattern.NONE

    def effect(self) -> Effect:
        # NoC payloads are not wordline-addressed in this ISA: opaque ranges
        return Effect(resources=("noc",))


@dataclass(frozen=True)
class TileSend(Instr):
    """Point-to-point tile→tile transfer (blocks receiver until data lands)."""
    src_tile: int = 0
    dst_tile: int = 0
    bits: int = 0

    def effect(self) -> Effect:
        return Effect(resources=("noc",))


@dataclass(frozen=True)
class CramBcast(Instr):
    """One CRAM broadcasts to all CRAMs in its tile over the H-tree."""
    src_cram: int = 0
    bits: int = 0
    shf: ShufflePattern = ShufflePattern.NONE

    def effect(self) -> Effect:
        return Effect(resources=("htree",))


@dataclass(frozen=True)
class CramCopy(Instr):
    src_cram: int = 0
    dst_cram: int = 0
    bits: int = 0

    def effect(self) -> Effect:
        return Effect(resources=("htree",))


@dataclass(frozen=True)
class ChipSend(Instr):
    """Push `bits` out of this chip's SerDes link port toward chip `peer`.

    One ChipSend models a whole half of a collective round-trip: `bits` is
    the total port occupancy (e.g. the (N-1)/N·payload a butterfly allreduce
    streams out) and `rounds` the serial link-hop depth charged latency.
    Paired with a ChipRecv on the peer via a shared `x:`-prefixed phase
    token (cross-chip tokens live in the cluster-shared namespace)."""
    chip: int = 0
    peer: int = -1             # -1: collective (all peers)
    bits: int = 0
    rounds: int = 1            # serial link hops (latency fills, bw pipelines)
    tag: str = ""

    def effect(self) -> Effect:
        # link payloads are not wordline-addressed in this ISA: opaque ranges
        return Effect(resources=("link",))


@dataclass(frozen=True)
class ChipRecv(Instr):
    """Pull `bits` in from the link port; completes the matching ChipSend's
    collective (its `after` carries the senders' `x:` tokens).  With
    `sync=True` the receive joins the chip's on-chip frontier — downstream
    work serializes behind it (pipeline-stage boundaries, declined-overlap
    fallback); otherwise only phase-gated consumers wait."""
    chip: int = 0
    peer: int = -1
    bits: int = 0
    rounds: int = 1
    sync: bool = False
    tag: str = ""

    def effect(self) -> Effect:
        return Effect(resources=("link",))


# --- sync -----------------------------------------------------------------


@dataclass(frozen=True)
class Signal(Instr):
    src_tile: int = 0
    dst_tile: int = 0

    def effect(self) -> Effect:
        return Effect(resources=("sync",))


@dataclass(frozen=True)
class Wait(Instr):
    tile: int = 0
    src_tile: int = 0

    def effect(self) -> Effect:
        return Effect(resources=("sync",))


Program = Sequence[Instr]


# --- serialization (golden corpora / diagnostics artifacts) ----------------


def _instr_types() -> Dict[str, type]:
    out: Dict[str, type] = {}
    stack = [Instr]
    while stack:
        cls = stack.pop()
        out[cls.__name__] = cls
        stack.extend(cls.__subclasses__())
    return out


def instr_to_json(ins: Instr) -> Dict:
    """Serialize one instruction to a plain JSON-able dict (``"instr"`` holds
    the class name — distinct from ``Logical``'s ``op`` field; enums by
    value, tuples as lists).  Inverse of :func:`instr_from_json` — used by
    the hand-mutated bad-program corpus under ``tests/golden/bad_programs/``."""
    d: Dict = {"instr": type(ins).__name__}
    for f in _dc_fields(ins):
        v = getattr(ins, f.name)
        if isinstance(v, enum.Enum):
            v = v.value
        elif isinstance(v, tuple):
            v = list(v)
        d[f.name] = v
    return d


def instr_from_json(d: Dict) -> Instr:
    """Rebuild an instruction from :func:`instr_to_json` output."""
    cls = _instr_types().get(d.get("instr", ""))
    if cls is None or cls in (Instr, Compute):
        raise ValueError(f"unknown instruction class {d.get('instr')!r}")
    kw = {}
    for f in _dc_fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if f.name == "pred":
            v = Pred(v)
        elif f.name == "shf":
            v = ShufflePattern(v)
        elif isinstance(v, list):
            v = tuple(v)
        kw[f.name] = v
    return cls(**kw)
