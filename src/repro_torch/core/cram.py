"""Functional bit-serial CRAM: a (wordlines × bitlines) bit array + one PE per
bitline, executing the Neural-Cache-style bit-serial algorithms exactly.

Every method returns the cycle count it consumed (== micro-ops issued): one
``pe_step`` across the bitline vector per cycle, exactly how the hardware
walks wordlines.  timing.py mirrors these counts analytically; tests assert
the functional results equal plain integer arithmetic AND that cycles match
the paper's formulas (add: P+1, mul: ~b·(a+2), mul_const: set-bits·(a+2)).

Layout: transposed.  An operand of precision P at wordline base `addr`
occupies rows [addr, addr+P), LSB first, two's complement, one element per
bitline.

Two execution paths compute identical results and identical cycle counts:

* ``exact_bits=True``  — the literal per-bit ``pe_step`` loops (the PE-level
  reference; O(P²) numpy calls for a multiply).
* ``exact_bits=False`` (default) — vectorized field arithmetic: operands are
  gathered from their bit planes into int64 lane vectors, computed in one
  shot, and scattered back, with two's-complement wrap (``& (2^P - 1)``),
  carry-latch, and mask-predication semantics reproduced bit-exactly.  This
  is the packbits-style vectorization that makes whole-program functional
  simulation of registry-sized kernels tractable (one numpy op per bit
  *plane* instead of per bit *step*).

``tests/test_cram_properties.py`` drives both paths differentially.

A third representation, :class:`CramBank`, stacks the state of *every* CRAM
the simulator touches into single ``(slots, rows, cols)`` arrays so one
instruction executes as one batched numpy op across all tiles × lanes at
once (the tile dimension joins the bitline dimension in the vectorization).
:class:`CramView` projects a bank slot back through the ``Cram`` API, so the
data plane, tests, and the H-tree reduce keep their per-CRAM view while the
compute hot path never loops over tiles in Python.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.core.pe import pe_step


class Cram:
    def __init__(self, rows: int = 256, cols: int = 256, exact_bits: bool = False):
        self.rows, self.cols = rows, cols
        self.exact_bits = exact_bits
        self.bits = np.zeros((rows, cols), np.uint8)
        self.carry = np.zeros(cols, np.uint8)
        self.mask = np.ones(cols, np.uint8)

    # ---- transposed I/O (the DRAM-controller transpose unit) -------------

    def write(self, addr: int, values: np.ndarray, prec: int) -> None:
        v = np.asarray(values, np.int64) & ((1 << prec) - 1)
        n = min(len(v), self.cols)
        for i in range(prec):
            self.bits[addr + i, :n] = (v[:n] >> i) & 1

    def read(self, addr: int, prec: int, signed: bool = True, n: Optional[int] = None) -> np.ndarray:
        n = self.cols if n is None else n
        acc = np.zeros(n, np.int64)
        for i in range(prec):
            acc |= self.bits[addr + i, :n].astype(np.int64) << i
        if signed:
            sign = (acc >> (prec - 1)) & 1
            acc = acc - (sign << prec)
        return acc

    def write_block(self, addr: int, values: np.ndarray, prec: int) -> None:
        """Transpose-unit write of several fields in one shot: row ``j`` of
        ``values`` (shape ``(fields, lanes)``) lands at ``addr + j*prec``.
        One strided bit-plane scatter replaces the per-field python loop —
        the DRAM-side twin of the batched compute path."""
        v = np.asarray(values, np.int64)
        if v.ndim == 1:
            v = v[None, :]
        v = v & ((1 << prec) - 1)
        n = min(v.shape[1], self.cols)
        planes = ((v[:, None, :n] >> np.arange(prec)[None, :, None]) & 1).astype(np.uint8)
        self.bits[addr:addr + v.shape[0] * prec, :n] = planes.reshape(-1, n)

    # ---- helpers ----------------------------------------------------------

    def _bit(self, base: int, i: int, prec: int, signed: bool = True) -> np.ndarray:
        """i-th bit of the operand at `base` with sign extension beyond prec."""
        if i < prec:
            return self.bits[base + i]
        return self.bits[base + prec - 1] if signed else np.zeros(self.cols, np.uint8)

    def _field(self, addr: int, prec: int, signed: bool = True) -> np.ndarray:
        """All-lane signed value of the operand at `addr` (fast-path gather)."""
        return self.read(addr, prec, signed=signed)

    def _store(self, addr: int, vals: np.ndarray, prec: int) -> None:
        """Scatter an int64 lane vector back to bit planes, wrapping mod 2^prec."""
        v = np.asarray(vals, np.int64) & ((1 << prec) - 1)
        for i in range(prec):
            self.bits[addr + i] = ((v >> i) & 1).astype(np.uint8)

    # ---- compute (each returns cycles) ------------------------------------

    def copy(self, dst: int, src: int, prec: int, pred: str = "none") -> int:
        if pred == "mask":
            keep = self.mask.astype(bool)
            for i in range(prec):
                self.bits[dst + i] = np.where(keep, self.bits[src + i], self.bits[dst + i])
        else:
            for i in range(prec):
                self.bits[dst + i] = self.bits[src + i]
        return prec

    def logical(self, dst: int, a: int, b: Optional[int], prec: int, op: str) -> int:
        bb = a if b is None else b  # single-operand ops ("not") pass src2=None
        for i in range(prec):
            r, self.carry = pe_step(self.bits[a + i], self.bits[bb + i], self.carry, self.mask, op)
            self.bits[dst + i] = r
        return prec

    def set_mask(self, src: int) -> int:
        self.mask = self.bits[src].copy()
        return 1

    def add(
        self, dst: int, a: int, b: int, pa: int, pb: int, pd: int,
        cen: bool = False, cst: bool = True, pred: str = "none", negate_b: bool = False,
    ) -> int:
        """dst[pd] = a[pa] + b[pb] (ripple, one bit per cycle).  cen/cst are
        the bit-slicing carry-enable/carry-store fields; negate_b gives sub."""
        # carry-predication consults the *running* carry bit-by-bit — only the
        # literal ripple loop reproduces it
        if self.exact_bits or pred == "carry":
            return self._add_bits(dst, a, b, pa, pb, pd, cen, cst, pred, negate_b)
        m = (1 << pd) - 1
        ua = self._field(a, pa) & m
        vb = self._field(b, pb)
        ub = (~vb if negate_b else vb) & m
        cin = self.carry.astype(np.int64) if cen else (1 if negate_b else 0)
        tot = ua + ub + cin
        res = tot & m
        if pred == "mask":
            res = np.where(self.mask.astype(bool), res, self._field(dst, pd, signed=False))
        self._store(dst, res, pd)
        if cst:
            self.carry = ((tot >> pd) & 1).astype(np.uint8)
        # pd == max(pa,pb)+1 for a full add, so the cycle count IS the paper's
        # P+1 formula; bit-sliced chunks (smaller pd) cost pd as well.
        return pd

    def _add_bits(self, dst, a, b, pa, pb, pd, cen, cst, pred, negate_b) -> int:
        carry = self.carry if cen else (np.ones(self.cols, np.uint8) if negate_b else np.zeros(self.cols, np.uint8))
        cycles = 0
        for i in range(pd):
            abit = self._bit(a, i, pa)
            bbit = self._bit(b, i, pb)
            if negate_b:
                bbit = 1 - bbit
            old = self.bits[dst + i]
            r, carry = pe_step(abit, bbit, carry, self.mask, "add", pred, old)
            self.bits[dst + i] = r
            cycles += 1
        if cst:
            self.carry = carry.astype(np.uint8)
        return cycles

    def sub(self, dst: int, a: int, b: int, pa: int, pb: int, pd: int) -> int:
        return self.add(dst, a, b, pa, pb, pd, negate_b=True)

    def cmp_ge(self, dst: int, a: int, b: int, prec: int) -> int:
        """dst (1 bit) = (a >= b), via the sign of a - b."""
        if self.exact_bits:
            carry = np.ones(self.cols, np.uint8)
            sign = np.zeros(self.cols, np.uint8)
            for i in range(prec + 1):
                abit = self._bit(a, i, prec)
                bbit = 1 - self._bit(b, i, prec)
                sign, carry = pe_step(abit, bbit, carry, self.mask, "add")
            self.bits[dst] = 1 - sign
        else:
            # a - b over prec+1 bits never overflows, so the sign IS (a < b)
            self.bits[dst] = (self._field(a, prec) >= self._field(b, prec)).astype(np.uint8)
        return prec + 2

    def _mul_cycles(self, pb: int, pd: int) -> int:
        # per partial product j: one set_mask + a (pd-j)-bit ripple + carry commit
        return sum(pd - j + 2 for j in range(min(pb, pd)))

    def mul(self, dst: int, a: int, b: int, pa: int, pb: int, pd: int) -> int:
        """Signed shift-add multiply (predicated adds — Neural Cache §4.3).

        cycles ≈ Σ_j (pa + 2): per partial product one set_mask + a ripple add
        of `a` (sign-extended) into dst at offset j, predicated on bit j of b.
        The top bit of b has negative weight (two's complement) → subtract.
        """
        if not self.exact_bits:
            res = self._field(a, pa) * self._field(b, pb)
            self._store(dst, res, pd)
            return self._mul_cycles(pb, pd)
        cycles = 0
        for i in range(pd):
            self.bits[dst + i] = 0
        saved_mask = self.mask.copy()
        for j in range(min(pb, pd)):
            self.mask = self.bits[b + j]
            cycles += 1  # set_mask
            negate = j == pb - 1  # negative weight of the sign bit
            carry = np.ones(self.cols, np.uint8) if negate else np.zeros(self.cols, np.uint8)
            for i in range(pd - j):
                abit = self._bit(a, i, pa)
                if negate:
                    abit = 1 - abit
                old = self.bits[dst + j + i]
                r, carry = pe_step(abit, old, carry, self.mask, "add", "mask", old)
                self.bits[dst + j + i] = r
                cycles += 1
            cycles += 1  # carry commit
        self.mask = saved_mask
        return cycles

    def _mul_const_cycles(self, const: int, pa: int, pd: int) -> int:
        cycles = 0
        c, j = abs(int(const)), 0
        while c:
            if c & 1:
                cycles += max(pd - j, 0) + 2
            c >>= 1
            j += 1
        if const < 0:
            cycles += pd
        return cycles

    def mul_const(self, dst: int, a: int, const: int, pa: int, pd: int) -> int:
        """dst = a * const with zero-bit skipping: only set bits of |const|
        issue a ripple add (paper: z·(a+2) cycles)."""
        if not self.exact_bits:
            self._store(dst, self._field(a, pa) * int(const), pd)
            return self._mul_const_cycles(const, pa, pd)
        cycles = 0
        for i in range(pd):
            self.bits[dst + i] = 0
        neg = const < 0
        c = -const if neg else const
        j = 0
        while c:
            if c & 1:
                carry = np.zeros(self.cols, np.uint8)
                for i in range(pd - j):
                    abit = self._bit(a, i, pa)
                    old = self.bits[dst + j + i]
                    r, carry = pe_step(abit, old, carry, self.mask, "add")
                    self.bits[dst + j + i] = r
                    cycles += 1
                cycles += 2  # micro-op setup + carry commit
            c >>= 1
            j += 1
        if neg:  # negate the result: invert + add 1
            carry = np.ones(self.cols, np.uint8)
            zero = np.zeros(self.cols, np.uint8)
            for i in range(pd):
                r, carry = pe_step(1 - self.bits[dst + i], zero, carry, self.mask, "add")
                self.bits[dst + i] = r
                cycles += 1
        return cycles

    def mac(self, dst: int, a: int, b: int, pa: int, pb: int, pd: int) -> int:
        """Fused multiply-accumulate: dst[pd] += a[pa] · b[pb] (wrapping).

        This is the Fig-8a schedule made explicit: each product bit is folded
        into the accumulator the cycle it becomes final, so only the half-width
        live window of the product is ever resident (the allocator's
        ``mul_tmp`` buffer).  Cycles = the mul's shift-add stream + the final
        accumulator ripple — identical to the Mul+Add pair it replaces.
        Defined at field granularity on both paths (the bit interleaving has
        no observable state beyond the accumulator).
        """
        res = self._field(dst, pd) + self._field(a, pa) * self._field(b, pb)
        self._store(dst, res, pd)
        return pb * (pa + 2) + max(pd, pa + pb) + 1

    def mac_const(self, dst: int, a: int, const: int, pa: int, pd: int) -> int:
        """Fused dst[pd] += a[pa] · const, zero-bit skipping on the constant."""
        res = self._field(dst, pd) + self._field(a, pa) * int(const)
        self._store(dst, res, pd)
        z = bin(abs(int(const))).count("1")
        extra = pa + 2 if const < 0 else 0
        return max(z, 1) * (pa + 2) + extra + pd + 1

    def shift_lanes(self, dst: int, src: int, prec: int, amount: int) -> int:
        """Cross-bitline shift: lane c receives lane c-amount (one wordline
        per cycle over the PE-to-PE connections)."""
        for i in range(prec):
            row = self.bits[src + i]
            out = np.zeros_like(row)
            if amount >= 0:
                out[amount:] = row[: self.cols - amount]
            else:
                out[:amount] = row[-amount:]
            self.bits[dst + i] = out
        return prec

    def reduce_intra(self, dst: int, src: int, prec: int, size: int) -> int:
        """Tree-reduce `size` lanes into lane 0 (log2 stages of shift+add).

        Values are sign-extended to the final precision prec+log2(size) up
        front, then every stage is a fixed-width add (the paper's cost model
        instead grows precision per stage — timing.py follows the paper; the
        delta is a few cycles and the results are bit-exact).
        Needs 2·(prec+log2 size) free wordlines at dst.  The source must be
        reduced in place (src == dst) or into a disjoint window: a partial
        overlap would alias the staged partner copies and the result would
        depend on plane iteration order."""
        assert size & (size - 1) == 0
        pf_chk = prec + int(np.log2(size))
        assert src == dst or dst + 2 * pf_chk <= src or dst >= src + prec, (
            f"reduce_intra dst window [{dst}, {dst + 2 * pf_chk}) partially "
            f"overlaps src [{src}, {src + prec})"
        )
        cycles = 0
        stages = int(np.log2(size))
        pf = prec + stages
        if not self.exact_bits:
            if src != dst:
                cycles += prec
            cycles += pf - prec  # in-place sign extension
            v = self._field(src, prec)
            m = (1 << pf) - 1
            sh = None
            for s in range(stages):
                g = 1 << s
                sh = np.zeros_like(v)
                sh[: self.cols - g] = v[g:]
                tot = (v & m) + (sh & m)
                if s == stages - 1:  # final add's ripple carry-out lands in the latch
                    self.carry = ((tot >> pf) & 1).astype(np.uint8)
                v = v + sh
                cycles += 2 * pf  # lane shift + fixed-width add
            self._store(dst, v, pf)
            if sh is not None:
                # the hardware stages each partner through the scratch planes
                # at [dst+pf, dst+2pf); materialize the final stage's staging
                # so the full CRAM state matches the exact_bits path bit for
                # bit (the differential fuzzer compares *all* wordlines)
                self._store(dst + pf, sh, pf)
            return cycles
        if src != dst:
            cycles += self.copy(dst, src, prec)
        for i in range(prec, pf):  # sign-extend in place
            self.bits[dst + i] = self.bits[dst + prec - 1]
            cycles += 1
        scratch = dst + pf
        for s in range(stages):
            # partner lanes sit 2^s apart; shift them down and add pairwise
            cycles += self.shift_lanes(scratch, dst, pf, -(1 << s))
            cycles += self.add(dst, dst, scratch, pf, pf, pf)
        return cycles


class CramBank:
    """Tile-batched CRAM state: one ``(slots, rows, cols)`` bit array holding
    every CRAM the simulator has touched, plus stacked carry/mask latches.

    Each batched method takes a ``slots`` index vector and executes the same
    micro-op across all of those CRAMs at once — the SIMD broadcast the real
    chip's per-tile sequencers perform, expressed as one numpy op per bit
    *plane* over the flattened ``slots × bitlines`` lane space.  Semantics
    (two's-complement wrap, carry latch, mask/carry predication, plane
    iteration order and therefore overlapping-range aliasing) mirror
    :class:`Cram`'s fast path exactly; the per-bit ``exact_bits`` loops in
    :class:`Cram` stay the differential reference.

    Timing is *not* modeled here — the simulator charges cycles analytically
    from ``core.timing`` before dispatching, so batched execution cannot
    perturb any modeled cycle or energy number.
    """

    def __init__(self, rows: int = 256, cols: int = 256):
        self.rows, self.cols = rows, cols
        self.n = 0  # live slots; the arrays below are capacity-padded
        self.bits = np.zeros((0, rows, cols), np.uint8)
        self.carry = np.zeros((0, cols), np.uint8)
        self.mask = np.ones((0, cols), np.uint8)

    def add_slot(self) -> int:
        """Allocate one CRAM's state (zero bits, zero carry, all-ones mask);
        capacity grows geometrically so lazy allocation stays O(n)."""
        if self.n == self.bits.shape[0]:
            cap = max(4, 2 * self.bits.shape[0])

            def grow(arr: np.ndarray, fill: int) -> np.ndarray:
                out = np.full((cap,) + arr.shape[1:], fill, np.uint8)
                out[: self.n] = arr[: self.n]
                return out

            self.bits = grow(self.bits, 0)
            self.carry = grow(self.carry, 0)
            self.mask = grow(self.mask, 1)
        slot = self.n
        self.n += 1
        return slot

    # ---- batched gather/scatter -------------------------------------------

    _BYTE_W = np.array([1, 2, 4, 8, 16, 32, 64, 128], np.uint8)

    def field(self, idx: np.ndarray, addr: int, prec: int, signed: bool = True) -> np.ndarray:
        """(slots, cols) int64 values of the operand at ``addr``.

        Bit planes pack through a uint8 byte stage (8 planes dot [1..128]
        never exceeds 255, so the narrow accumulation is exact) before the
        int64 combine — an 8× cut in wide-integer traffic on the hot path.
        """
        planes = self.bits[idx, addr:addr + prec]  # (slots, prec, cols)
        acc = np.zeros((planes.shape[0], self.cols), np.int64)
        for g in range(0, prec, 8):
            chunk = planes[:, g:g + 8]
            byte = np.einsum("spc,p->sc", chunk, self._BYTE_W[: chunk.shape[1]],
                             dtype=np.uint8, casting="unsafe")
            acc |= byte.astype(np.int64) << g
        if signed:
            sign = (acc >> (prec - 1)) & 1
            acc = acc - (sign << prec)
        return acc

    def store(self, idx: np.ndarray, addr: int, vals: np.ndarray, prec: int) -> None:
        v = np.asarray(vals, np.int64) & ((1 << prec) - 1)
        nb = (prec + 7) // 8
        sh = (np.arange(nb, dtype=np.int64) * 8)[None, :, None]
        by = ((v[:, None, :] >> sh) & 0xFF).astype(np.uint8)  # (slots, nb, cols)
        planes = (by[:, :, None, :] >> np.arange(8, dtype=np.uint8)[None, None, :, None]) & 1
        self.bits[idx, addr:addr + prec] = planes.reshape(v.shape[0], nb * 8, -1)[:, :prec]

    def _bitp(self, idx: np.ndarray, base: int, i: int, prec: int) -> np.ndarray:
        """Batched sign-extended bit access (mirrors ``Cram._bit``)."""
        if i < prec:
            return self.bits[idx, base + i]
        return self.bits[idx, base + prec - 1]

    # ---- batched compute (one instruction = one call over all slots) -------

    def copy(self, idx: np.ndarray, dst: int, src: int, prec: int, pred: str = "none") -> None:
        if pred == "mask":
            keep = self.mask[idx].astype(bool)
            for i in range(prec):
                self.bits[idx, dst + i] = np.where(
                    keep, self.bits[idx, src + i], self.bits[idx, dst + i]
                )
        else:
            for i in range(prec):  # plane order preserves Cram's aliasing
                self.bits[idx, dst + i] = self.bits[idx, src + i]

    def logical(self, idx: np.ndarray, dst: int, a: int, b: Optional[int], prec: int, op: str) -> None:
        bb = a if b is None else b  # single-operand ops ("not") pass src2=None
        carry, mask = self.carry[idx], self.mask[idx]
        for i in range(prec):
            r, carry = pe_step(self.bits[idx, a + i], self.bits[idx, bb + i], carry, mask, op)
            self.bits[idx, dst + i] = r
        self.carry[idx] = carry

    def set_mask(self, idx: np.ndarray, src: int) -> None:
        self.mask[idx] = self.bits[idx, src]

    def add(
        self, idx: np.ndarray, dst: int, a: int, b: int, pa: int, pb: int, pd: int,
        cen: bool = False, cst: bool = True, pred: str = "none", negate_b: bool = False,
    ) -> None:
        if pred == "carry":
            self._add_bits(idx, dst, a, b, pa, pb, pd, cen, cst, pred, negate_b)
            return
        m = (1 << pd) - 1
        ua = self.field(idx, a, pa) & m
        vb = self.field(idx, b, pb)
        ub = (~vb if negate_b else vb) & m
        cin = self.carry[idx].astype(np.int64) if cen else (1 if negate_b else 0)
        tot = ua + ub + cin
        res = tot & m
        if pred == "mask":
            res = np.where(self.mask[idx].astype(bool), res, self.field(idx, dst, pd, signed=False))
        self.store(idx, dst, res, pd)
        if cst:
            self.carry[idx] = ((tot >> pd) & 1).astype(np.uint8)

    def _add_bits(self, idx, dst, a, b, pa, pb, pd, cen, cst, pred, negate_b) -> None:
        # carry-predication consults the running carry bit-by-bit; pe_step is
        # shape-generic, so the literal ripple runs over (slots, cols) planes
        shape = (len(idx), self.cols)
        if cen:
            carry = self.carry[idx]
        else:
            carry = np.full(shape, 1 if negate_b else 0, np.uint8)
        mask = self.mask[idx]
        for i in range(pd):
            abit = self._bitp(idx, a, i, pa)
            bbit = self._bitp(idx, b, i, pb)
            if negate_b:
                bbit = 1 - bbit
            old = self.bits[idx, dst + i]
            r, carry = pe_step(abit, bbit, carry, mask, "add", pred, old)
            self.bits[idx, dst + i] = r
        if cst:
            self.carry[idx] = carry.astype(np.uint8)

    def sub(self, idx: np.ndarray, dst: int, a: int, b: int, pa: int, pb: int, pd: int) -> None:
        self.add(idx, dst, a, b, pa, pb, pd, negate_b=True)

    def cmp_ge(self, idx: np.ndarray, dst: int, a: int, b: int, prec: int) -> None:
        ge = self.field(idx, a, prec) >= self.field(idx, b, prec)
        self.bits[idx, dst] = ge.astype(np.uint8)

    def mul(self, idx: np.ndarray, dst: int, a: int, b: int, pa: int, pb: int, pd: int) -> None:
        self.store(idx, dst, self.field(idx, a, pa) * self.field(idx, b, pb), pd)

    def mul_const(self, idx: np.ndarray, dst: int, a: int, consts: np.ndarray, pa: int, pd: int) -> None:
        """``consts`` is per-slot (RF constants are per-tile state)."""
        self.store(idx, dst, self.field(idx, a, pa) * consts[:, None], pd)

    def mac(self, idx: np.ndarray, dst: int, a: int, b: int, pa: int, pb: int, pd: int) -> None:
        res = self.field(idx, dst, pd) + self.field(idx, a, pa) * self.field(idx, b, pb)
        self.store(idx, dst, res, pd)

    def mac_const(self, idx: np.ndarray, dst: int, a: int, consts: np.ndarray, pa: int, pd: int) -> None:
        res = self.field(idx, dst, pd) + self.field(idx, a, pa) * consts[:, None]
        self.store(idx, dst, res, pd)

    def shift_lanes(self, idx: np.ndarray, dst: int, src: int, prec: int, amount: int) -> None:
        for i in range(prec):  # plane order preserves Cram's aliasing
            row = self.bits[idx, src + i]
            out = np.zeros_like(row)
            if amount >= 0:
                out[:, amount:] = row[:, : self.cols - amount]
            else:
                out[:, :amount] = row[:, -amount:]
            self.bits[idx, dst + i] = out

    def reduce_intra(self, idx: np.ndarray, dst: int, src: int, prec: int, size: int) -> None:
        assert size & (size - 1) == 0
        stages = int(np.log2(size))
        pf = prec + stages
        assert src == dst or dst + 2 * pf <= src or dst >= src + prec, (
            f"reduce_intra dst window [{dst}, {dst + 2 * pf}) partially "
            f"overlaps src [{src}, {src + prec})"
        )
        v = self.field(idx, src, prec)
        m = (1 << pf) - 1
        sh = None
        for s in range(stages):
            g = 1 << s
            sh = np.zeros_like(v)
            sh[:, : self.cols - g] = v[:, g:]
            tot = (v & m) + (sh & m)
            if s == stages - 1:
                self.carry[idx] = ((tot >> pf) & 1).astype(np.uint8)
            v = v + sh
        self.store(idx, dst, v, pf)
        if sh is not None:  # scratch staging, as in Cram.reduce_intra
            self.store(idx, dst + pf, sh, pf)


class CramView(Cram):
    """A :class:`Cram` whose state lives in a :class:`CramBank` slot.

    ``bits``/``carry``/``mask`` are properties that re-index the bank on every
    access (the bank reallocates on growth, so views must never be cached);
    all inherited ``Cram`` methods — transposed I/O, the per-CRAM compute
    fast path, reads by tests and the H-tree reduce — operate on the shared
    batched storage transparently.
    """

    def __init__(self, bank: CramBank, slot: int):
        self._bank = bank
        self._slot = slot
        self.rows, self.cols = bank.rows, bank.cols
        self.exact_bits = False

    @property
    def bits(self) -> np.ndarray:
        return self._bank.bits[self._slot]

    @bits.setter
    def bits(self, v: np.ndarray) -> None:
        self._bank.bits[self._slot] = v

    @property
    def carry(self) -> np.ndarray:
        return self._bank.carry[self._slot]

    @carry.setter
    def carry(self, v: np.ndarray) -> None:
        self._bank.carry[self._slot] = v

    @property
    def mask(self) -> np.ndarray:
        return self._bank.mask[self._slot]

    @mask.setter
    def mask(self, v: np.ndarray) -> None:
        self._bank.mask[self._slot] = v
