"""The ``"pimsab"`` kernel backend of the port, eager half: registry calls →
tensor DSL → §V compiler → ISA → functional bit-serial simulator.

The port's counterpart of the eager half of the JAX package's
``kernels/pimsab_backend.py``.  Inside ``api.use_backend("pimsab")`` every
registry kernel call lowers onto the paper's architecture model instead of
running on the operands' device:

1. the operand shapes/precisions become a :class:`tensor_dsl.Workload`
   (gemm → ``mac``, reduction → constant-operand ``mac`` through the RF
   ``mul_const`` path, elementwise → ``map_*``/``relu``, the RG-LRU
   recurrence → ``scan_mac``);
2. ``compiler.distribute`` picks the parallelism distribution and
   ``compiler.codegen`` emits the per-tile SIMD ISA stream (tagged DRAM
   instructions carry the data-plane binding);
3. the stream runs twice: **functionally** on a small
   :class:`Simulator(functional=True)` machine for bit-exact results, and in
   **timing** mode at full chip scale for the Fig-11-style modeled
   cycle/energy report.

The simulator and compiler are the port's own numpy copy
(:mod:`repro_torch.core`), and the lowerings below are numpy too: torch
appears only at the edges.  Operands come in as ``detach().cpu().numpy()``
(bfloat16 widened to float32 first, which is exact) and each result goes out
as a fresh contiguous tensor on the first operand's device — float32 for
float kernels (fixed-point quantized: ``frac`` fraction bits, allclose to the
oracle), the input's dtype or int32 for integer ones (bit-exact).  A call
launches no card kernel and is counted by no launch counter.  The modeled
numbers attach to the call through :func:`last_sim_report` (thread-local).

Operands must hold values: ``api.dispatch`` refuses meta tensors, trace
placeholders and calls made while the current CUDA stream is captured with
``api.PimsabTracerError``.  The Program lowering (one fused
``WorkloadGraph`` per traced program, CRAM-resident edges, ``ResidentState``)
is not ported yet (ROADMAP Queue 1 item 5c).
"""
from __future__ import annotations

import collections
import contextlib
import math
import threading
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import isa
from repro_torch.core.compiler.allocation import (
    SOFTMAX_F,
    SOFTMAX_K,
    adaptive_precision,
    softmax_out_prec,
)
from repro_torch.core.compiler import autotune
from repro_torch.core.compiler.codegen import compile_workload
from repro_torch.core.compiler.tensor_dsl import Loop, Ref, Workload
from repro_torch.core.compiler.verify import VerifyReport, verify_compiled
from repro_torch.core.machine import PIMSAB, PimsabConfig
from repro_torch.core.simulator import Simulator
from repro_torch.kernels import ref
from repro_torch.kernels.api import PimsabTracerError, register_pimsab_impl, static_value

# the lowerings attach to already-registered kernels: importing the kernel
# modules here makes a direct `import repro_torch.kernels.pimsab_backend`
# work the same as the lazy registry bootstrap
import repro_torch.kernels.attention  # noqa: E402,F401
import repro_torch.kernels.bitslice_matmul  # noqa: E402,F401
import repro_torch.kernels.conv  # noqa: E402,F401
import repro_torch.kernels.ewise  # noqa: E402,F401
import repro_torch.kernels.htree_reduce  # noqa: E402,F401
import repro_torch.kernels.rglru_scan  # noqa: E402,F401

__all__ = [
    "SimReport",
    "last_sim_report",
    "sim_report_log",
    "clear_sim_report_log",
    "last_verify_report",
    "functional_config",
    "profile_timelines",
    "FUNCTIONAL_CFG",
    "FUNCTIONAL_CFG_LARGE",
    "TIMING_CFG",
    "execute_workload",
    "run_functional_stream",
    "timing_report",
]

# Functional machine: a small mesh so bit-exact bit-serial execution stays
# tractable; the timing/energy report compiles the same workload at full
# chip scale (PIMSAB, 120 tiles) where only the analytic model runs.
FUNCTIONAL_CFG = PimsabConfig(mesh_cols=2, mesh_rows=2, crams_per_tile=1)
# Paper-scale functional machine (16 tiles × 4 CRAMs = 16384 lanes) for the
# slow-tier bit-exact runs (RESNET18, 256×1024×1024 matmul): the tile-batched
# simulator makes per-instruction cost independent of the tile count, so a
# bigger mesh *reduces* wall time by cutting serial steps.
FUNCTIONAL_CFG_LARGE = PimsabConfig(mesh_cols=4, mesh_rows=4, crams_per_tile=4)
TIMING_CFG = PIMSAB

_tls = threading.local()


def last_sim_report() -> Optional["SimReport"]:
    """The report of the most recent pimsab kernel call on this thread."""
    return getattr(_tls, "report", None)


def last_verify_report() -> Tuple[VerifyReport, ...]:
    """Static-verifier reports of the most recent pimsab compile on this
    thread (one per verified stream: a single entry for an eager kernel, the
    functional + timing pair for a compiled traced program).  Empty when the
    last call ran with ``verify=False``."""
    return tuple(getattr(_tls, "verify_reports", ()))


SIM_REPORT_LOG_SIZE = 64


def _stash_report(rep: "SimReport") -> None:
    _tls.report = rep
    log = getattr(_tls, "report_log", None)
    if log is None:
        log = _tls.report_log = collections.deque(maxlen=SIM_REPORT_LOG_SIZE)
    log.append(rep)


def sim_report_log() -> Tuple["SimReport", ...]:
    """Bounded ring of the most recent pimsab reports on this thread, oldest
    first (capacity :data:`SIM_REPORT_LOG_SIZE`).  Multi-step drivers — the
    serve scheduler aggregating per-decode-step tokens/sec — read the whole
    window instead of racing :func:`last_sim_report` call by call."""
    return tuple(getattr(_tls, "report_log", ()))


def clear_sim_report_log() -> None:
    """Empty this thread's report ring (test isolation between serve runs)."""
    getattr(_tls, "report_log", collections.deque()).clear()


@contextlib.contextmanager
def functional_config(cfg: PimsabConfig) -> Iterator[PimsabConfig]:
    """Scope the functional-execution machine (tests use this to exercise
    e.g. the cross-CRAM H-tree reduce path with ``crams_per_tile=2``)."""
    prev = getattr(_tls, "fcfg", None)
    _tls.fcfg = cfg
    try:
        yield cfg
    finally:
        _tls.fcfg = prev


def _functional_cfg() -> PimsabConfig:
    return getattr(_tls, "fcfg", None) or FUNCTIONAL_CFG


@contextlib.contextmanager
def profile_timelines(enable: bool = True) -> Iterator[None]:
    """Scope in which pimsab timing runs record per-instruction timelines:
    every :class:`SimReport` produced inside carries a ``timeline`` tuple of
    scheduled intervals ({op, phase, start, end, stages}) — the raw material
    of a per-phase profile."""
    prev = getattr(_tls, "profile", False)
    _tls.profile = enable
    try:
        yield
    finally:
        _tls.profile = prev


def _profiling() -> bool:
    return bool(getattr(_tls, "profile", False))


@dataclass(frozen=True)
class SimReport:
    """Modeled execution of one kernel call — or one multi-kernel Program —
    on the PIMSAB architecture.  The program-mode fields (``kernels``,
    ``per_kernel``, ``dram_traffic``, ``elided_dram_bits``,
    ``resident_edges``) stay empty for eager single-kernel calls."""

    kernel: str
    workload: str
    total_cycles: float                 # timeline makespan, full-scale machine
    cycles: Dict[str, float]            # charged cycles per category
    cycle_breakdown: Dict[str, float]   # charged fraction (busy share)
    energy_pj: Dict[str, float]
    energy_j: float
    modeled_seconds: float
    instrs: int                         # full-scale program length
    instr_mix: Dict[str, int]           # instruction class -> count
    mapping: Dict[str, Any]             # distribute() decision (to_json)
    functional_instrs: int              # instructions executed bit-exactly
    # --- phase-timeline views ---------------------------------------------
    serialized_cycles: float = 0.0      # charged sum = no-overlap clock
    overlapped_cycles: float = 0.0      # cycles hidden by the schedule
    critical_path: Dict[str, float] = field(default_factory=dict)
    utilization: Dict[str, float] = field(default_factory=dict)  # busy/makespan
    timeline: Tuple[Dict[str, Any], ...] = ()  # per-instr intervals (--profile)
    # --- aggregated program-mode fields -----------------------------------
    kernels: Tuple[str, ...] = ()               # kernel per node, in order
    per_kernel: Tuple[Dict[str, Any], ...] = () # per-node cycle segments
    dram_traffic: Dict[str, Any] = field(default_factory=dict)  # node -> stream bits
    elided_dram_bits: float = 0.0
    resident_edges: Tuple[str, ...] = ()        # "src->dst" elided boundaries
    # --- autotuner provenance (empty when the compile was not tuned) ------
    autotune: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        out = {
            "kernel": self.kernel,
            "workload": self.workload,
            "total_cycles": self.total_cycles,
            "cycles": dict(self.cycles),
            "cycle_breakdown": {k: round(v, 4) for k, v in self.cycle_breakdown.items()},
            "energy_pj": {k: round(v, 1) for k, v in self.energy_pj.items()},
            "energy_j": self.energy_j,
            "modeled_seconds": self.modeled_seconds,
            "instrs": self.instrs,
            "instr_mix": dict(self.instr_mix),
            "mapping": self.mapping,
            "functional_instrs": self.functional_instrs,
            "serialized_cycles": self.serialized_cycles,
            "overlapped_cycles": self.overlapped_cycles,
            "critical_path": {k: round(v, 1) for k, v in self.critical_path.items()},
            "utilization": {k: round(v, 4) for k, v in self.utilization.items()},
        }
        if self.timeline:
            out["timeline"] = [dict(t) for t in self.timeline]
        if self.kernels:
            out["kernels"] = list(self.kernels)
            out["per_kernel"] = [dict(p) for p in self.per_kernel]
            out["dram_traffic"] = {k: dict(v) for k, v in self.dram_traffic.items()}
            out["elided_dram_bits"] = self.elided_dram_bits
            out["resident_edges"] = list(self.resident_edges)
        if self.autotune:
            out["autotune"] = dict(self.autotune)
        return out


# ---------------------------------------------------------------------------
# the torch edges: operands in as numpy, results out as tensors
# ---------------------------------------------------------------------------

# the dtypes a lowering returns (its input's integer dtype, int32 or
# float32), numpy → torch
_TORCH_DTYPE = {
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
}


def _as_numpy(v: Any) -> np.ndarray:
    """An operand's values as a read-only numpy array in logical order: a
    tensor is detached and copied to the host (bfloat16 widened to float32,
    exactly), anything else goes through ``np.asarray``."""
    if isinstance(v, torch.Tensor):
        t = v.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        arr = t.cpu().numpy()
    else:
        arr = np.asarray(v)
    arr = arr.view()
    arr.flags.writeable = False  # the lowerings read their operands only
    return arr


def _to_torch(arr: np.ndarray, like: Any) -> torch.Tensor:
    """A lowering's numpy result as a fresh contiguous tensor on the device
    of ``like`` (the call's first operand; the CPU for a non-tensor)."""
    dtype = _TORCH_DTYPE.get(arr.dtype)
    if dtype is None:
        raise TypeError(f"the pimsab backend has no torch dtype for a {arr.dtype} result")
    out = torch.as_tensor(np.array(arr, order="C", copy=True), dtype=dtype)
    return out.to(like.device) if isinstance(like, torch.Tensor) else out


def _cpu_tensor(arr: np.ndarray) -> torch.Tensor:
    """A writable CPU tensor copy of ``arr``, for the port's ``ref`` glue."""
    return torch.from_numpy(np.array(arr, copy=True))


def _require_concrete(name: str, *arrays) -> List[np.ndarray]:
    out = []
    for a in arrays:
        v = static_value(a)
        if v is None:
            raise PimsabTracerError(
                f"the pimsab backend executes {name!r} on the functional "
                "simulator and needs operands that hold values — not a meta "
                "tensor or a trace placeholder"
            )
        out.append(_as_numpy(v))
    return out


# ---------------------------------------------------------------------------
# the data plane: tagged DRAM instructions ↔ operand arrays
# ---------------------------------------------------------------------------


class _DataPlane:
    """Marries the tagged instruction stream with real operand slabs.

    Layout contract (mirrors distribute/codegen):
    output element ``o`` of tile ``t``, serial step ``s``, lane group ``g``
    has flat index ``t·per_tile + s·outs_per_step + g`` (row-major over the
    data loops); group ``g`` occupies lanes ``[g·rs, (g+1)·rs)``, lane ``r``
    of a group owns reduction indices ``[r·k_lane, (r+1)·k_lane)`` chunked by
    ``k_chunk``.  Global lane ``L`` of a tile lives in CRAM ``L // cram_cols``
    at bitline ``L % cram_cols``.
    """

    def __init__(
        self,
        w: Workload,
        mapping,
        cfg: PimsabConfig,
        arrays: Dict[str, np.ndarray],
        h0: Optional[np.ndarray] = None,
    ):
        self.w, self.m, self.cfg = w, mapping, cfg
        self.arrays = arrays
        self.h0 = h0
        self.d = w.total_out_elems()
        self.k = w.reduce_extent()
        self.rs = mapping.reduce_split
        self.k_lane = self.k // self.rs
        self.cols = cfg.cram_cols
        self.outs_per_step = max(1, mapping.lanes_used // self.rs)
        self.per_tile = -(-self.d // mapping.tiles_used)
        if w.op in ("mac", "scan_mac"):
            self.n_chunks = max(1, self.k_lane // mapping.k_chunk)
        else:
            self.n_chunks = 1
        self.counts: Dict[Tuple[str, int], int] = {}
        # ops whose output is (data, reduce)-shaped: one field per reduce
        # index per lane, stored field-by-field (scan_mac's trajectory, a
        # softmax row, a kv_append cache row)
        if w.op in ("scan_mac", "softmax", "kv_append"):
            self.out = np.zeros((self.d, self.k), np.int64)
        else:
            self.out = np.zeros(self.d, np.int64)

    # -- index algebra -----------------------------------------------------

    def _lane_groups(self):
        L = np.arange(self.m.lanes_used)
        return L // self.rs, L % self.rs

    def _data_vals(self, out_idx: np.ndarray) -> Dict[str, np.ndarray]:
        vals: Dict[str, np.ndarray] = {}
        rem = out_idx.copy()
        for l in reversed(self.w.data_loops):
            vals[l.name] = rem % l.extent
            rem //= l.extent
        return vals

    def _reduce_vals(self, k_idx: np.ndarray, vals: Dict[str, np.ndarray]) -> None:
        rem = k_idx.copy()
        for l in reversed(self.w.reduce_loops):
            vals[l.name] = rem % l.extent
            rem //= l.extent

    def _gather(self, ref: Ref, vals: Dict[str, np.ndarray], valid: np.ndarray) -> np.ndarray:
        arr = self.arrays[ref.name]
        if not ref.index:
            return np.where(valid, int(arr), 0)
        idx = tuple(np.where(valid, vals[n], 0) for n in ref.index)
        return np.where(valid, arr[idx], 0)

    def _out_positions(self, tile: int, step: int, gs: np.ndarray):
        local = step * self.outs_per_step + gs
        out_idx = tile * self.per_tile + local
        valid = (local < self.per_tile) & (out_idx < self.d)
        return out_idx, valid

    # -- loads ---------------------------------------------------------------

    def load(self, ins: isa.DramLoad, tile: int) -> Tuple[np.ndarray, int]:
        """Next slab for this (tag, tile): (fields, lanes) values + precision."""
        key = (ins.tag, tile)
        cnt = self.counts.get(key, 0)
        self.counts[key] = cnt + 1
        g, r = self._lane_groups()
        if ins.tag == "h0":
            out_idx, valid = self._out_positions(tile, cnt, g)
            vals = self._data_vals(np.where(valid, out_idx, 0))
            row = np.where(valid, self.h0[tuple(vals[l.name] for l in self.w.data_loops)], 0)
            return row[None, :], ins.prec
        step, kc = divmod(cnt, self.n_chunks)
        out_idx, valid = self._out_positions(tile, step, g)
        vals = self._data_vals(np.where(valid, out_idx, 0))
        ref = self.w.ins[{"in_a": 0, "in_b": 1, "in_c": 2}[ins.tag]]
        # all fields of the slab gather in one shot: reduce-loop index arrays
        # are (fields, lanes), data-loop ones stay (lanes,) and broadcast
        j = np.arange(ins.fields)[:, None]
        if self.w.reduce_loops:
            k_idx = r[None, :] * self.k_lane + kc * self.m.k_chunk + j
            kvalid = valid[None, :] & (k_idx < self.k)
            self._reduce_vals(np.where(kvalid, k_idx, 0), vals)
        else:
            kvalid = np.broadcast_to(valid, (ins.fields, len(valid)))
        return self._gather(ref, vals, kvalid), ins.prec

    # -- stores --------------------------------------------------------------

    def collect(self, ins: isa.DramStore, tile: int, read_lanes: Callable[[int, int], np.ndarray]) -> None:
        key = ("out", tile)
        cnt = self.counts.get(key, 0)
        self.counts[key] = cnt + 1
        if self.w.op in ("scan_mac", "softmax", "kv_append"):
            step, t_idx = divmod(cnt, self.k)
        else:
            step, t_idx = cnt, None
        if self.w.op == "mac" and self.rs > 1:
            gs = np.arange(self.outs_per_step)
            lanes = gs * self.rs if self.rs <= self.cols else np.zeros(1, np.int64)
        else:
            gs = np.arange(self.outs_per_step)
            lanes = gs
        out_idx, valid = self._out_positions(tile, step, gs)
        vals = read_lanes(ins.cram_addr, ins.prec)[lanes]
        if t_idx is None:
            self.out[out_idx[valid]] = vals[valid]
        else:
            self.out[out_idx[valid], t_idx] = vals[valid]


def _write_lanes(sim: Simulator, tile: int, addr: int, vals: np.ndarray, prec: int) -> None:
    """Write a slab (``(fields, lanes)`` or ``(lanes,)``) into a tile, field
    ``j`` at ``addr + j*prec``, chunking lanes across the tile's CRAMs.  One
    ``write_block`` per CRAM — the whole slab crosses the transpose unit in
    a single strided scatter."""
    v = np.atleast_2d(np.asarray(vals))
    cols = sim.cfg.cram_cols
    for c in range((v.shape[1] + cols - 1) // cols):
        sim.cram(tile, c).write_block(addr, v[:, c * cols:(c + 1) * cols], prec)


def _read_lanes(sim: Simulator, tile: int, addr: int, prec: int, lanes: int) -> np.ndarray:
    cols = sim.cfg.cram_cols
    parts = []
    for c in range((lanes + cols - 1) // cols):
        n = min(cols, lanes - c * cols)
        parts.append(sim.cram(tile, c).read(addr, prec, n=n))
    return np.concatenate(parts)


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------


def run_functional_stream(
    program: Tuple[isa.Instr, ...],
    w: Workload,
    m: Any,
    cfg_fn: PimsabConfig,
    arrays: Dict[str, np.ndarray],
    *,
    h0: Optional[np.ndarray] = None,
    serialize: bool = False,
) -> Tuple[np.ndarray, Simulator]:
    """Execute an ISA ``program`` bit-exactly on the functional machine.

    This is the inner loop of :func:`execute_workload`, factored out so the
    verifier tests can run *mutated* streams (scheduling tags stripped or
    permuted) of the same workload and assert bit-exactness: functional
    execution is strict program order, so any stream carrying the same
    data-plane-tagged DRAM instructions replays against the same
    :class:`_DataPlane`.  Returns ``(outputs, simulator)``.
    """
    sim = Simulator(cfg_fn, functional=True, serialize=serialize)
    plane = _DataPlane(w, m, cfg_fn, arrays, h0=h0)
    for ins in program:
        if isinstance(ins, isa.DramLoad) and ins.tag:
            for t in (ins.tiles or range(m.tiles_used)):
                slab, prec = plane.load(ins, t)
                _write_lanes(sim, t, ins.cram_addr, slab, prec)
        sim.step(ins)
        if isinstance(ins, isa.DramStore) and ins.tag == "out":
            for t in (ins.tiles or range(m.tiles_used)):
                plane.collect(
                    ins, t,
                    lambda addr, prec, _t=t: _read_lanes(sim, _t, addr, prec, m.lanes_used),
                )
    return plane.out, sim


def execute_workload(
    w: Workload,
    arrays: Dict[str, np.ndarray],
    *,
    h0: Optional[np.ndarray] = None,
    kernel: str = "",
    cfg_fn: Optional[PimsabConfig] = None,
    cfg_timing: Optional[PimsabConfig] = None,
    serialize: bool = False,
    verify: bool = True,
) -> Tuple[np.ndarray, SimReport]:
    """Compile ``w``, execute it bit-exactly, and model it at chip scale.

    Returns the raw integer outputs (flat over the data loops; ``(d, k)`` for
    ``scan_mac``) and the :class:`SimReport` (also stashed for
    :func:`last_sim_report`).  ``serialize=True`` runs the functional machine
    in the fully-serialized compatibility clock — results must be identical
    (scheduling never changes execution order), which the invariant tests
    assert.  ``verify=True`` (the default) runs the compile-time static
    verifier (``compiler.verify``) over the functional stream before
    execution and raises :class:`~repro_torch.core.compiler.verify.VerifierError`
    on any liveness/race/overflow error; the report is retrievable via
    :func:`last_verify_report`.
    """
    cfg_fn = cfg_fn or _functional_cfg()
    cp = compile_workload(w, cfg_fn)
    m = cp.mapping
    if verify:
        vrep = verify_compiled(cp, cfg_fn)
        _tls.verify_reports = (vrep,)
        vrep.raise_on_error()
    else:
        _tls.verify_reports = ()
    out, sim = run_functional_stream(
        cp.program, w, m, cfg_fn, arrays, h0=h0, serialize=serialize
    )
    rep = timing_report(
        w, kernel=kernel, cfg=cfg_timing or TIMING_CFG, functional_instrs=sim.res.instrs
    )
    _stash_report(rep)
    return out, rep


def timing_report(
    w: Workload,
    *,
    kernel: str = "",
    cfg: PimsabConfig = TIMING_CFG,
    functional_instrs: int = 0,
    verify: bool = False,
    tune: Any = None,
) -> SimReport:
    """Compile ``w`` for the full-scale machine and run the analytic model.

    ``verify=True`` additionally runs the static verifier over the
    full-scale stream (raising on errors) — opt-in here because eager
    dispatch already verifies the functional stream of the same workload.

    ``tune`` (``True`` or a :class:`~repro_torch.core.compiler.autotune.TuneConfig`)
    runs the mapping autotuner over the *timing* stream and reports the
    winner; ``None`` inherits an enclosing :func:`autotune.tuning` scope
    (how eager kernel dispatch opts in).  Functional execution is never
    tuned, so results are unchanged — only the modeled schedule is.
    """
    tc = autotune.resolve(tune) if tune is not None else autotune.active()
    mapping = None
    tuned_prov: Dict[str, Any] = {}
    if tc is not None:
        tw = autotune.tune_workload(w, cfg, tc)
        mapping = tw.mapping
        tuned_prov = tw.provenance
    cp = compile_workload(w, cfg, mapping=mapping)
    if verify:
        verify_compiled(cp, cfg).raise_on_error()
    res = Simulator(cfg, record_timeline=_profiling()).run(cp.program)
    return SimReport(
        kernel=kernel,
        workload=w.name,
        total_cycles=res.total_cycles,
        cycles=dict(res.cycles),
        cycle_breakdown=res.breakdown(),
        energy_pj=dict(res.energy.pj),
        energy_j=res.energy.total_j,
        modeled_seconds=res.seconds(cfg),
        instrs=res.instrs,
        instr_mix=dict(Counter(type(i).__name__ for i in cp.program)),
        mapping=cp.mapping.to_json(),
        functional_instrs=functional_instrs,
        serialized_cycles=res.serialized_cycles,
        overlapped_cycles=res.overlapped_cycles,
        critical_path=dict(res.critical_path),
        utilization=res.utilization(),
        timeline=tuple(res.timeline) if res.timeline else (),
        autotune=tuned_prov,
    )


# ---------------------------------------------------------------------------
# fixed-point quantization (float kernels)
# ---------------------------------------------------------------------------


def _quantize(x: np.ndarray, frac: int, bits: int) -> np.ndarray:
    """Round x · 2^frac into a ``bits``-bit signed integer (saturating)."""
    lim = 2 ** (bits - 1) - 1
    return np.clip(
        np.round(np.asarray(x, np.float64) * (1 << frac)), -lim, lim
    ).astype(np.int64)


def _fixed_frac(envelope: float, bits: int) -> int:
    """Fraction bits left after covering ``envelope`` with ``bits``-2 int bits."""
    int_bits = max(0, math.ceil(math.log2(envelope + 1e-30))) if envelope > 0 else 0
    return max(0, bits - 2 - int_bits)


def _to_fixed(x: np.ndarray, bits: int) -> Tuple[np.ndarray, int]:
    """Symmetric fixed-point: returns (q, frac) with x ≈ q · 2^-frac and q a
    ``bits``-bit signed integer."""
    frac = _fixed_frac(float(np.max(np.abs(x))) if x.size else 0.0, bits)
    return _quantize(x, frac, bits), frac


def _to_fixed_shared(arrays: List[np.ndarray], bits: int) -> Tuple[List[np.ndarray], int]:
    """One format for several operands (bit-serial adds need aligned binal
    points): the envelope is the max over all of them."""
    env = max((float(np.abs(a).max()) if a.size else 0.0) for a in arrays)
    frac = _fixed_frac(env, bits)
    return [_quantize(a, frac, bits) for a in arrays], frac


def _int_bits(x: np.ndarray) -> int:
    """Signed bits needed to hold every value of an integer array."""
    m = int(np.max(np.abs(x))) if x.size else 0
    return max(2, m.bit_length() + 1)


def _from_slices_np(slices: np.ndarray, slice_bits: int) -> np.ndarray:
    acc = np.zeros(slices.shape[1:], np.int64)
    for s in range(slices.shape[0]):
        acc += slices[s].astype(np.int64) << (slice_bits * s)
    return acc


def _dead_slice_ints(
    xs: np.ndarray, ws: np.ndarray, skip, slice_bits: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Pairwise skip semantics shared by the eager and program matmul
    lowerings (they must agree for bit-exactness): a slice dead against
    *every* partner never reaches the integer reconstruction (those slices
    are all-zero in every real flow — the skip list is derived from cached
    zero-slice metadata)."""
    sx, sw = xs.shape[0], ws.shape[0]
    dead = set(skip)
    xs = xs.astype(np.int64).copy()
    ws = ws.astype(np.int64).copy()
    for s in range(sx):
        if all((s, t) in dead for t in range(sw)):
            xs[s] = 0
    for t in range(sw):
        if all((s, t) in dead for s in range(sx)):
            ws[t] = 0
    return _from_slices_np(xs, slice_bits), _from_slices_np(ws, slice_bits)


# ---------------------------------------------------------------------------
# kernel lowerings
# ---------------------------------------------------------------------------


@register_pimsab_impl("bitslice_matmul")
def _bitslice_matmul_pimsab(
    x_slices, w_slices, *, slice_bits: int = 8, skip: Tuple[Tuple[int, int], ...] = (), **_
) -> torch.Tensor:
    """(Sx, M, K) × (Sw, K, N) → (M, N) int32 — a ``mac`` gemm at the
    operands' composite precision.  Bit-exact vs the oracle: the CRAM
    accumulator wraps mod 2^32 exactly like the oracle's int32."""
    xs, ws = _require_concrete("bitslice_matmul", x_slices, w_slices)
    sx, mm, kk = xs.shape
    sw, kk2, nn = ws.shape
    assert kk == kk2, (kk, kk2)
    x_int, w_int = _dead_slice_ints(xs, ws, skip, slice_bits)
    pa = sx * slice_bits + 1  # balanced signed digits slightly exceed 2^(s·b-1)
    pb = sw * slice_bits + 1
    w = Workload(
        name=f"bitslice_matmul_{mm}x{nn}x{kk}",
        loops=(Loop("x", mm, "data"), Loop("y", nn, "data"), Loop("k", kk, "reduce")),
        out=Ref("c", ("x", "y"), prec=32),
        ins=(Ref("a", ("x", "k"), prec=pa), Ref("b", ("k", "y"), prec=pb)),
        op="mac",
        acc_prec=32,
    )
    out, _ = execute_workload(w, {"a": x_int, "b": w_int}, kernel="bitslice_matmul")
    return _to_torch(out.reshape(mm, nn).astype(np.int32), x_slices)


@register_pimsab_impl("htree_reduce")
def _htree_reduce_pimsab(x, **_) -> torch.Tensor:
    """(N, D) → (D,): constant-operand ``mac`` (·1 through the RF mul_const
    path) reduced over N — the H-tree/intra-CRAM fold carries the sum."""
    (xv,) = _require_concrete("htree_reduce", x)
    n, dd = xv.shape
    is_int = np.issubdtype(xv.dtype, np.integer)
    if is_int:
        xq, frac = xv.astype(np.int64), 0
        pa = _int_bits(xv)
    else:
        pa = 16
        xq, frac = _to_fixed(xv, pa)
    w = Workload(
        name=f"htree_reduce_{n}x{dd}",
        loops=(Loop("d", dd, "data"), Loop("n", n, "reduce")),
        out=Ref("y", ("d",), prec=32),
        ins=(
            Ref("x", ("n", "d"), prec=pa),
            Ref("one", (), prec=2, is_const=True, const_value=1),
        ),
        op="mac",
        acc_prec=32,
    )
    out, _ = execute_workload(w, {"x": xq}, kernel="htree_reduce")
    if is_int:
        return _to_torch(out.astype(xv.dtype), x)
    return _to_torch((out.astype(np.float64) / (1 << frac)).astype(np.float32), x)


@register_pimsab_impl("rglru_scan")
def _rglru_scan_pimsab(a, b, h0, **_) -> torch.Tensor:
    """(B, T, W) gates/inputs → (B, T, W) states: ``scan_mac`` fixed point.

    The gate quantizes to fa fraction bits; the state/input stream shares one
    format sized from the trajectory envelope (a calibration pass — profile,
    then pick the adaptive precision, §IV-C).  Per-step truncation error is
    2^-frac, contracted by the gate, so the result is allclose (not
    bit-exact) to the float oracle.
    """
    av, bv, hv = _require_concrete("rglru_scan", a, b, h0)
    bsz, tt, ww = av.shape
    pa, fa = 16, 14  # gates in (0, 1): 2 integer bits are plenty
    aq = _quantize(av, fa, pa)
    # calibration: float envelope of the recurrence sizes the state format
    env = np.abs(hv).max() if hv.size else 0.0
    h = hv.astype(np.float64)
    for t in range(tt):
        h = av[:, t] * h + bv[:, t]
        env = max(env, float(np.abs(h).max()), float(np.abs(bv[:, t]).max()))
    int_bits = max(0, math.ceil(math.log2(env + 1e-30))) if env > 0 else 0
    fb = 12
    ph = min(fb + int_bits + 3, 24)
    quant = lambda v: _quantize(v, fb, ph)
    w = Workload(
        name=f"rglru_scan_{bsz}x{tt}x{ww}",
        loops=(Loop("b", bsz, "data"), Loop("w", ww, "data"), Loop("t", tt, "reduce")),
        out=Ref("h", ("b", "w"), prec=ph),
        ins=(
            Ref("a", ("b", "w", "t"), prec=pa, frac=fa),
            Ref("bt", ("b", "w", "t"), prec=ph),
        ),
        op="scan_mac",
        acc_prec=ph,
    )
    out, _ = execute_workload(
        w,
        {"a": aq.transpose(0, 2, 1), "bt": quant(bv).transpose(0, 2, 1)},
        h0=quant(hv),
        kernel="rglru_scan",
    )
    hs = out.reshape(bsz, ww, tt).transpose(0, 2, 1)
    return _to_torch((hs.astype(np.float64) / (1 << fb)).astype(np.float32), a)


def _map_workload(name: str, op: str, n: int, refs: Tuple[Ref, ...], out_prec: int, acc: int) -> Workload:
    return Workload(
        name=name,
        loops=(Loop("i", n, "data"),),
        out=Ref("y", ("i",), prec=out_prec),
        ins=refs,
        op=op,
        acc_prec=acc,
    )


@register_pimsab_impl("ewise_add")
def _ewise_add_pimsab(x, y, **_) -> torch.Tensor:
    xv, yv = _require_concrete("ewise_add", x, y)
    assert xv.shape == yv.shape, (xv.shape, yv.shape)
    n = xv.size
    is_int = np.issubdtype(xv.dtype, np.integer) and np.issubdtype(yv.dtype, np.integer)
    if is_int:
        xq, yq, frac = xv.reshape(n).astype(np.int64), yv.reshape(n).astype(np.int64), 0
        pa = max(_int_bits(xv), _int_bits(yv))
    else:
        pa = 16
        (xq, yq), frac = _to_fixed_shared([xv.reshape(n), yv.reshape(n)], pa)
    w = _map_workload(
        f"ewise_add_{n}", "map_add", n,
        (Ref("xa", ("i",), prec=pa), Ref("xb", ("i",), prec=pa)),
        out_prec=pa + 1, acc=pa + 1,
    )
    out, _ = execute_workload(w, {"xa": xq, "xb": yq}, kernel="ewise_add")
    if is_int:
        return _to_torch(out.reshape(xv.shape).astype(xv.dtype), x)
    return _to_torch((out.reshape(xv.shape).astype(np.float64) / (1 << frac)).astype(np.float32), x)


@register_pimsab_impl("relu")
def _relu_pimsab(x, **_) -> torch.Tensor:
    (xv,) = _require_concrete("relu", x)
    n = xv.size
    is_int = np.issubdtype(xv.dtype, np.integer)
    if is_int:
        xq, frac, pa = xv.reshape(n).astype(np.int64), 0, _int_bits(xv)
    else:
        pa = 16
        xq, frac = _to_fixed(xv.reshape(n), pa)
    w = _map_workload(
        f"relu_{n}", "relu", n,
        (Ref("xa", ("i",), prec=pa), Ref("z", ("i",), prec=pa, is_const=True, const_value=0)),
        out_prec=pa, acc=pa,
    )
    out, _ = execute_workload(w, {"xa": xq}, kernel="relu")
    if is_int:
        return _to_torch(out.reshape(xv.shape).astype(xv.dtype), x)
    return _to_torch((out.reshape(xv.shape).astype(np.float64) / (1 << frac)).astype(np.float32), x)


# ---------------------------------------------------------------------------
# conv / pool / raw-integer-gemm lowerings (the DL-network layer set)
# ---------------------------------------------------------------------------


def _clamp_bits(bits: int) -> int:
    """Clamp an integer-precision bound to [2, 32]: 32 is where the CRAM
    accumulator's wraparound equals int32, so a saturated bound still
    matches the oracle bit-for-bit.  The single clamp rule shared by the
    eager (value-calibrated) and program-mode (signature-stable) paths."""
    return max(2, min(int(bits), 32))


def _hint_bits(hint, values: Optional[np.ndarray]) -> int:
    """Integer operand precision for eager lowering: the caller's static
    hint when given, else calibrated from the values."""
    return _clamp_bits(int(hint) if hint is not None else _int_bits(values))


def _require_int(name: str, *arrays: np.ndarray) -> None:
    for a in arrays:
        if not np.issubdtype(a.dtype, np.integer):
            raise NotImplementedError(
                f"the pimsab {name!r} lowering runs the raw-integer path "
                "(int32 accumulate, bit-exact); quantize float operands first"
            )


def _pool_shift(count: int, name: str) -> int:
    """log2 of the window count — the wordline offset the average-pool store
    reads the sum accumulator at (a free arithmetic right shift)."""
    s = int(math.log2(count))
    if (1 << s) != count:
        raise NotImplementedError(
            f"{name}: pimsab average pooling divides by reading the sum "
            f"accumulator at a wordline offset, which needs a power-of-two "
            f"window count (got {count})"
        )
    return s


def _gemm_workload(name: str, mm: int, nn: int, kk: int, pa: int, pb: int) -> Workload:
    return Workload(
        name=name,
        loops=(Loop("x", mm, "data"), Loop("y", nn, "data"), Loop("k", kk, "reduce")),
        out=Ref("c", ("x", "y"), prec=32),
        ins=(Ref("a", ("x", "k"), prec=pa), Ref("b", ("k", "y"), prec=pb)),
        op="mac",
        acc_prec=32,
    )


def _conv_workload(name: str, n: int, oc: int, spatial: int, kk: int,
                   pa: int, pb: int) -> Workload:
    """Conv-as-im2col gemm with data loops ordered (n, oc, spatial): the
    accumulator's lane order is then exactly the NCHW-flat order of the
    logical output, so a downstream elementwise consumer can read the value
    CRAM-resident without any permutation (the residency layout contract)."""
    return Workload(
        name=name,
        loops=(Loop("n", n, "data"), Loop("y", oc, "data"),
               Loop("s", spatial, "data"), Loop("k", kk, "reduce")),
        out=Ref("c", ("n", "y", "s"), prec=32),
        ins=(Ref("a", ("n", "s", "k"), prec=pa), Ref("b", ("k", "y"), prec=pb)),
        op="mac",
        acc_prec=32,
    )


def _maxpool_workload(name: str, d: int, kk: int, pa: int) -> Workload:
    return Workload(
        name=name,
        loops=(Loop("i", d, "data"), Loop("w", kk, "reduce")),
        out=Ref("y", ("i",), prec=pa),
        ins=(Ref("a", ("i", "w"), prec=pa),),
        op="maxpool",
        acc_prec=pa,
    )


def _avgpool_workload(name: str, d: int, kk: int, pa: int, shift: int) -> Workload:
    sum_prec = min(adaptive_precision(pa, 2, kk, "mac"), 32)
    return Workload(
        name=name,
        loops=(Loop("i", d, "data"), Loop("k", kk, "reduce")),
        out=Ref("y", ("i",), prec=sum_prec - shift),
        ins=(
            Ref("a", ("i", "k"), prec=pa),
            Ref("one", (), prec=2, is_const=True, const_value=1),
        ),
        op="mac",
        acc_prec=32,
        div_shift=shift,
    )


@register_pimsab_impl("conv2d")
def _conv2d_pimsab(
    x, w, *, stride: int = 1, padding: int = 0,
    x_bits: Optional[int] = None, w_bits: Optional[int] = None, **_
) -> torch.Tensor:
    """(N, C, H, W) × (OC, C, KH, KW) → (N, OC, OH, OW): im2col on the data
    plane, then the same ``mac`` gemm pipeline the matmuls use (§V-A "conv
    via im2col") — bit-exact int32 accumulation."""
    xv, wv = _require_concrete("conv2d", x, w)
    _require_int("conv2d", xv, wv)
    n, c, h, hw = xv.shape
    oc, c2, kh, kw = wv.shape
    assert c == c2, (c, c2)
    oh, ow = ref.conv2d_out_hw(h, hw, kh, kw, stride, padding)
    kk = c * kh * kw
    pa = _hint_bits(x_bits, xv)
    pb = _hint_bits(w_bits, wv)
    wl = _conv_workload(f"conv2d_{n}x{oc}x{oh}x{ow}_k{kk}", n, oc, oh * ow, kk, pa, pb)
    patches = ref.im2col(_cpu_tensor(xv), kh, kw, stride, padding).numpy().astype(np.int64)
    wmat = wv.reshape(oc, kk).T.astype(np.int64)
    out, _ = execute_workload(
        wl, {"a": patches.reshape(n, oh * ow, kk), "b": wmat}, kernel="conv2d"
    )
    return _to_torch(out.reshape(n, oc, oh, ow).astype(np.int32), x)


@register_pimsab_impl("int_matmul")
def _int_matmul_pimsab(
    x, w, *, x_bits: Optional[int] = None, w_bits: Optional[int] = None, **_
) -> torch.Tensor:
    """(M, K) × (K, N) raw-integer gemm — ``bitslice_matmul`` without the
    slice stacks, for operands that arrive as another kernel's output."""
    xv, wv = _require_concrete("int_matmul", x, w)
    _require_int("int_matmul", xv, wv)
    mm, kk = xv.shape
    kk2, nn = wv.shape
    assert kk == kk2, (kk, kk2)
    pa = _hint_bits(x_bits, xv)
    pb = _hint_bits(w_bits, wv)
    wl = _gemm_workload(f"int_matmul_{mm}x{nn}x{kk}", mm, nn, kk, pa, pb)
    out, _ = execute_workload(
        wl, {"a": xv.astype(np.int64), "b": wv.astype(np.int64)}, kernel="int_matmul"
    )
    return _to_torch(out.reshape(mm, nn).astype(np.int32), x)


@register_pimsab_impl("maxpool2d")
def _maxpool2d_pimsab(x, *, window: int = 2, stride: Optional[int] = None, **_) -> torch.Tensor:
    """Window max via CmpGE + masked copy over the resident window (integer
    bit-exact; float fixed-point — max is order-preserving, so quantization
    commutes with the fold)."""
    (xv,) = _require_concrete("maxpool2d", x)
    s = stride or window
    n, c, h, w = xv.shape
    oh, ow = ref.conv2d_out_hw(h, w, window, window, s, 0)
    patches = ref.pool_patches(_cpu_tensor(xv), window, s).numpy()
    is_int = np.issubdtype(xv.dtype, np.integer)
    if is_int:
        xq, frac, pa = patches.astype(np.int64), 0, min(_int_bits(patches), 32)
    else:
        pa = 16
        xq, frac = _to_fixed(patches, pa)
    wl = _maxpool_workload(f"maxpool2d_{n}x{c}x{oh}x{ow}_w{window}", n * c * oh * ow,
                           window * window, pa)
    out, _ = execute_workload(wl, {"a": xq}, kernel="maxpool2d")
    out = out.reshape(n, c, oh, ow)
    if is_int:
        return _to_torch(out.astype(xv.dtype), x)
    return _to_torch((out.astype(np.float64) / (1 << frac)).astype(np.float32), x)


def _avgpool_execute(kernel: str, wl: Workload, patches: np.ndarray):
    out, _ = execute_workload(wl, {"a": patches.astype(np.int64)}, kernel=kernel)
    return out


@register_pimsab_impl("avgpool2d")
def _avgpool2d_pimsab(x, *, window: int = 2, **_) -> torch.Tensor:
    """Window average: constant-operand MAC (·1) sums the window, and the
    store reads the accumulator ``log2(window²)`` wordlines up — the §V-C
    shift-read divide.  Integer floor-divide semantics, bit-exact."""
    (xv,) = _require_concrete("avgpool2d", x)
    _require_int("avgpool2d", xv)
    n, c, h, w = xv.shape
    oh, ow = ref.conv2d_out_hw(h, w, window, window, window, 0)
    shift = _pool_shift(window * window, "avgpool2d")
    pa = min(_int_bits(xv), 32)
    wl = _avgpool_workload(f"avgpool2d_{n}x{c}x{oh}x{ow}_w{window}", n * c * oh * ow,
                           window * window, pa, shift)
    patches = ref.pool_patches(_cpu_tensor(xv), window, window).numpy()
    out = _avgpool_execute("avgpool2d", wl, patches)
    # the oracle sums in int32 before the floor divide, so the result is int32
    return _to_torch(out.reshape(n, c, oh, ow).astype(np.int32), x)


@register_pimsab_impl("global_avgpool")
def _global_avgpool_pimsab(x, **_) -> torch.Tensor:
    """(N, C, H, W) → (N, C): the spatial sum through the MAC reduction, the
    divide through the shift-read store (H·W must be a power of two)."""
    (xv,) = _require_concrete("global_avgpool", x)
    _require_int("global_avgpool", xv)
    n, c, h, w = xv.shape
    shift = _pool_shift(h * w, "global_avgpool")
    pa = min(_int_bits(xv), 32)
    wl = _avgpool_workload(f"global_avgpool_{n}x{c}_k{h * w}", n * c, h * w, pa, shift)
    out = _avgpool_execute("global_avgpool", wl, xv.reshape(n * c, h * w))
    return _to_torch(out.reshape(n, c).astype(np.int32), x)


# ---------------------------------------------------------------------------
# transformer-serving lowerings: attention, fixed-point softmax, KV cache
# ---------------------------------------------------------------------------


def _softmax_workload(name: str, r: int, t: int, pin: int, in_frac: int) -> Workload:
    if in_frac < SOFTMAX_F - SOFTMAX_K:
        raise NotImplementedError(
            f"{name}: the fixed-point softmax range reduction reads the "
            f"shifted accumulator window, which needs at least "
            f"{SOFTMAX_F - SOFTMAX_K} input fraction bits (got {in_frac})"
        )
    return Workload(
        name=name,
        loops=(Loop("r", r, "data"), Loop("t", t, "reduce")),
        out=Ref("p", ("r", "t"), prec=softmax_out_prec(), frac=SOFTMAX_F),
        ins=(Ref("x", ("r", "t"), prec=pin, frac=in_frac),),
        op="softmax",
        acc_prec=softmax_out_prec(),
    )


def _kv_append_workload(name: str, t: int, d: int, prec: int) -> Workload:
    return Workload(
        name=name,
        loops=(Loop("t", t, "data"), Loop("j", d, "reduce")),
        out=Ref("out", ("t", "j"), prec=prec),
        ins=(
            Ref("cache", ("t", "j"), prec=prec),
            Ref("new", ("j",), prec=prec),
            Ref("onehot", ("t",), prec=2),
        ),
        op="kv_append",
        acc_prec=prec,
    )


def _pv_workload(name: str, mm: int, nn: int, kk: int, pa: int, pb: int,
                 shift: int) -> Workload:
    sum_prec = min(adaptive_precision(pa, pb, kk, "mac"), 32)
    return Workload(
        name=name,
        loops=(Loop("x", mm, "data"), Loop("y", nn, "data"), Loop("k", kk, "reduce")),
        out=Ref("c", ("x", "y"), prec=max(2, sum_prec - shift)),
        ins=(Ref("a", ("x", "k"), prec=pa), Ref("b", ("k", "y"), prec=pb)),
        op="mac",
        acc_prec=32,
        div_shift=shift,
    )


def _check_onehot(name: str, ov: np.ndarray) -> None:
    if not np.isin(ov, (0, 1)).all() or int(ov.sum()) > 1:
        raise ValueError(
            f"{name}: the row selector must be one-hot (or all-zero for a "
            "no-op append); it latches the PE mask directly"
        )


@register_pimsab_impl("attention_qk")
def _attention_qk_pimsab(
    q, k, *, q_bits: Optional[int] = None, k_bits: Optional[int] = None, **_
) -> torch.Tensor:
    """(M, D) × (T, D) → (M, T) raw-integer attention scores q·Kᵀ: the mac
    gemm with the key cache as the shared operand — lane y holds key row y's
    head-dim fields, which is exactly the layout ``kv_append`` leaves behind,
    so in program mode the K cache chains CRAM-resident into this reduction."""
    qv, kv = _require_concrete("attention_qk", q, k)
    _require_int("attention_qk", qv, kv)
    mm, dd = qv.shape
    tt, dd2 = kv.shape
    assert dd == dd2, (dd, dd2)
    pa = _hint_bits(q_bits, qv)
    pb = _hint_bits(k_bits, kv)
    wl = _gemm_workload(f"attention_qk_{mm}x{tt}x{dd}", mm, tt, dd, pa, pb)
    out, _ = execute_workload(
        wl, {"a": qv.astype(np.int64), "b": kv.T.astype(np.int64)},
        kernel="attention_qk",
    )
    return _to_torch(out.reshape(mm, tt).astype(np.int32), q)


@register_pimsab_impl("softmax_fixedpoint")
def _softmax_fixedpoint_pimsab(
    x, *, in_frac: int, in_bits: Optional[int] = None, **_
) -> torch.Tensor:
    """Row softmax in pure fixed point (§V-C bit-serial-aware): exact row max
    via the CmpGE/mask tournament, exp via a squared-polynomial in the
    ``2^-SOFTMAX_F`` domain with every ``>>`` a free shifted-window read, the
    normalizer via restoring division against the RF constant path.  Inputs
    are integers with ``in_frac`` fraction bits; outputs are integer
    probabilities with ``SOFTMAX_F`` fraction bits (rows sum to ≈ ``2**F``)."""
    (xv,) = _require_concrete("softmax_fixedpoint", x)
    _require_int("softmax_fixedpoint", xv)
    r, t = xv.shape
    in_frac = int(in_frac)
    pin = max(_hint_bits(in_bits, xv), in_frac + SOFTMAX_K)
    wl = _softmax_workload(f"softmax_fixedpoint_{r}x{t}", r, t, pin, in_frac)
    out, _ = execute_workload(
        wl, {"x": xv.astype(np.int64)}, kernel="softmax_fixedpoint"
    )
    return _to_torch(out.reshape(r, t).astype(np.int32), x)


@register_pimsab_impl("attention_pv")
def _attention_pv_pimsab(
    p, v, *, shift: int = SOFTMAX_F,
    p_bits: Optional[int] = None, v_bits: Optional[int] = None, **_
) -> torch.Tensor:
    """(M, T) × (T, Dv) → (M, Dv) probability-weighted value mix: a mac gemm
    whose store reads the accumulator ``shift`` wordlines up — the free
    arithmetic ``>>`` that renormalizes the ``SOFTMAX_F``-frac probabilities
    back to the value scale (floor semantics, bit-exact)."""
    pv_, vv = _require_concrete("attention_pv", p, v)
    _require_int("attention_pv", pv_, vv)
    mm, tt = pv_.shape
    tt2, nn = vv.shape
    assert tt == tt2, (tt, tt2)
    pa = _hint_bits(p_bits, pv_)
    pb = _hint_bits(v_bits, vv)
    wl = _pv_workload(f"attention_pv_{mm}x{nn}x{tt}", mm, nn, tt, pa, pb, int(shift))
    out, _ = execute_workload(
        wl, {"a": pv_.astype(np.int64), "b": vv.astype(np.int64)},
        kernel="attention_pv",
    )
    return _to_torch(out.reshape(mm, nn).astype(np.int32), p)


@register_pimsab_impl("decode_gemv")
def _decode_gemv_pimsab(
    w, x, *, w_bits: Optional[int] = None, x_bits: Optional[int] = None, **_
) -> torch.Tensor:
    """(M, K) × (K,) → (M,) single-token decode projection: the activation
    vector is the *shared* operand, so instead of broadcasting it through the
    NoC it rides the RF constant path — one ``RfLoad`` + ``MacConst`` per
    reduction index, every lane multiplying its resident weight row (the
    paper's constant-operand rows, §V-B)."""
    wv, xv = _require_concrete("decode_gemv", w, x)
    _require_int("decode_gemv", wv, xv)
    mm, kk = wv.shape
    (kk2,) = xv.shape
    assert kk == kk2, (kk, kk2)
    pa = _hint_bits(w_bits, wv)
    pb = _hint_bits(x_bits, xv)
    wl = Workload(
        name=f"decode_gemv_{mm}x{kk}",
        loops=(Loop("x", mm, "data"), Loop("k", kk, "reduce")),
        out=Ref("y", ("x",), prec=32),
        ins=(
            Ref("a", ("x", "k"), prec=pa),
            Ref("b", ("k",), prec=pb, is_const=True,
                const_value=tuple(int(v) for v in xv)),
        ),
        op="mac",
        acc_prec=32,
    )
    out, _ = execute_workload(wl, {"a": wv.astype(np.int64)}, kernel="decode_gemv")
    return _to_torch(out.reshape(mm).astype(np.int32), w)


@register_pimsab_impl("kv_append")
def _kv_append_pimsab(cache, new, onehot, **_) -> torch.Tensor:
    """(T, D) cache with the row selected by the one-hot ``onehot`` replaced
    by ``new`` — the relu/maxpool predication idiom turned into a scatter:
    the selector latches the PE mask and the new row's fields overwrite only
    the masked lane.  As a ``ResidentState`` updater in program mode, in_a
    and out pin to the same reserved wordlines and the append never touches
    DRAM."""
    cv, nv, ov = _require_concrete("kv_append", cache, new, onehot)
    _require_int("kv_append", cv, nv, ov)
    _check_onehot("kv_append", ov)
    t, d = cv.shape
    assert nv.shape == (d,), (nv.shape, d)
    assert ov.shape == (t,), (ov.shape, t)
    prec = max(_int_bits(cv), _int_bits(nv))
    wl = _kv_append_workload(f"kv_append_{t}x{d}", t, d, prec)
    out, _ = execute_workload(
        wl,
        {"cache": cv.astype(np.int64), "new": nv.astype(np.int64),
         "onehot": ov.astype(np.int64)},
        kernel="kv_append",
    )
    return _to_torch(out.reshape(t, d).astype(cv.dtype), cache)

