"""The ``"pimsab"`` kernel backend of the port: registry calls → tensor DSL →
§V compiler → ISA → functional bit-serial simulator.

The port's counterpart of the JAX package's ``kernels/pimsab_backend.py``.
Inside ``api.use_backend("pimsab")`` every registry kernel call lowers onto
the paper's architecture model instead of running on the operands' device:

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
``api.PimsabTracerError``.

**Program lowering and DRAM elision.**  A traced ``api.Program`` compiled for
the pimsab backend (``api.compile(prog, "pimsab")``, or any compile inside
the scope) lowers through :func:`compile_traced_program` into one
``tensor_dsl.WorkloadGraph``, compiled as a single fused ISA stream for the
functional machine (execution) and the full-scale machine (the report).  On
a producer→consumer edge whose boundary value lives in the raw integer
domain, the compiler keeps the value CRAM-resident and elides the producer's
``DramStore`` and the consumer's ``DramLoad``; fixed-point (float)
boundaries keep the DRAM round trip, so program execution stays bit-exact
against the same kernels run eagerly.  Program lowering sizes integer
precision from the *dtype* (a cached Executor replays fresh values), eager
lowering from the values: results are identical, modeled cycles differ
slightly.  :func:`execute_traced_program` runs the fused stream on the host
every call (a pimsab Executor never captures a CUDA graph and launches no
card kernel) and binds ``ResidentState`` handles (``states=``) to reserved
wordlines; :func:`timing_program_report` models network shapes beyond
functional simulation.
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
from repro_torch.core.compiler.codegen import CompiledGraph, compile_graph, compile_workload
from repro_torch.core.compiler.tensor_dsl import GraphEdge, Loop, Ref, Workload, WorkloadGraph
from repro_torch.core.compiler.verify import VerifyReport, verify_compiled, verify_graph
from repro_torch.core.machine import PIMSAB, PimsabConfig
from repro_torch.core.simulator import Simulator
from repro_torch.kernels import ref
from repro_torch.kernels.api import PimsabTracerError, register_pimsab_impl, static_value
from repro_torch.kernels.program import _dtype_name

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
    "ValueMeta",
    "OpLowering",
    "StateBinding",
    "CompiledTracedProgram",
    "compile_traced_program",
    "compile_timing_program",
    "execute_traced_program",
    "timing_program_report",
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

# ===========================================================================
# Program lowering: traced kernel chains → one fused WorkloadGraph
# ===========================================================================


@dataclass(frozen=True)
class ValueMeta:
    """How a node's raw CRAM value relates to its logical value at a graph
    boundary: ``prec`` CRAM bits, ``frac`` fixed-point fraction bits (0 = raw
    integer domain), and the logical numpy dtype/shape."""

    shape: Tuple[int, ...]
    prec: int
    frac: int
    kind: str   # "int" | "fixed"
    dtype: str  # logical numpy dtype of the finalized value


@dataclass(frozen=True)
class InDesc:
    """One program-node input as its lowering sees it: the logical aval, plus
    the producer's ValueMeta when the input is a *chainable* node output."""

    aval: Tuple[Tuple[int, ...], str]
    meta: Optional[ValueMeta] = None

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.aval[0])

    @property
    def np_dtype(self) -> np.dtype:
        # numpy has no bfloat16: _as_numpy widens it to float32 (exactly)
        return np.dtype("float32" if self.aval[1] == "bfloat16" else self.aval[1])

    @property
    def is_int(self) -> bool:
        if self.meta is not None:
            return self.meta.kind == "int"
        return np.issubdtype(self.np_dtype, np.integer)


@dataclass
class OpLowering:
    """One program node lowered to a Workload + its value-plane glue.

    ``chained`` maps a canonical buffer ("in_a"/"in_b") to the input position
    the lowering constructed *in chain precision* — the mapping layer may
    still drop the edge to a DRAM round-trip, in which case the same buffer
    simply loads the producer's finalized value at that precision.
    ``bind(vals)`` quantizes concrete input values into data-plane arrays
    (positions the executor knows are CRAM-resident arrive as ``None``);
    ``finalize(raw, state)`` turns the collected plane output back into the
    logical value.
    """

    workload: Workload
    out_meta: ValueMeta
    chainable: bool
    chained: Dict[str, int]
    bind: Callable[[List[Optional[np.ndarray]]], Tuple[Dict[str, Optional[np.ndarray]], Optional[np.ndarray], Any]]
    finalize: Callable[[np.ndarray, Any], np.ndarray]


_PROGRAM_LOWERINGS: Dict[str, Callable[..., OpLowering]] = {}


def _program_lowering(name: str):
    def deco(fn):
        _PROGRAM_LOWERINGS[name] = fn
        return fn
    return deco


def _dtype_bits(dt: np.dtype) -> int:
    """Signature-stable integer precision: the dtype's width (program mode
    cannot calibrate from values — a cached executor replays fresh ones)."""
    return np.dtype(dt).itemsize * 8


def _int_in_prec(d: InDesc) -> int:
    return d.meta.prec if d.meta is not None else _dtype_bits(d.np_dtype)


@_program_lowering("bitslice_matmul")
def _pl_bitslice_matmul(node: str, ins: List[InDesc], kwargs: Dict[str, Any]) -> OpLowering:
    slice_bits = int(kwargs.get("slice_bits", 8))
    skip = tuple(kwargs.get("skip", ()))
    (sx, mm, kk) = ins[0].shape
    (sw, kk2, nn) = ins[1].shape
    assert kk == kk2, (kk, kk2)
    pa = sx * slice_bits + 1
    pb = sw * slice_bits + 1
    out_prec = min(adaptive_precision(pa, pb, kk, "mac"), 32)
    w = Workload(
        name=node,
        loops=(Loop("x", mm, "data"), Loop("y", nn, "data"), Loop("k", kk, "reduce")),
        out=Ref("c", ("x", "y"), prec=32),
        ins=(Ref("a", ("x", "k"), prec=pa), Ref("b", ("k", "y"), prec=pb)),
        op="mac",
        acc_prec=32,
    )

    def bind(vals):
        x_int, w_int = _dead_slice_ints(
            np.asarray(vals[0]), np.asarray(vals[1]), skip, slice_bits
        )
        return {"a": x_int, "b": w_int}, None, None

    def finalize(raw, _state):
        return raw.reshape(mm, nn).astype(np.int32)

    return OpLowering(
        workload=w,
        out_meta=ValueMeta((mm, nn), out_prec, 0, "int", "int32"),
        chainable=True,
        chained={},
        bind=bind,
        finalize=finalize,
    )


@_program_lowering("ewise_add")
def _pl_ewise_add(node: str, ins: List[InDesc], kwargs: Dict[str, Any]) -> OpLowering:
    assert ins[0].shape == ins[1].shape, (ins[0].shape, ins[1].shape)
    shape = ins[0].shape
    n = int(np.prod(shape)) if shape else 1
    is_int = ins[0].is_int and ins[1].is_int
    if is_int:
        pa, pb = _int_in_prec(ins[0]), _int_in_prec(ins[1])
        # Cap chain precision at int32: with 32-bit operands the CRAM add at
        # prec 32 drops the carry-out, i.e. wraps mod 2^32 — exactly the
        # oracle's int32 semantics.  An uncapped 33-bit sum holds the *true*
        # value, which a CRAM-resident consumer would then read (the DRAM
        # round-trip wraps in finalize, a resident edge does not), making
        # graph mode diverge from eager on overflow.
        out_prec = min(max(pa, pb) + 1, 32)
        chained = {
            buf: pos for buf, pos in (("in_a", 0), ("in_b", 1))
            if ins[pos].meta is not None
        }
        out_dtype = ins[0].aval[1]

        def bind(vals):
            arrays = {}
            for key, v in zip(("a", "b"), vals):
                arrays[key] = None if v is None else np.asarray(v).reshape(n).astype(np.int64)
            return arrays, None, None

        def finalize(raw, _state):
            return raw.reshape(shape).astype(np.dtype(out_dtype))

        meta = ValueMeta(shape, out_prec, 0, "int", out_dtype)
        chainable = True
    else:
        pa = pb = 16
        out_prec = pa + 1
        chained = {}

        def bind(vals):
            (xq, yq), frac = _to_fixed_shared(
                [np.asarray(v).reshape(n) for v in vals], pa
            )
            return {"a": xq, "b": yq}, None, frac

        def finalize(raw, frac):
            return (raw.reshape(shape).astype(np.float64) / (1 << frac)).astype(np.float32)

        meta = ValueMeta(shape, out_prec, -1, "fixed", "float32")
        chainable = False
    w = Workload(
        name=node,
        loops=(Loop("i", n, "data"),),
        out=Ref("y", ("i",), prec=out_prec),
        ins=(Ref("a", ("i",), prec=pa), Ref("b", ("i",), prec=pb)),
        op="map_add",
        acc_prec=out_prec,
    )
    return OpLowering(w, meta, chainable, chained, bind, finalize)


@_program_lowering("relu")
def _pl_relu(node: str, ins: List[InDesc], kwargs: Dict[str, Any]) -> OpLowering:
    shape = ins[0].shape
    n = int(np.prod(shape)) if shape else 1
    is_int = ins[0].is_int
    if is_int:
        pa = _int_in_prec(ins[0])
        chained = {"in_a": 0} if ins[0].meta is not None else {}
        out_dtype = ins[0].aval[1]

        def bind(vals):
            v = vals[0]
            return (
                {"a": None if v is None else np.asarray(v).reshape(n).astype(np.int64)},
                None,
                None,
            )

        def finalize(raw, _state):
            return raw.reshape(shape).astype(np.dtype(out_dtype))

        meta = ValueMeta(shape, pa, 0, "int", out_dtype)
        chainable = True
    else:
        pa = 16
        chained = {}

        def bind(vals):
            xq, frac = _to_fixed(np.asarray(vals[0]).reshape(n), pa)
            return {"a": xq}, None, frac

        def finalize(raw, frac):
            return (raw.reshape(shape).astype(np.float64) / (1 << frac)).astype(np.float32)

        meta = ValueMeta(shape, pa, -1, "fixed", "float32")
        chainable = False
    w = Workload(
        name=node,
        loops=(Loop("i", n, "data"),),
        out=Ref("y", ("i",), prec=pa),
        ins=(
            Ref("a", ("i",), prec=pa),
            Ref("z", (), prec=pa, is_const=True, const_value=0),
        ),
        op="relu",
        acc_prec=pa,
    )
    return OpLowering(w, meta, chainable, chained, bind, finalize)


@_program_lowering("htree_reduce")
def _pl_htree_reduce(node: str, ins: List[InDesc], kwargs: Dict[str, Any]) -> OpLowering:
    nred, dd = ins[0].shape
    is_int = ins[0].is_int
    if is_int:
        pa = _int_in_prec(ins[0])
        out_prec = min(adaptive_precision(pa, 2, nred, "mac"), 32)
        out_dtype = ins[0].aval[1]

        def bind(vals):
            return {"a": np.asarray(vals[0]).astype(np.int64)}, None, None

        def finalize(raw, _state):
            return raw.reshape(dd).astype(np.dtype(out_dtype))

        meta = ValueMeta((dd,), out_prec, 0, "int", out_dtype)
        chainable = True
    else:
        pa = 16
        out_prec = min(adaptive_precision(pa, 2, nred, "mac"), 32)

        def bind(vals):
            xq, frac = _to_fixed(np.asarray(vals[0]), pa)
            return {"a": xq}, None, frac

        def finalize(raw, frac):
            return (raw.reshape(dd).astype(np.float64) / (1 << frac)).astype(np.float32)

        meta = ValueMeta((dd,), out_prec, -1, "fixed", "float32")
        chainable = False
    w = Workload(
        name=node,
        loops=(Loop("d", dd, "data"), Loop("n", nred, "reduce")),
        out=Ref("y", ("d",), prec=32),
        ins=(
            Ref("a", ("n", "d"), prec=pa),
            Ref("one", (), prec=2, is_const=True, const_value=1),
        ),
        op="mac",
        acc_prec=32,
    )
    return OpLowering(w, meta, chainable, {}, bind, finalize)


@_program_lowering("rglru_scan")
def _pl_rglru_scan(node: str, ins: List[InDesc], kwargs: Dict[str, Any]) -> OpLowering:
    bsz, tt, ww = ins[0].shape
    # signature-stable conservative fixed-point format (no value calibration:
    # a cached executor must replay with fresh trajectories)
    pa, fa = 16, 14
    fb, ph = 12, 24

    def bind(vals):
        av, bv, hv = (np.asarray(v) for v in vals)
        quant = lambda v: _quantize(v, fb, ph)
        arrays = {
            "a": _quantize(av, fa, pa).transpose(0, 2, 1),
            "b": quant(bv).transpose(0, 2, 1),
        }
        return arrays, quant(hv), None

    def finalize(raw, _state):
        hs = raw.reshape(bsz, ww, tt).transpose(0, 2, 1)
        return (hs.astype(np.float64) / (1 << fb)).astype(np.float32)

    w = Workload(
        name=node,
        loops=(Loop("b", bsz, "data"), Loop("w", ww, "data"), Loop("t", tt, "reduce")),
        out=Ref("h", ("b", "w"), prec=ph),
        ins=(
            Ref("a", ("b", "w", "t"), prec=pa, frac=fa),
            Ref("b", ("b", "w", "t"), prec=ph),
        ),
        op="scan_mac",
        acc_prec=ph,
    )
    meta = ValueMeta((bsz, tt, ww), ph, -1, "fixed", "float32")
    return OpLowering(w, meta, False, {}, bind, finalize)


def _pl_int_in_bits(d: InDesc, hint) -> int:
    """Program-mode integer precision: the static hint, else the producer's
    ValueMeta precision, else the dtype width — same [2, 32] clamp as the
    eager path (:func:`_clamp_bits`)."""
    return _clamp_bits(int(hint) if hint is not None else _int_in_prec(d))


def _pl_gemm(node: str, ins: List[InDesc], kwargs: Dict[str, Any], kk: int,
             bind, finalize, out_shape: Tuple[int, ...],
             workload_fn) -> OpLowering:
    """Shared raw-integer gemm program lowering (conv2d / int_matmul).

    ``workload_fn(pa, pb)`` builds the Workload from the operand precisions
    derived HERE — one derivation feeds both the workload's input Refs and
    the advertised ``out_meta``, so the precision the residency check
    (`_edge_prec_ok`) sees can never diverge from what the compiler plans.
    """
    if not (ins[0].is_int and ins[1].is_int):
        raise NotImplementedError(
            f"{node}: the pimsab program lowering runs the raw-integer gemm "
            "path; quantize float operands first"
        )
    pa = _pl_int_in_bits(ins[0], kwargs.get("x_bits"))
    pb = _pl_int_in_bits(ins[1], kwargs.get("w_bits"))
    out_prec = min(adaptive_precision(pa, pb, kk, "mac"), 32)
    return OpLowering(
        workload=workload_fn(pa, pb),
        out_meta=ValueMeta(out_shape, out_prec, 0, "int", "int32"),
        chainable=True,
        chained={},
        bind=bind,
        finalize=finalize,
    )


@_program_lowering("conv2d")
def _pl_conv2d(node: str, ins: List[InDesc], kwargs: Dict[str, Any]) -> OpLowering:
    stride = int(kwargs.get("stride", 1))
    padding = int(kwargs.get("padding", 0))
    n, c, h, hw = ins[0].shape
    oc, c2, kh, kw = ins[1].shape
    assert c == c2, (c, c2)
    oh, ow = ref.conv2d_out_hw(h, hw, kh, kw, stride, padding)
    kk = c * kh * kw

    def bind(vals):
        patches = ref.im2col(_cpu_tensor(vals[0]), kh, kw, stride, padding).numpy().astype(np.int64)
        wmat = np.asarray(vals[1]).reshape(oc, kk).T.astype(np.int64)
        return {"a": patches.reshape(n, oh * ow, kk), "b": wmat}, None, None

    def finalize(raw, _state):
        return raw.reshape(n, oc, oh, ow).astype(np.int32)

    return _pl_gemm(
        node, ins, kwargs, kk, bind, finalize, (n, oc, oh, ow),
        lambda pa, pb: _conv_workload(node, n, oc, oh * ow, kk, pa, pb),
    )


@_program_lowering("int_matmul")
def _pl_int_matmul(node: str, ins: List[InDesc], kwargs: Dict[str, Any]) -> OpLowering:
    mm, kk = ins[0].shape
    kk2, nn = ins[1].shape
    assert kk == kk2, (kk, kk2)

    def bind(vals):
        return (
            {"a": np.asarray(vals[0]).astype(np.int64),
             "b": np.asarray(vals[1]).astype(np.int64)},
            None, None,
        )

    def finalize(raw, _state):
        return raw.reshape(mm, nn).astype(np.int32)

    return _pl_gemm(
        node, ins, kwargs, kk, bind, finalize, (mm, nn),
        lambda pa, pb: _gemm_workload(node, mm, nn, kk, pa, pb),
    )


@_program_lowering("maxpool2d")
def _pl_maxpool2d(node: str, ins: List[InDesc], kwargs: Dict[str, Any]) -> OpLowering:
    window = int(kwargs.get("window", 2))
    stride = int(kwargs.get("stride") or window)
    n, c, h, w = ins[0].shape
    oh, ow = ref.conv2d_out_hw(h, w, window, window, stride, 0)
    d = n * c * oh * ow
    kk = window * window
    is_int = ins[0].is_int
    if is_int:
        pa = _pl_int_in_bits(ins[0], None)
        out_dtype = ins[0].aval[1]

        def bind(vals):
            patches = ref.pool_patches(_cpu_tensor(vals[0]), window, stride).numpy()
            return {"a": patches.astype(np.int64)}, None, None

        def finalize(raw, _state):
            return raw.reshape(n, c, oh, ow).astype(np.dtype(out_dtype))

        meta = ValueMeta((n, c, oh, ow), pa, 0, "int", out_dtype)
        chainable = True
    else:
        pa = 16

        def bind(vals):
            patches = ref.pool_patches(_cpu_tensor(vals[0]), window, stride).numpy()
            xq, frac = _to_fixed(patches, pa)
            return {"a": xq}, None, frac

        def finalize(raw, frac):
            return (raw.reshape(n, c, oh, ow).astype(np.float64) / (1 << frac)).astype(np.float32)

        meta = ValueMeta((n, c, oh, ow), pa, -1, "fixed", "float32")
        chainable = False
    wl = _maxpool_workload(node, d, kk, pa)
    return OpLowering(wl, meta, chainable, {}, bind, finalize)


def _pl_avgpool_common(node: str, d: int, kk: int, in_desc: InDesc,
                       out_shape: Tuple[int, ...], patches_of) -> OpLowering:
    if not in_desc.is_int:
        raise NotImplementedError(
            f"{node}: pimsab average pooling runs the integer floor-divide "
            "path; quantize float operands first"
        )
    shift = _pool_shift(kk, node)
    pa = _pl_int_in_bits(in_desc, None)
    wl = _avgpool_workload(node, d, kk, pa, shift)
    stored_prec = wl.out.prec  # sum precision minus the shift

    def bind(vals):
        return {"a": patches_of(np.asarray(vals[0])).astype(np.int64)}, None, None

    def finalize(raw, _state):
        return raw.reshape(out_shape).astype(np.int32)

    # chainable with the *stored* precision: a downstream consumer sizes its
    # input from the value that actually crosses the boundary.  Residency is
    # still impossible (the accumulator holds the un-shifted sum, and the
    # precision check `_edge_prec_ok` sees stored_prec != out_prec), so the
    # DRAM round-trip is always kept — by construction, not by luck.
    meta = ValueMeta(out_shape, stored_prec, 0, "int", "int32")
    return OpLowering(wl, meta, True, {}, bind, finalize)


@_program_lowering("avgpool2d")
def _pl_avgpool2d(node: str, ins: List[InDesc], kwargs: Dict[str, Any]) -> OpLowering:
    window = int(kwargs.get("window", 2))
    n, c, h, w = ins[0].shape
    oh, ow = ref.conv2d_out_hw(h, w, window, window, window, 0)
    return _pl_avgpool_common(
        node, n * c * oh * ow, window * window, ins[0], (n, c, oh, ow),
        lambda xv: ref.pool_patches(_cpu_tensor(xv), window, window).numpy(),
    )


@_program_lowering("global_avgpool")
def _pl_global_avgpool(node: str, ins: List[InDesc], kwargs: Dict[str, Any]) -> OpLowering:
    n, c, h, w = ins[0].shape
    return _pl_avgpool_common(
        node, n * c, h * w, ins[0], (n, c),
        lambda xv: xv.reshape(n * c, h * w),
    )


def _pl_require_int(node: str, *descs: InDesc) -> None:
    if not all(d.is_int for d in descs):
        raise NotImplementedError(
            f"{node}: the pimsab program lowering runs the raw-integer path; "
            "quantize float operands first"
        )


@_program_lowering("attention_qk")
def _pl_attention_qk(node: str, ins: List[InDesc], kwargs: Dict[str, Any]) -> OpLowering:
    _pl_require_int(node, ins[0], ins[1])
    mm, dd = ins[0].shape
    tt, dd2 = ins[1].shape
    assert dd == dd2, (dd, dd2)
    pa = _pl_int_in_bits(ins[0], kwargs.get("q_bits"))
    pb = _pl_int_in_bits(ins[1], kwargs.get("k_bits"))
    out_prec = min(adaptive_precision(pa, pb, dd, "mac"), 32)
    out_bits = kwargs.get("out_bits")
    # `out_bits` is the caller's profiled score envelope (§V-C adaptive
    # precision): it narrows what downstream lowerings (softmax's scratch
    # layout) size against, not the accumulator itself
    meta_prec = min(out_prec, _clamp_bits(out_bits)) if out_bits else out_prec

    def bind(vals):
        a = np.asarray(vals[0]).astype(np.int64)
        # the DRAM path wants the shared operand as (k, y) = Kᵀ; the resident
        # path (vals[1] is None) reads the kv_append layout in place, which
        # already holds key row y's fields on lane y
        b = None if vals[1] is None else np.asarray(vals[1]).astype(np.int64).T
        return {"a": a, "b": b}, None, None

    def finalize(raw, _state):
        return raw.reshape(mm, tt).astype(np.int32)

    return OpLowering(
        workload=_gemm_workload(node, mm, tt, dd, pa, pb),
        out_meta=ValueMeta((mm, tt), meta_prec, 0, "int", "int32"),
        chainable=True,
        chained={"in_b": 1} if ins[1].meta is not None else {},
        bind=bind,
        finalize=finalize,
    )


@_program_lowering("softmax_fixedpoint")
def _pl_softmax_fixedpoint(node: str, ins: List[InDesc], kwargs: Dict[str, Any]) -> OpLowering:
    _pl_require_int(node, ins[0])
    if kwargs.get("in_frac") is None:
        raise ValueError(f"{node}: softmax_fixedpoint needs the in_frac kwarg")
    in_frac = int(kwargs["in_frac"])
    r, t = ins[0].shape
    pin = max(_pl_int_in_bits(ins[0], kwargs.get("in_bits")),
              in_frac + SOFTMAX_K)
    wl = _softmax_workload(node, r, t, pin, in_frac)

    def bind(vals):
        return {"x": np.asarray(vals[0]).astype(np.int64)}, None, None

    def finalize(raw, _state):
        return raw.reshape(r, t).astype(np.int32)

    return OpLowering(
        workload=wl,
        out_meta=ValueMeta((r, t), softmax_out_prec(), 0, "int", "int32"),
        chainable=True,
        chained={},
        bind=bind,
        finalize=finalize,
    )


@_program_lowering("attention_pv")
def _pl_attention_pv(node: str, ins: List[InDesc], kwargs: Dict[str, Any]) -> OpLowering:
    _pl_require_int(node, ins[0], ins[1])
    mm, tt = ins[0].shape
    tt2, nn = ins[1].shape
    assert tt == tt2, (tt, tt2)
    shift = int(kwargs.get("shift", SOFTMAX_F))
    pa = _pl_int_in_bits(ins[0], kwargs.get("p_bits"))
    pb = _pl_int_in_bits(ins[1], kwargs.get("v_bits"))
    wl = _pv_workload(node, mm, nn, tt, pa, pb, shift)

    def bind(vals):
        # the V cache is never chained: kv_append leaves lane t holding row
        # t's head-dim fields, but this reduction wants lane y to hold column
        # y's *time* fields — a transposed layout, so V always round-trips
        # DRAM (the KV-residency contract documented in docs/serving.md)
        return (
            {"a": np.asarray(vals[0]).astype(np.int64),
             "b": np.asarray(vals[1]).astype(np.int64)},
            None, None,
        )

    def finalize(raw, _state):
        return raw.reshape(mm, nn).astype(np.int32)

    return OpLowering(
        workload=wl,
        out_meta=ValueMeta((mm, nn), wl.out.prec, 0, "int", "int32"),
        chainable=True,
        chained={},
        bind=bind,
        finalize=finalize,
    )


@_program_lowering("decode_gemv")
def _pl_decode_gemv(node: str, ins: List[InDesc], kwargs: Dict[str, Any]) -> OpLowering:
    _pl_require_int(node, ins[0], ins[1])
    mm, kk = ins[0].shape
    (kk2,) = ins[1].shape
    assert kk == kk2, (kk, kk2)
    pa = _pl_int_in_bits(ins[0], kwargs.get("w_bits"))
    pb = _pl_int_in_bits(ins[1], kwargs.get("x_bits"))
    out_prec = min(adaptive_precision(pa, pb, kk, "mac"), 32)
    # the eager path bakes the activation into RF constants (its values are
    # in hand); a compiled program replays with fresh activations, so the
    # vector becomes the broadcast shared operand of a width-1 gemm instead
    wl = _gemm_workload(node, mm, 1, kk, pa, pb)

    def bind(vals):
        return (
            {"a": np.asarray(vals[0]).astype(np.int64),
             "b": np.asarray(vals[1]).astype(np.int64).reshape(kk, 1)},
            None, None,
        )

    def finalize(raw, _state):
        return raw.reshape(mm).astype(np.int32)

    return OpLowering(
        workload=wl,
        out_meta=ValueMeta((mm,), out_prec, 0, "int", "int32"),
        chainable=True,
        chained={},
        bind=bind,
        finalize=finalize,
    )


@_program_lowering("kv_append")
def _pl_kv_append(node: str, ins: List[InDesc], kwargs: Dict[str, Any]) -> OpLowering:
    _pl_require_int(node, ins[0], ins[1])
    tt, dd = ins[0].shape
    (dd2,) = ins[1].shape
    (tt2,) = ins[2].shape
    assert dd == dd2 and tt == tt2, (ins[0].shape, ins[1].shape, ins[2].shape)
    prec = max(_pl_int_in_bits(ins[0], kwargs.get("bits")),
               _pl_int_in_bits(ins[1], kwargs.get("bits")))
    out_dtype = ins[0].aval[1]
    wl = _kv_append_workload(node, tt, dd, prec)

    def bind(vals):
        # vals[0] is None when the cache is a CRAM-resident ResidentState:
        # the executor seeded the reserved wordlines and in_a issues no loads
        cache = None if vals[0] is None else np.asarray(vals[0]).astype(np.int64)
        ov = np.asarray(vals[2]).astype(np.int64)
        _check_onehot(node, ov)
        return (
            {"cache": cache, "new": np.asarray(vals[1]).astype(np.int64),
             "onehot": ov},
            None, None,
        )

    def finalize(raw, _state):
        return raw.reshape(tt, dd).astype(np.dtype(out_dtype))

    return OpLowering(
        workload=wl,
        out_meta=ValueMeta((tt, dd), prec, 0, "int", out_dtype),
        chainable=True,
        chained={},
        bind=bind,
        finalize=finalize,
    )


# ---------------------------------------------------------------------------
# graph assembly, compilation, execution
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StateBinding:
    """One :class:`~repro_torch.kernels.program.ResidentState` bound into a
    compiled program: the slot that names it, the ``kv_append`` node that
    updates it, and the reserved wordline region ``[start, end)`` its rows
    occupy on the state tile (lane t holds the ``shape[1]`` fields of cache
    row t at ``prec`` bits each)."""

    slot: int
    name: str
    shape: Tuple[int, int]
    prec: int
    node: str
    node_idx: int
    start: int
    end: int


def _plan_states(program, node_names, lowerings, cram_rows: int,
                 state_slots) -> Tuple[StateBinding, ...]:
    """Derive the persistent-state layout of a program: one reserved region
    per state, stacked down from the top of the wordline space, plus the
    unique updater node whose in_a/out pin to it.  Structural errors (no
    updater, a second reader, spec mismatch) raise — they are programming
    errors in the traced function, not mapping declines."""
    if not state_slots:
        return ()
    bindings: List[StateBinding] = []
    base = cram_rows
    for slot in sorted(state_slots):
        name, shape, prec = state_slots[slot]
        if len(shape) != 2:
            raise ValueError(
                f"ResidentState {name!r} must be 2-D (rows, fields), got {shape}"
            )
        updaters = [
            i for i, op in enumerate(program.ops)
            if op.inputs and op.inputs[0] == ("slot", slot)
            and lowerings[i].workload.op == "kv_append"
        ]
        if len(updaters) != 1:
            raise ValueError(
                f"ResidentState {name!r} (slot {slot}) needs exactly one "
                f"kv_append node reading it as the cache operand, found "
                f"{len(updaters)}"
            )
        i = updaters[0]
        others = [
            node_names[j] for j, op in enumerate(program.ops)
            if j != i and ("slot", slot) in op.inputs
        ]
        if others:
            raise ValueError(
                f"ResidentState {name!r} is also read by {others}: a CRAM-"
                "resident state is only visible through its updater's output"
            )
        wl = lowerings[i].workload
        got = (wl.total_out_elems(), wl.reduce_extent(), wl.out.prec)
        if got != (shape[0], shape[1], prec):
            raise ValueError(
                f"ResidentState {name!r} spec (rows, fields, prec)="
                f"{(shape[0], shape[1], prec)} does not match its updater's "
                f"lowering {got}"
            )
        base -= shape[1] * prec
        bindings.append(StateBinding(
            slot=slot, name=name, shape=(shape[0], shape[1]), prec=prec,
            node=node_names[i], node_idx=i, start=base, end=base + shape[1] * prec,
        ))
    if base < 0:
        raise ValueError(
            f"persistent-state regions need {cram_rows - base} wordlines, "
            f"exceeding the {cram_rows}-row CRAM"
        )
    return tuple(bindings)


@dataclass
class CompiledTracedProgram:
    """An ``api.Program`` lowered once for both machines: the functional
    fused stream (bit-exact execution) and the static aggregated report from
    the full-scale timing stream."""

    program: Any                      # repro_torch.kernels.program.Program
    node_names: Tuple[str, ...]
    lowerings: Tuple[OpLowering, ...]
    cg_fn: CompiledGraph
    report: SimReport
    cfg_fn: PimsabConfig
    verify_reports: Tuple[VerifyReport, ...] = ()  # (functional, timing) when verified
    states: Tuple[StateBinding, ...] = ()  # ResidentState layout (may be declined)
    cg_t: Optional[CompiledGraph] = None  # timing stream (multi-chip re-steps it)
    cfg_t: Optional[PimsabConfig] = None


def _build_graph(program) -> Tuple[List[str], List[OpLowering], WorkloadGraph]:
    """Assemble the WorkloadGraph of a traced Program: one node per captured
    kernel call (in trace order — already topological), one edge per
    node-valued input.  Shared by the functional compile and the timing-only
    path (network shapes beyond bit-serial simulation)."""
    node_names: List[str] = [f"n{i}.{op.kernel}" for i, op in enumerate(program.ops)]
    lowerings: List[OpLowering] = []
    edges: List[GraphEdge] = []
    for i, op in enumerate(program.ops):
        lower = _PROGRAM_LOWERINGS.get(op.kernel)
        if lower is None:
            raise NotImplementedError(
                f"kernel {op.kernel!r} has no program lowering for the pimsab "
                "backend (add one to pimsab_backend._PROGRAM_LOWERINGS)"
            )
        descs: List[InDesc] = []
        for (kind, j) in op.inputs:
            if kind == "node":
                lw = lowerings[j]
                descs.append(InDesc(
                    aval=(lw.out_meta.shape, lw.out_meta.dtype),
                    meta=lw.out_meta if lw.chainable else None,
                ))
            elif kind == "slot":
                descs.append(InDesc(aval=program.slot_avals[j]))
            else:
                c = program.consts[j]
                descs.append(InDesc(aval=(tuple(c.shape), _dtype_name(c.dtype))))
        low = lower(node_names[i], descs, dict(op.kwargs))
        lowerings.append(low)
        chained_pos = set(low.chained.values())
        pos_to_buf = {pos: buf for buf, pos in low.chained.items()}
        for pos, (kind, j) in enumerate(op.inputs):
            if kind != "node":
                continue
            buf = pos_to_buf.get(pos) or ("in_a" if pos == 0 else "in_b" if pos == 1 else f"in{pos}")
            edges.append(GraphEdge(
                src=node_names[j], dst=node_names[i], dst_input=buf,
                resident_ok=pos in chained_pos,
            ))

    outputs = tuple(dict.fromkeys(
        node_names[j] for (kind, j) in program.out_refs if kind == "node"
    ))
    graph = WorkloadGraph(
        name=program.name,
        nodes=tuple(low.workload for low in lowerings),
        edges=tuple(edges),
        outputs=outputs,
    )
    return node_names, lowerings, graph


def compile_traced_program(
    program,
    cfg_fn: Optional[PimsabConfig] = None,
    cfg_timing: Optional[PimsabConfig] = None,
    *,
    verify: bool = True,
    state_slots=None,
    tune: Any = None,
) -> CompiledTracedProgram:
    """Lower a traced Program into one WorkloadGraph and compile it for the
    functional machine (execution) and the full-scale machine (report).

    ``verify=True`` (the default) statically verifies *both* fused streams —
    liveness/def-use, schedule-hazard races, precision-overflow lint — and
    raises :class:`~repro_torch.core.compiler.verify.VerifierError` on any error;
    the pair of reports attaches as ``.verify_reports`` (also surfaced via
    :func:`last_verify_report`) so cache introspection can read the plan
    notes (residency/double-buffer declines) of the compiled artifact.

    ``state_slots`` maps a slot index to a ``(name, (rows, fields), prec)``
    ResidentState spec: the slot's ``kv_append`` updater is pinned to a
    reserved wordline region so the cache append updates CRAM in place (the
    mapping layer may still decline — cost- or capacity-gated — in which
    case the state transparently falls back to a host-side round-trip).

    ``tune`` (``True`` or a :class:`~repro_torch.core.compiler.autotune.TuneConfig`;
    ``None`` inherits an enclosing :func:`autotune.tuning` scope) runs the
    graph-level mapping autotuner over the **timing** lowering only: the
    functional stream keeps the heuristic plan, so execution stays
    bit-exact while the modeled schedule takes the searched winner.  The
    search provenance lands in ``report.autotune``."""
    cfg_fn = cfg_fn or _functional_cfg()
    cfg_t = cfg_timing or TIMING_CFG
    assert cfg_fn.cram_rows == cfg_t.cram_rows, "state layout needs equal CRAMs"
    node_names, lowerings, graph = _build_graph(program)
    state_bindings = _plan_states(
        program, node_names, lowerings, cfg_fn.cram_rows, state_slots
    )
    pins = {
        b.node: {"in_a": [(b.start, b.end)], "out": [(b.start, b.end)]}
        for b in state_bindings
    }
    cg_fn = compile_graph(graph, cfg_fn, state_pins=pins or None)
    tc = autotune.resolve(tune) if tune is not None else autotune.active()
    tuned_prov: Dict[str, Any] = {}
    if tc is not None:
        tg = autotune.tune_graph(graph, cfg_t, tc, state_pins=pins or None)
        cg_t = compile_graph(graph, cfg_t, gm=tg.gm)
        tuned_prov = tg.provenance
    else:
        cg_t = compile_graph(graph, cfg_t, state_pins=pins or None)
    vreports: Tuple[VerifyReport, ...] = ()
    if verify:
        vreports = (verify_graph(cg_fn, cfg_fn), verify_graph(cg_t, cfg_t))
        _tls.verify_reports = vreports
        for vr in vreports:
            vr.raise_on_error()
    state_edges = tuple(
        edge for b in state_bindings if b.node in cg_t.gm.state_pins
        for edge in (f"state:{b.name}->{b.node}", f"{b.node}->state:{b.name}")
    )
    report = _program_report(
        program, cg_t, cfg_t,
        functional_instrs=len(cg_fn.program), state_edges=state_edges,
        tuned_prov=tuned_prov,
    )
    return CompiledTracedProgram(
        program=program,
        node_names=tuple(node_names),
        lowerings=tuple(lowerings),
        cg_fn=cg_fn,
        report=report,
        cfg_fn=cfg_fn,
        verify_reports=vreports,
        states=state_bindings,
        cg_t=cg_t,
        cfg_t=cfg_t,
    )


def timing_program_report(
    program, cfg_timing: Optional[PimsabConfig] = None, *, verify: bool = True,
    tune: Any = None,
) -> SimReport:
    """Timing-only program lowering: compile the fused WorkloadGraph for the
    full-scale machine and run the analytic model, skipping the functional
    compile entirely.  This is how network shapes far beyond bit-serial
    functional simulation (the paper-shaped ResNet18 config) still get their
    modeled end-to-end cycles/energy and per-layer breakdown.  ``verify=True``
    (the default) statically verifies the full-scale stream first and raises
    on any error.  ``tune`` opts the graph plan into the mapping autotuner
    (``None`` inherits an enclosing :func:`autotune.tuning` scope)."""
    _, report = compile_timing_program(
        program, cfg_timing, verify=verify, tune=tune
    )
    return report


def compile_timing_program(
    program, cfg_timing: Optional[PimsabConfig] = None, *, verify: bool = True,
    tune: Any = None,
) -> Tuple[CompiledGraph, SimReport]:
    """:func:`timing_program_report` that also returns the compiled stream —
    the multi-chip layer re-steps per-chip copies of it on a shared clock."""
    cfg_t = cfg_timing or TIMING_CFG
    _, _, graph = _build_graph(program)
    tc = autotune.resolve(tune) if tune is not None else autotune.active()
    tuned_prov: Dict[str, Any] = {}
    if tc is not None:
        tg = autotune.tune_graph(graph, cfg_t, tc)
        cg_t = compile_graph(graph, cfg_t, gm=tg.gm)
        tuned_prov = tg.provenance
    else:
        cg_t = compile_graph(graph, cfg_t)
    if verify:
        vrep = verify_graph(cg_t, cfg_t)
        _tls.verify_reports = (vrep,)
        vrep.raise_on_error()
    report = _program_report(program, cg_t, cfg_t, functional_instrs=0,
                             tuned_prov=tuned_prov)
    return cg_t, report


def _program_report(
    program, cg_t: CompiledGraph, cfg: PimsabConfig, functional_instrs: int,
    state_edges: Tuple[str, ...] = (),
    tuned_prov: Optional[Dict[str, Any]] = None,
) -> SimReport:
    """Aggregated timing/energy over the fused stream, attributed per node
    via the codegen segments, with the cross-kernel DRAM-traffic breakdown.
    ``total_cycles`` per node is its *makespan* share (segment boundaries are
    timeline barriers, so shares are well-defined and sum to the total);
    ``cycles`` stays the charged per-category delta."""
    sim = Simulator(cfg, record_timeline=_profiling())
    per_kernel: List[Dict[str, Any]] = []
    prev: Dict[str, float] = {}
    prev_makespan = 0.0
    for (node, start, end), op in zip(cg_t.segments, program.ops):
        for ins in cg_t.program[start:end]:
            sim.step(ins)
        snap = dict(sim.res.cycles)
        delta = {k: snap.get(k, 0.0) - prev.get(k, 0.0) for k in snap}
        per_kernel.append({
            "kernel": op.kernel,
            "node": node,
            "cycles": delta,
            "total_cycles": sim.res.makespan - prev_makespan,
            "serialized_cycles": sum(delta.values()),
            "dram_cycles": delta.get("dram", 0.0),
        })
        prev = snap
        prev_makespan = sim.res.makespan
    res = sim.res
    gm = cg_t.gm
    traffic: Dict[str, Dict[str, float]] = {}
    for w in gm.graph.nodes:
        eff = dict(gm.mappings[w.name].dram_split)
        for stream in list(eff):
            if f"{w.name}:{stream}" in gm.elided_bits:
                eff[stream] = 0.0
        traffic[w.name] = eff
    return SimReport(
        kernel="program",
        workload=program.name,
        total_cycles=res.total_cycles,
        cycles=dict(res.cycles),
        cycle_breakdown=res.breakdown(),
        energy_pj=dict(res.energy.pj),
        energy_j=res.energy.total_j,
        modeled_seconds=res.seconds(cfg),
        instrs=res.instrs,
        instr_mix=dict(Counter(type(i).__name__ for i in cg_t.program)),
        mapping=gm.to_json(),
        functional_instrs=functional_instrs,
        serialized_cycles=res.serialized_cycles,
        overlapped_cycles=res.overlapped_cycles,
        critical_path=dict(res.critical_path),
        utilization=res.utilization(),
        timeline=tuple(res.timeline) if res.timeline else (),
        kernels=program.kernels,
        per_kernel=tuple(per_kernel),
        dram_traffic=traffic,
        elided_dram_bits=gm.total_elided_bits,
        resident_edges=tuple(f"{e.src}->{e.dst}" for e in gm.resident) + state_edges,
        autotune=dict(tuned_prov or {}),
    )


def execute_traced_program(
    ctp: CompiledTracedProgram, leaves: List[Any], states=None
) -> List[Any]:
    """Run the fused functional stream with fresh slot values on the host;
    returns the program's output leaves and stashes the aggregated report
    for :func:`last_sim_report`.  Slot leaves are read through
    :func:`_as_numpy` (a card tensor is copied to the host); a node output
    returns as a fresh tensor of its ``out_meta`` dtype on the device of the
    first tensor leaf (the CPU when there is none), a slot output as the
    leaf itself and a constant output as the captured constant.

    ``states`` maps slot index → ResidentState handle, one per binding in
    ``ctp.states``.  Handles of CRAM-resident (accepted) states are seeded
    into the reserved wordlines before the stream and harvested back after
    it — the slot's *leaf* value is ignored, the handle is the source of
    truth.  Declined states fall back transparently: the handle's value
    streams through DRAM and the updater's finalized output is written back.
    ``ResidentState.value`` is an int64 CPU tensor on both sides."""
    import dataclasses

    program = ctp.program
    gm = ctp.cg_fn.gm
    cfg = ctp.cfg_fn
    idx_of = {n: i for i, n in enumerate(ctp.node_names)}
    planes: Dict[str, _DataPlane] = {}
    bind_states: Dict[int, Any] = {}
    values: Dict[int, np.ndarray] = {}

    state_by_node: Dict[str, Tuple[StateBinding, Any]] = {}
    state_by_slot: Dict[int, Tuple[StateBinding, Any]] = {}
    for b in ctp.states:
        h = (states or {}).get(b.slot)
        if h is None:
            raise ValueError(
                f"program {program.name!r} was compiled with ResidentState "
                f"{b.name!r} on slot {b.slot}, but no handle was bound for it"
            )
        if (h.name, tuple(h.shape), int(h.prec)) != (b.name, b.shape, b.prec):
            raise ValueError(
                f"state handle {h.name!r} {(tuple(h.shape), int(h.prec))} does "
                f"not match the compiled spec {b.name!r} {(b.shape, b.prec)}"
            )
        state_by_node[b.node] = (b, h)
        state_by_slot[b.slot] = (b, h)
    # a state is CRAM-resident only if the mapping layer accepted its pins
    accepted = {n: bh for n, bh in state_by_node.items() if n in gm.state_pins}

    sim = Simulator(cfg, functional=True)

    def _seed_state(b: StateBinding, h) -> None:
        vals = _as_numpy(h.value).astype(np.int64)
        for j in range(b.shape[1]):
            _write_lanes(sim, 0, b.start + j * b.prec, vals[:, j], b.prec)

    def _harvest_state(b: StateBinding) -> np.ndarray:
        return np.stack(
            [_read_lanes(sim, 0, b.start + j * b.prec, b.prec, b.shape[0])
             for j in range(b.shape[1])],
            axis=1,
        )

    def slot_value(j: int) -> np.ndarray:
        if j in state_by_slot:
            # state-bound slot: the handle, never the leaf (the leaf is an
            # aval-matching placeholder)
            return _as_numpy(state_by_slot[j][1].value)
        v = static_value(leaves[j])
        if v is None:
            raise PimsabTracerError(
                f"program {program.name!r} executed on the pimsab backend "
                f"needs operands that hold values, but input leaf {j} is a "
                f"{type(leaves[j]).__name__} without them (a meta tensor or a "
                "trace placeholder)"
            )
        return _as_numpy(v)

    def node_value(j: int) -> np.ndarray:
        if j not in values:
            node = ctp.node_names[j]
            if node in accepted:
                # state updater with elided stores: the value lives in the
                # reserved wordlines, not on the data plane
                b, _h = accepted[node]
                values[j] = ctp.lowerings[j].finalize(
                    _harvest_state(b), bind_states.get(j)
                )
                return values[j]
            plane = planes.get(node)
            if plane is None:
                raise RuntimeError(
                    f"value of {node} requested before its stores executed "
                    "(graph not topologically ordered?)"
                )
            values[j] = ctp.lowerings[j].finalize(plane.out, bind_states.get(j))
        return values[j]

    def resolve(r) -> np.ndarray:
        kind, j = r
        if kind == "slot":
            return slot_value(j)
        if kind == "const":
            return _as_numpy(program.consts[j])
        return node_value(j)

    def bind_node(i: int) -> _DataPlane:
        node = ctp.node_names[i]
        low = ctp.lowerings[i]
        resident_pos = {
            pos for buf, pos in low.chained.items() if gm.is_resident(node, buf)
        }
        if "in_a" in gm.state_elides(node):
            resident_pos.add(0)  # the updater's cache input reads CRAM in place
        vals = [
            None if pos in resident_pos else resolve(r)
            for pos, r in enumerate(program.ops[i].inputs)
        ]
        arrays, h0, state = low.bind(vals)
        bind_states[i] = state
        plane = _DataPlane(low.workload, gm.mappings[node], cfg, arrays, h0=h0)
        planes[node] = plane
        return plane

    def plane_for(tag: str) -> Tuple[_DataPlane, str, int]:
        node, stream = tag.split(":", 1)
        plane = planes.get(node)
        if plane is None:
            plane = bind_node(idx_of[node])
        return plane, stream, idx_of[node]

    for b, h in accepted.values():
        _seed_state(b, h)
    for ins in ctp.cg_fn.program:
        if isinstance(ins, isa.DramLoad) and ins.tag:
            plane, stream, i = plane_for(ins.tag)
            m = gm.mappings[ctp.node_names[i]]
            stripped = dataclasses.replace(ins, tag=stream)
            for t in (ins.tiles or range(m.tiles_used)):
                slab, prec = plane.load(stripped, t)
                _write_lanes(sim, t, ins.cram_addr, slab, prec)
        sim.step(ins)
        if isinstance(ins, isa.DramStore) and ins.tag and ins.tag.endswith(":out"):
            plane, stream, i = plane_for(ins.tag)
            m = gm.mappings[ctp.node_names[i]]
            stripped = dataclasses.replace(ins, tag=stream)
            for t in (ins.tiles or range(m.tiles_used)):
                plane.collect(
                    stripped, t,
                    lambda addr, prec, _t=t: _read_lanes(sim, _t, addr, prec, m.lanes_used),
                )
    # write the post-step cache back into every handle: harvested from the
    # reserved wordlines when resident, or the updater's finalized output
    # when the mapping declined residency
    for node, (b, h) in state_by_node.items():
        if node in accepted:
            value = _harvest_state(b)
        else:
            value = node_value(b.node_idx)
        h.value = torch.from_numpy(np.asarray(value, np.int64).reshape(b.shape).copy())
    like = next((l for l in leaves if isinstance(l, torch.Tensor)), None)
    out_leaves = []
    for (kind, j) in program.out_refs:
        if kind == "node":
            dtype = np.dtype(ctp.lowerings[j].out_meta.dtype)
            out_leaves.append(_to_torch(np.asarray(node_value(j), dtype), like))
        elif kind == "slot":
            out_leaves.append(leaves[j])
        else:
            out_leaves.append(program.consts[j])
    _stash_report(ctp.report)
    return out_leaves
