"""Kernel registry, typed operands and public kernel wrappers of the port.

The port's counterpart of the JAX package's ``kernels/api.py``:

* :class:`SlicedTensor` — a logical integer tensor stored as a stack of
  signed-digit slices, with its dequantization scale and the ids of its
  all-zero slices, so the paper's zero-slice skipping reaches the kernel by
  construction; :class:`PrecisionSpec` and its adaptive-precision presets.
* The registry: each kernel module registers its implementation with
  :func:`register_kernel`, paired with its plain oracle, and the public
  wrappers below all go through :func:`dispatch`.
* The Program API (:mod:`repro_torch.kernels.program`, re-exported here):
  :func:`trace` captures a chain of registry kernel calls into a
  :class:`Program`; :func:`compile` returns its cached :class:`Executor`.

Dispatch goes by the device of the operands.  On CUDA tensors an
implementation launches its hand-written kernel (``csrc/``) or raises; on CPU
tensors it runs the kernel's plain PyTorch version.  Nothing falls back from
one to the other.  The one backend scope, ``use_backend("pimsab")``, sends
every call to the kernel's lowering onto the PIMSAB architecture model
(:mod:`repro_torch.kernels.pimsab_backend`: compiler, ISA and bit-serial
simulator on the host), whose modeled cycles and energy
:func:`last_sim_report` returns; its results return to the operands' device.
A Program compiled inside the scope (or with ``backend="pimsab"``) lowers as
one fused graph onto the same model.  Inside :func:`trace` a call is
recorded instead of run.  Each kernel launch adds one to the
counter ``launch.<kernel>`` of the port's counter registry
(:mod:`repro_torch.obs`, which also holds the program's and the serving
engine's counters); :func:`launch_counts` and :func:`reset_launch_counts`
read and clear the launch counters alone, so a run can show which kernels
it went through.  While an Executor captures a CUDA graph, the counts its
thread takes (launches and the rest) go to a :class:`LaunchLog` instead,
which each replay of the graph adds (:func:`recording_launches`,
:func:`replay_launches`).

The kernels a dry run's steps reach (the bit-sliced GEMM, the activation
quantize in front of it, the row dot of q·Kᵀ, the RG-LRU scan and its
gradient) also take ``meta`` operands, on an
explicit route of their own (:func:`meta_operands`): the card's checks of
dtypes, shapes and index range, then a ``meta`` output of the kernel's
shape and dtype where the card would launch.  It launches nothing and
counts no launch.  Inside :func:`kernels_as_units` each call of these
kernels that the card would launch, on any device, notes its work
(:func:`kernel_work`: one call, operations, and bytes as each input read
once and each output written once), so a run counts each kernel as one
unit, and a plain version runs outside the dispatch modes that count a
step's PyTorch ops.  Outside it nothing is noted.  Nothing else takes
``meta`` operands.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels import program as _program
from repro_torch.kernels import ref
from repro_torch.kernels.program import (
    Executor,
    Program,
    ResidentState,
    TraceError,
    TracedFunction,
    clear_compile_cache,
    compile_cache_info,
    compile_program,
    trace,
)

__all__ = [
    "PrecisionSpec",
    "SlicedTensor",
    "static_value",
    "absmax_scale",
    "KernelDef",
    "register_kernel",
    "get_kernel",
    "registered_kernels",
    "dispatch",
    "BACKENDS",
    "current_backend",
    "use_backend",
    "on_device",
    "register_pimsab_impl",
    "PimsabTracerError",
    "last_sim_report",
    "sim_report_log",
    "clear_sim_report_log",
    "last_verify_report",
    "profile_timelines",
    "TuneConfig",
    "tuning",
    "resolve_device",
    "kernel_device",
    "meta_operands",
    "noting_work",
    "note_kernel_work",
    "kernel_work",
    "reset_kernel_work",
    "kernels_as_units",
    "plain_scope",
    "count_launch",
    "launch_counts",
    "reset_launch_counts",
    "active_pairs",
    "skip_pairs",
    "zero_slice_pairs",
    "last_executed_pairs",
    "bitslice_matmul_oracle",
    "matmul",
    "quantized_matmul",
    "act_quant",
    "act_quant_plain",
    "grouped_matmul",
    "dequant_plain",
    "dequant_matmul_takes",
    "dequant_matmul",
    "grouped_dequant_matmul",
    "quantize_int8",
    "ewise_add",
    "relu",
    "conv2d",
    "maxpool2d",
    "avgpool2d",
    "global_avgpool",
    "int_matmul",
    "attention_qk",
    "softmax_fixedpoint",
    "attention_pv",
    "decode_gemv",
    "kv_append",
    "htree_reduce",
    "rglru_scan",
    # Program API (re-exported from repro_torch.kernels.program)
    "trace",
    "compile",
    "Program",
    "ResidentState",
    "Executor",
    "TracedFunction",
    "TraceError",
    "compile_cache_info",
    "clear_compile_cache",
    # Multi-chip scale-out (re-exported from repro_torch.kernels.multichip)
    "ChipCluster",
    "ChipLink",
    "ClusterExecutor",
    "ClusterReport",
    "compile_cluster",
    "cluster_timing_report",
    "weak_scaling_report",
]

# ``api.compile(program)``, the documented spelling; the module-level name
# shadows the builtin on purpose.
compile = compile_program


# ---------------------------------------------------------------------------
# staticness probe
# ---------------------------------------------------------------------------


def static_value(arr: Any) -> Any:
    """The operand itself when its values exist (a tensor on the CPU or a
    card, an ndarray or a Python scalar), else ``None``: a trace placeholder
    (:class:`~repro_torch.kernels.program.ProgramValue`) or a meta tensor.
    The eager pimsab backend reads only operands with values; it refuses the
    others with :class:`PimsabTracerError`."""
    if arr is None or isinstance(arr, _program.ProgramValue):
        return None
    if isinstance(arr, torch.Tensor):
        return None if arr.device.type == "meta" else arr
    return np.asarray(arr)


# ---------------------------------------------------------------------------
# PrecisionSpec
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PrecisionSpec:
    """Bit widths of one logical matmul, PIMSAB adaptive-precision style.

    ``slice_bits`` is the native slice width (8: one int8 operand of the
    card's integer dot products); operands wider than a slice are decomposed
    into ``ceil(bits / slice_bits)`` slices and recombined with shifts.
    """

    act_bits: int = 8
    weight_bits: int = 8
    slice_bits: int = 8
    accum_bits: int = 32

    def __post_init__(self) -> None:
        if not (1 <= self.slice_bits <= 8):
            raise ValueError(f"slice_bits must be in [1, 8], got {self.slice_bits}")
        if self.act_bits < 1 or self.weight_bits < 1:
            raise ValueError(f"bits must be >= 1: {self}")
        if self.accum_bits < self.act_bits + self.weight_bits:
            raise ValueError(
                f"accum_bits={self.accum_bits} cannot hold a "
                f"{self.act_bits}x{self.weight_bits}-bit product"
            )

    @property
    def act_slices(self) -> int:
        return max(1, math.ceil(self.act_bits / self.slice_bits))

    @property
    def weight_slices(self) -> int:
        return max(1, math.ceil(self.weight_bits / self.slice_bits))

    @property
    def single_pass(self) -> bool:
        """True if the matmul is one slice pair (no recombination)."""
        return self.act_slices == 1 and self.weight_slices == 1

    @classmethod
    def from_quant_config(cls, q) -> "PrecisionSpec":
        """Lift a quantization config (``act_bits``, ``weight_bits``,
        ``slice_bits``) into a spec."""
        return cls(act_bits=q.act_bits, weight_bits=q.weight_bits, slice_bits=q.slice_bits)


# Adaptive-precision presets (§IV-C), set after the class body because
# dataclass fields would swallow them.
for _name, _spec in {
    "int4": PrecisionSpec(act_bits=4, weight_bits=4),
    "int8": PrecisionSpec(act_bits=8, weight_bits=8),
    "int12": PrecisionSpec(act_bits=12, weight_bits=12),
    "int16": PrecisionSpec(act_bits=16, weight_bits=16),
    "w4a8": PrecisionSpec(act_bits=8, weight_bits=4),
    "w8a16": PrecisionSpec(act_bits=16, weight_bits=8),
}.items():
    setattr(PrecisionSpec, _name, _spec)
del _name, _spec


# ---------------------------------------------------------------------------
# SlicedTensor
# ---------------------------------------------------------------------------


def absmax_scale(xf: torch.Tensor, dim: int, qmax: int) -> torch.Tensor:
    """Symmetric quantization scale ``max(|x|) / qmax`` along ``dim`` (kept),
    floored at 1e-8.  The divisor is a tensor: CUDA divides by a Python
    number as a multiply by its reciprocal, which can round one ulp away
    from the true division that the CPU and the JAX package compute."""
    amax = torch.amax(xf.abs(), dim=dim, keepdim=True)
    return torch.clamp_min(amax / torch.full_like(amax, qmax), 1e-8)


def quantize_int8(xf: torch.Tensor, scale: torch.Tensor, qmax: int) -> torch.Tensor:
    """``clamp(round(xf / scale), -qmax - 1, qmax)`` as int8.  Above 8 bits
    values outside int8 saturate to −128 or 127, as XLA converts (a torch
    cast wraps them: 200.0 → −56)."""
    return torch.clamp(torch.clamp(torch.round(xf / scale), -qmax - 1, qmax), -128, 127).to(torch.int8)


def act_quant_plain(x: torch.Tensor, bits: int,
                    reduce_scale: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The activation quantize as PyTorch ops, in float32: the plain version
    of :func:`act_quant`.  Each row's scale is :func:`absmax_scale` at
    ``qmax = 2**(bits-1) - 1``, passed through ``reduce_scale`` where given
    (a row-parallel linear takes its max over the model axis), and the row
    is quantized by :func:`quantize_int8`."""
    qmax = 2 ** (bits - 1) - 1
    xf = x.to(torch.float32)
    scale = absmax_scale(xf, -1, qmax)
    if reduce_scale is not None:
        scale = reduce_scale(scale)
    return quantize_int8(xf, scale, qmax), scale


def dequant_plain(acc: torch.Tensor, x_scale: torch.Tensor, w_scale: torch.Tensor,
                  bias: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """The dequantize of a quantized linear as PyTorch ops: its int32 sums
    ``acc`` to float32, times the rows' scales ``x_scale``, times the
    columns' ``w_scale`` (each broadcast against ``acc``), plus ``bias`` in
    float32 where given, cast to ``dtype``.  The plain version of the
    dequantizing GEMMs (:func:`dequant_matmul`, :func:`grouped_dequant_matmul`),
    whose epilogue gives these values bit for bit."""
    out = acc.to(torch.float32) * x_scale * w_scale
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(dtype)


def _zero_slice_ids(slices: Any) -> Tuple[int, ...]:
    """Indices of the all-zero slices of a stack (``()`` when its values do
    not exist yet: a trace placeholder or a meta tensor).

    A tensor on the card is reduced there; only ``n_slices`` booleans cross
    to the host, never the stack itself.
    """
    if isinstance(slices, np.ndarray):
        return tuple(s for s in range(slices.shape[0]) if not slices[s].any())
    if static_value(slices) is None:
        return ()
    flags = torch.any(slices.reshape(slices.shape[0], -1), dim=1).cpu().tolist()
    return tuple(i for i, f in enumerate(flags) if not f)


@_program.register_pytree_node
@dataclass(frozen=True, eq=False)
class SlicedTensor:
    """A logical integer tensor stored as a stack of signed-digit slices.

    ``slices`` is ``(n_slices, *shape)`` int8 in the balanced signed-digit
    radix-2**slice_bits decomposition (low to high):

        value == Σ_s slices[s] · 2**(slice_bits·s)

    ``scale`` (optional) dequantizes the logical value back to float.
    ``zero_slices`` holds the slices that were all zero at construction —
    PIMSAB ``mul_const`` zero-bit skipping — and travels as static aux data
    through :func:`trace`, so kernels skip dead slice pairs even when the
    slice data itself is a trace placeholder.
    """

    slices: torch.Tensor
    scale: Optional[torch.Tensor] = None
    slice_bits: int = 8
    orig_bits: int = 8
    zero_slices: Tuple[int, ...] = ()

    # -- pytree protocol (children, then everything static as aux) --
    def tree_flatten(self):
        return (self.slices, self.scale), (self.slice_bits, self.orig_bits, self.zero_slices)

    @classmethod
    def tree_unflatten(cls, aux, children):
        slices, scale = children
        slice_bits, orig_bits, zero_slices = aux
        return cls(slices=slices, scale=scale, slice_bits=slice_bits,
                   orig_bits=orig_bits, zero_slices=zero_slices)

    # -- constructors --
    @classmethod
    def from_int(cls, x: torch.Tensor, bits: int, *, slice_bits: int = 8,
                 scale: Optional[torch.Tensor] = None) -> "SlicedTensor":
        """Decompose an integer tensor into slices, noting its zero slices."""
        slices = ref.to_slices(x, bits, slice_bits)
        return cls(slices=slices, scale=scale, slice_bits=slice_bits, orig_bits=bits,
                   zero_slices=_zero_slice_ids(slices))

    @classmethod
    def quantize(cls, x: torch.Tensor, spec: PrecisionSpec = PrecisionSpec.int8, *,
                 weight: bool = False, scale: Optional[torch.Tensor] = None) -> "SlicedTensor":
        """Dynamic symmetric per-row (activation) or per-column (weight)
        quantization: activations along the last axis (the contraction axis
        of ``x @ w``), weights along the second-to-last.  ``scale`` (the
        kept-dim scale) replaces the one taken from ``x``: a row-parallel
        linear quantizes its slice of each row with the whole row's."""
        bits = spec.weight_bits if weight else spec.act_bits
        axis = -2 if weight else -1
        qmax = 2 ** (bits - 1) - 1
        xf = x.to(torch.float32)
        if scale is None:
            scale = absmax_scale(xf, axis, qmax)
        x_q = torch.clamp(torch.round(xf / scale), -qmax - 1, qmax).to(torch.int32)
        return cls.from_int(x_q, bits, slice_bits=spec.slice_bits, scale=scale)

    # -- views --
    @property
    def n_slices(self) -> int:
        return self.slices.shape[0]

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.slices.shape[1:])

    def to_int(self) -> torch.Tensor:
        return ref.from_slices(self.slices, self.slice_bits)

    def dequantize(self) -> torch.Tensor:
        v = self.to_int().to(torch.float32)
        return v * self.scale if self.scale is not None else v


@dataclass(frozen=True)
class KernelDef:
    """One registered kernel: its implementation (CUDA kernel on the card,
    plain version on the CPU), its oracle, and its lowering onto the PIMSAB
    architecture model (attached separately by :func:`register_pimsab_impl`)."""

    name: str
    impl: Callable[..., Any]
    oracle: Callable[..., Any]
    pimsab: Optional[Callable[..., Any]] = None


_REGISTRY: Dict[str, KernelDef] = {}
_registry_lock = threading.Lock()


def register_kernel(name: str, *, oracle: Callable[..., Any]):
    """Decorator: pair a kernel implementation with its plain oracle.
    Registration is idempotent per name (last wins)."""

    def deco(fn: Callable[..., Any]) -> Callable[..., Any]:
        with _registry_lock:
            prev = _REGISTRY.get(name)
            _REGISTRY[name] = KernelDef(name=name, impl=fn, oracle=oracle,
                                        pimsab=prev.pimsab if prev else None)
        return fn

    return deco


def register_pimsab_impl(name: str):
    """Decorator: attach the architecture-simulator lowering to kernel
    ``name`` (which must already be registered)."""

    def deco(fn: Callable[..., Any]) -> Callable[..., Any]:
        with _registry_lock:
            try:
                kd = _REGISTRY[name]
            except KeyError:
                raise KeyError(f"cannot attach pimsab impl: kernel {name!r} not registered") from None
            _REGISTRY[name] = dataclasses.replace(kd, pimsab=fn)
        return fn

    return deco


_bootstrapped = False


def _ensure_registered() -> None:
    # Kernel modules self-register on import; importing them lazily avoids an
    # import cycle (they import this module for the decorator).
    global _bootstrapped
    if _bootstrapped:
        return
    import repro_torch.kernels.attention  # noqa: F401
    import repro_torch.kernels.bitslice_matmul  # noqa: F401
    import repro_torch.kernels.conv  # noqa: F401
    import repro_torch.kernels.ewise  # noqa: F401
    import repro_torch.kernels.htree_reduce  # noqa: F401
    import repro_torch.kernels.rglru_scan  # noqa: F401
    # last: attaches the simulator lowering to the kernels registered above
    import repro_torch.kernels.pimsab_backend  # noqa: F401

    _bootstrapped = True


def get_kernel(name: str) -> KernelDef:
    """The :class:`KernelDef` registered under ``name``."""
    _ensure_registered()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"no kernel {name!r} registered; have {sorted(_REGISTRY)}") from None


def registered_kernels() -> Mapping[str, KernelDef]:
    """A copy of the registry (tests enumerate it)."""
    _ensure_registered()
    return dict(_REGISTRY)


# ---------------------------------------------------------------------------
# devices
# ---------------------------------------------------------------------------


def resolve_device(device: Any = "cuda") -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (the default of every
    entry point) raises when CUDA is absent: the CPU runs only when the
    caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for, but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', not {str(dev)!r}")
    return dev


def kernel_device(*tensors: torch.Tensor) -> torch.device:
    """The one device all operands of a kernel lie on (CPU or CUDA); raises
    on mixed or other devices."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"kernel operands lie on different devices: {sorted(map(str, devs))}")
    (dev,) = devs
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"repro_torch kernels run on 'cuda' or 'cpu', not {str(dev)!r}")
    return dev


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------

LAUNCH = "launch."  # a kernel's launch counter in the obs registry: LAUNCH + kernel
# the thread-local records kernel wrappers leave at a launch (launch_record)
_records: List[threading.local] = []


def launch_record() -> threading.local:
    """A new thread-local record that a kernel wrapper sets where it
    launches (the pair list it was given, the path it took).  A graph
    replay sets it again as the graph's capture left it."""
    rec = threading.local()
    _records.append(rec)
    return rec


@dataclass
class LaunchLog:
    """What one replay of a captured CUDA graph launches: every count its
    capture took (``obs`` counter names, launches under ``launch.<kernel>``)
    and the values the capture left in each :func:`launch_record` (in their
    order of creation)."""

    taken: Dict[str, int] = dataclasses.field(default_factory=dict)
    records: Tuple[Dict[str, Any], ...] = ()

    @property
    def counts(self) -> Dict[str, int]:
        """The launches per kernel the capture recorded."""
        return {k[len(LAUNCH):]: n for k, n in self.taken.items() if k.startswith(LAUNCH)}


def count_launch(kernel: str) -> None:
    """Called by a kernel wrapper right after it launched ``kernel``."""
    obs.count(LAUNCH + kernel)


@contextlib.contextmanager
def recording_launches() -> Iterator[LaunchLog]:
    """Send this thread's counts (launches and the rest) and launch records
    to a fresh :class:`LaunchLog` while the block runs (a CUDA graph
    capture, which launches nothing); afterwards the counters and records
    are as they were before the block."""
    saved = [dict(r.__dict__) for r in _records]
    with obs.diverting_counts() as taken:
        log = LaunchLog(taken)
        for r in _records:
            r.__dict__.clear()
        try:
            yield log
        finally:
            log.records = tuple(dict(r.__dict__) for r in _records)
            for r, values in zip(_records, saved):
                r.__dict__.clear()
                r.__dict__.update(values)


def replay_launches(log: LaunchLog) -> None:
    """Account for one replay of a captured graph: add the counts its
    capture took and set each launch record as the capture left it."""
    obs.add_counts(log.taken)
    for r, values in zip(_records, log.records):
        r.__dict__.update(values)


def launch_counts() -> Dict[str, int]:
    """Launches per kernel since the last :func:`reset_launch_counts`."""
    return {k[len(LAUNCH):]: n for k, n in obs.counts(LAUNCH).items()}


def reset_launch_counts() -> None:
    obs.reset_counts(LAUNCH)


# ---------------------------------------------------------------------------
# kernel work, and the meta route
# ---------------------------------------------------------------------------

_work: Dict[str, List[float]] = {}
_work_lock = threading.Lock()
# open kernels_as_units scopes, process-wide: a backward on the autograd
# engine's device threads notes its kernels' work too
_units_depth = 0


def meta_operands(*tensors: torch.Tensor) -> bool:
    """Whether every operand is a ``meta`` tensor: a wrapper with a meta
    route takes it then (the card's checks, then a ``meta`` output where the
    card would launch); any other mix of devices goes to
    :func:`kernel_device`, which refuses ``meta``."""
    return all(t.device.type == "meta" for t in tensors)


def noting_work() -> bool:
    """Whether kernel calls note their work: inside :func:`kernels_as_units`
    only, so a run outside it computes and notes nothing."""
    return _units_depth > 0


def note_kernel_work(kernel: str, ops: float, nbytes: float) -> None:
    """Called by a kernel wrapper where the card would launch ``kernel``
    (on any device) while :func:`noting_work`: one call doing ``ops``
    operations (a multiply-add is two) and moving ``nbytes`` (each input
    read once, each output written once)."""
    if not noting_work():
        return
    with _work_lock:
        w = _work.setdefault(kernel, [0, 0.0, 0.0])
        w[0] += 1
        w[1] += ops
        w[2] += nbytes


def kernel_work() -> Dict[str, Dict[str, float]]:
    """``{kernel: {"calls", "ops", "bytes"}}`` noted since the last
    :func:`reset_kernel_work`, over every device (a meta call included):
    ``calls`` is the launches the card makes for those calls."""
    with _work_lock:
        return {k: {"calls": int(c), "ops": o, "bytes": b} for k, (c, o, b) in _work.items()}


def reset_kernel_work() -> None:
    with _work_lock:
        _work.clear()


@contextlib.contextmanager
def kernels_as_units() -> Iterator[None]:
    """While the block runs, kernel calls note their work
    (:func:`note_kernel_work`) and a kernel's plain version runs outside
    every ``TorchDispatchMode`` (:func:`plain_scope`): a mode counting a
    step's PyTorch ops sees a kernel call only by the work it notes, on the
    CPU as on the card and on ``meta``."""
    global _units_depth
    with _work_lock:
        _units_depth += 1
    try:
        yield
    finally:
        with _work_lock:
            _units_depth -= 1


def plain_scope():
    """The scope a kernel wrapper runs its plain version in: outside the
    dispatch modes inside :func:`kernels_as_units`, else no scope."""
    if noting_work():
        from torch.utils._python_dispatch import _disable_current_modes

        return _disable_current_modes()
    return contextlib.nullcontext()


# ---------------------------------------------------------------------------
# dispatch and the public wrappers
# ---------------------------------------------------------------------------


BACKENDS = ("pimsab",)

_backend_stack: contextvars.ContextVar[Tuple[str, ...]] = contextvars.ContextVar(
    "repro_torch_kernel_backend_stack", default=()
)


def current_backend() -> Optional[str]:
    """The innermost active backend scope (context-local): ``"pimsab"``, or
    ``None`` outside any scope, where each kernel runs on its operands'
    device."""
    stack = _backend_stack.get()
    return stack[-1] if stack else None


@contextlib.contextmanager
def use_backend(name: str) -> Iterator[str]:
    """Send every registry kernel call in the block to the ``"pimsab"``
    backend: the kernel's lowering onto the PIMSAB compiler and bit-serial
    simulator.  Nests and is context-local (a scope entered on one thread or
    async task does not leak into another).  The port has no other backend
    scope: outside it a kernel runs on the device its operands lie on."""
    if name not in BACKENDS:
        raise ValueError(
            f"unknown backend {name!r}: the port has no backend scope but "
            f"{BACKENDS}; outside it each kernel runs on the device its operands lie on"
        )
    token = _backend_stack.set(_backend_stack.get() + (name,))
    try:
        yield name
    finally:
        _backend_stack.reset(token)


@contextlib.contextmanager
def on_device() -> Iterator[None]:
    """Leave every backend scope for the block: its kernel calls run on the
    device their operands lie on.  An Executor runs its ops so, as the JAX
    package binds an Executor to its backend at compile time."""
    token = _backend_stack.set(())
    try:
        yield
    finally:
        _backend_stack.reset(token)


class PimsabTracerError(ValueError):
    """A pimsab-backend kernel was reached with operands that hold no values
    (a meta tensor or a trace placeholder), or while the current CUDA stream
    is captured into a graph.  Raised before lowering starts, naming the
    kernel; the call never falls back to the device."""


def _require_concrete_operands(name: str, args: Tuple[Any, ...]) -> None:
    for i, a in enumerate(args):
        if isinstance(a, (torch.Tensor, _program.ProgramValue)) and static_value(a) is None:
            raise PimsabTracerError(
                f"kernel {name!r} on the 'pimsab' backend needs operands that "
                f"hold values, but operand {i} is a {type(a).__name__} without "
                "them (a meta tensor or a trace placeholder). Run the kernel "
                "on CPU or CUDA tensors, or capture the chain with api.trace: "
                "a traced program compiled for pimsab executes with values."
            )
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise PimsabTracerError(
            f"kernel {name!r} on the 'pimsab' backend copies its operands to "
            "the host, which a CUDA graph capture on the current stream cannot "
            "hold; call it outside the capture"
        )


def dispatch(name: str, *args, **kwargs):
    """Run kernel ``name``: inside ``use_backend("pimsab")`` on its lowering
    onto the PIMSAB architecture model, else on the device its tensor
    operands lie on: its kernel wrappers launch the hand-written kernel for
    CUDA tensors and run the plain version for CPU ones (see
    :func:`kernel_device`).  Inside :func:`trace` the call is recorded into
    the Program under construction instead."""
    ctx = _program.active_trace()
    if ctx is not None:
        return ctx.record(name, args, kwargs)
    k = get_kernel(name)
    if current_backend() == "pimsab":
        if k.pimsab is None:
            raise NotImplementedError(
                f"kernel {name!r} has no pimsab lowering "
                "(register one with api.register_pimsab_impl)"
            )
        _require_concrete_operands(name, args)
        return k.pimsab(*args, **kwargs)
    return k.impl(*args, **kwargs)


# ---------------------------------------------------------------------------
# bit-sliced matmul
# ---------------------------------------------------------------------------


def active_pairs(n_x: int, n_w: int,
                 skip: Tuple[Tuple[int, int], ...] = ()) -> Tuple[Tuple[int, int], ...]:
    """The (s, t) slice pairs a bit-sliced matmul executes: every pair not
    in ``skip``.  Both the kernel's pair list and the oracle's loop are
    exactly this tuple, so a skipped pair is never launched."""
    dead = set(skip)
    return tuple((s, t) for s in range(n_x) for t in range(n_w) if (s, t) not in dead)


def skip_pairs(x: SlicedTensor, w: SlicedTensor) -> Tuple[Tuple[int, int], ...]:
    """(s, t) pairs known to contribute zero, from the operands' zero-slice
    metadata."""
    return tuple(
        (s, t)
        for s in range(x.n_slices)
        for t in range(w.n_slices)
        if s in x.zero_slices or t in w.zero_slices
    )


def zero_slice_pairs(x_slices: Any, w_slices: Any) -> Tuple[Tuple[int, int], ...]:
    """All-zero (s, t) pairs of raw slice stacks, for callers that have not
    built :class:`SlicedTensor` s.  Stacks whose values do not exist yet are
    taken as dense."""
    xs, ws = _zero_slice_ids(x_slices), _zero_slice_ids(w_slices)
    if not xs and not ws:
        return ()
    nx = x_slices.shape[0] if x_slices is not None else 1
    nw = w_slices.shape[0] if w_slices is not None else 1
    return tuple((s, t) for s in range(nx) for t in range(nw) if s in xs or t in ws)


# The pair list handed to the most recent bit-sliced matmul on this thread
# (the list the kernel is given and the oracle loops over); regression tests
# assert that skipped pairs never appear here.
_last_pairs = launch_record()


def last_executed_pairs() -> Tuple[Tuple[int, int], ...]:
    """The (s, t) slice-pair list the most recent bit-sliced matmul on this
    thread executed."""
    return getattr(_last_pairs, "pairs", ())


def note_executed_pairs(pairs: Tuple[Tuple[int, int], ...]) -> None:
    """Record ``pairs`` as this thread's :func:`last_executed_pairs`: set by
    :func:`matmul` (also while tracing) and by the ``bitslice_matmul``
    kernel, so a program's replay sets it too."""
    _last_pairs.pairs = pairs


def bitslice_matmul_oracle(x_slices: torch.Tensor, w_slices: torch.Tensor, *,
                           slice_bits: int = 8,
                           skip: Tuple[Tuple[int, int], ...] = ()) -> torch.Tensor:
    """Skip-aware plain oracle: loops exactly ``active_pairs(...)``; with an
    empty skip list this is ``ref.bitslice_matmul_ref``."""
    pairs = active_pairs(x_slices.shape[0], w_slices.shape[0], skip)
    return ref.bitslice_pairs_ref(x_slices, w_slices, slice_bits, pairs)


def matmul(x: SlicedTensor, w: SlicedTensor, *,
           skip: Tuple[Tuple[int, int], ...] = ()) -> torch.Tensor:
    """``x (M, K) @ w (K, N)`` over slice stacks, zero slices skipped.

    The skipped pairs are the union of the operands' zero-slice metadata and
    the explicit ``skip`` argument.  Returns float32 (scales applied) when
    either operand carries a scale, else the raw int32 accumulator.
    """
    if x.slice_bits != w.slice_bits:
        raise ValueError(f"slice_bits mismatch: {x.slice_bits} vs {w.slice_bits}")
    all_skip = tuple(sorted(set(skip_pairs(x, w)) | set(skip)))
    note_executed_pairs(active_pairs(x.n_slices, w.n_slices, all_skip))
    acc = dispatch("bitslice_matmul", x.slices, w.slices,
                   slice_bits=x.slice_bits, skip=all_skip)
    if x.scale is None and w.scale is None:
        return acc
    out = acc.to(torch.float32)
    if x.scale is not None:
        out = out * x.scale.reshape(-1, 1)
    if w.scale is not None:
        out = out * w.scale.reshape(1, -1)
    return out


def quantized_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                     spec: PrecisionSpec = PrecisionSpec.int8) -> torch.Tensor:
    """The paper's bit-sliced GEMM end to end: dynamic activation
    quantization → slice decomposition → zero-slice skip (by SlicedTensor
    construction) → bit-sliced integer matmul → dequantization.
    ``x (..., K)`` float; ``w_q (K, N)`` integer; out ``(..., N)``."""
    lead = x.shape[:-1]
    x_st = SlicedTensor.quantize(x.reshape(-1, x.shape[-1]), spec)
    w_st = SlicedTensor.from_int(w_q, spec.weight_bits, slice_bits=spec.slice_bits,
                                 scale=w_scale.reshape(-1))
    out = matmul(x_st, w_st)
    return out.reshape(*lead, -1).to(x.dtype)


def act_quant(x: torch.Tensor, bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric quantization of activations ``x (..., K)``
    (bfloat16, float16 or float32) at ``bits`` (2 to 8): ``(x_q int8
    (..., K), scale float32 (..., 1))``, scale ``max(max|x| / qmax, 1e-8)``.
    One pass over memory on the card (``kernels/act_quant.py``; not a
    registry kernel: the JAX package leaves it to XLA), the PyTorch chain
    (:func:`act_quant_plain`) on the CPU, the card's checks and ``meta``
    outputs on ``meta``; a ``TypeError`` or ``ValueError`` for what the card
    does not take, on every device.  A row with a NaN or an infinity gets
    the chain's NaN or infinite scale; its int8 values are unspecified where
    ``x / scale`` is NaN, as the chain's are."""
    from repro_torch.kernels import act_quant as _act_quant

    return _act_quant.act_quant(x, bits)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """int8 rows ``x (R, K)`` sorted by group, each times its group's int8
    weight of ``w (E, K, N)`` → int32 ``(R, N)``; group ``e`` holds the rows
    ``offsets[e]`` to ``offsets[e + 1]`` (``offsets (E + 1,)`` int32 on the
    rows' device).  One launch of the bit-sliced GEMM's grouped tensor-core
    path on the card, which reads no count on the host; the plain version on
    the CPU (``kernels/bitslice_matmul.grouped_matmul``; not a registry
    kernel: the JAX package multiplies experts with ``jnp.einsum``)."""
    from repro_torch.kernels import bitslice_matmul as _bm

    return _bm.grouped_matmul(x, w, offsets)


def dequant_matmul_takes(x_q: torch.Tensor, w_q: torch.Tensor) -> bool:
    """Whether :func:`dequant_matmul` takes ``x_q (..., K) @ w_q (K, N)`` as
    they lie (``kernels/bitslice_matmul.dequant_matmul_takes``): int8, on
    the tensor-core path as one slice pair, K within one fold."""
    from repro_torch.kernels import bitslice_matmul as _bm

    return _bm.dequant_matmul_takes(x_q, w_q)


def dequant_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor, w_scale: torch.Tensor,
                   bias: Optional[torch.Tensor] = None, out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """A single-pass quantized product: int8 ``x_q (M, K)`` × int8 ``w_q (K,
    N)`` → ``(M, N)`` of ``out_dtype``, :func:`dequant_plain` of the int32
    sums with the row scales ``x_scale`` (M), the column scales ``w_scale``
    (N) and ``bias`` (N or None).  On the card one launch of the bit-sliced
    GEMM's tensor-core path, which dequantizes in its epilogue, bit for bit;
    the plain product and chain on the CPU; the card's checks and a
    ``meta`` output on ``meta``; every device refuses what the card refuses
    (K % 16, N % 4, K past one fold: ``kernels/bitslice_matmul.dequant_matmul``)."""
    from repro_torch.kernels import bitslice_matmul as _bm

    return _bm.dequant_matmul(x_q, w_q, x_scale, w_scale, bias, out_dtype)


def grouped_dequant_matmul(x_q: torch.Tensor, w_q: torch.Tensor, offsets: torch.Tensor, x_scale: torch.Tensor,
                           w_scale: torch.Tensor, out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """:func:`grouped_matmul` dequantized in its epilogue: each row's scale
    (``x_scale``, R) and its group's column scales (``w_scale``, E × N),
    written as ``out_dtype``, no bias; devices and refusals as
    :func:`dequant_matmul`'s (``kernels/bitslice_matmul.grouped_dequant_matmul``)."""
    from repro_torch.kernels import bitslice_matmul as _bm

    return _bm.grouped_dequant_matmul(x_q, w_q, offsets, x_scale, w_scale, out_dtype)


def ewise_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Elementwise ``x + y`` (matching shapes; ``y`` is cast to ``x``'s
    dtype, int32 wraps)."""
    return dispatch("ewise_add", x, y)


def relu(x: torch.Tensor) -> torch.Tensor:
    """Elementwise ``max(x, 0)``."""
    return dispatch("relu", x)


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    stride: int = 1,
    padding: int = 0,
    x_bits: Optional[int] = None,
    w_bits: Optional[int] = None,
) -> torch.Tensor:
    """2-D convolution ``(N, C, H, W) × (OC, C, KH, KW) → (N, OC, OH, OW)``.

    Integer inputs accumulate in int32 (wrapping), float inputs in float32.
    ``x_bits``/``w_bits`` are the simulator lowering's precision hints; they
    do not change the math and are ignored here.
    """
    return dispatch("conv2d", x, w, stride=stride, padding=padding,
                    x_bits=x_bits, w_bits=w_bits)


def maxpool2d(x: torch.Tensor, *, window: int = 2, stride: Optional[int] = None) -> torch.Tensor:
    """Window max pooling ``(N, C, H, W) → (N, C, OH, OW)`` (no padding;
    ``stride`` defaults to ``window``)."""
    return dispatch("maxpool2d", x, window=window, stride=stride)


def avgpool2d(x: torch.Tensor, *, window: int = 2) -> torch.Tensor:
    """Window average pooling, stride == window; integer inputs floor-divide
    by the window count."""
    return dispatch("avgpool2d", x, window=window)


def global_avgpool(x: torch.Tensor) -> torch.Tensor:
    """Global spatial average ``(N, C, H, W) → (N, C)``; integer inputs
    floor-divide by H·W."""
    return dispatch("global_avgpool", x)


def int_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    x_bits: Optional[int] = None,
    w_bits: Optional[int] = None,
) -> torch.Tensor:
    """Raw-integer ``(M, K) @ (K, N)`` with int32 accumulation (wrapping)."""
    return dispatch("int_matmul", x, w, x_bits=x_bits, w_bits=w_bits)


# ---------------------------------------------------------------------------
# attention decode
# ---------------------------------------------------------------------------


def attention_qk(
    q: torch.Tensor, k: torch.Tensor, *,
    q_bits: Optional[int] = None, k_bits: Optional[int] = None,
    out_bits: Optional[int] = None,
) -> torch.Tensor:
    """Attention scores ``(M, D) q × (T, D) k → (M, T) int32`` (q·Kᵀ,
    wrapping).  ``q_bits``/``k_bits`` are precision hints of the simulator
    lowering; ``out_bits`` is the caller's promise that every score fits that
    many signed bits.  None of them changes the math."""
    return dispatch("attention_qk", q, k, q_bits=q_bits, k_bits=k_bits, out_bits=out_bits)


def softmax_fixedpoint(
    x: torch.Tensor, *, in_frac: int, in_bits: Optional[int] = None,
) -> torch.Tensor:
    """Bit-exact fixed-point row softmax of ``(R, T)`` integers.

    Inputs carry ``in_frac`` fraction bits (at least ``SOFTMAX_F −
    SOFTMAX_K`` = 3, at most 28); outputs are int32 probabilities with
    ``SOFTMAX_F`` = 6 fraction bits, rows summing to about ``2**6``.  The
    recipe is the oracle's (max-subtract, squared-polynomial exp, exact
    floor-division normaliser); ``in_bits`` is a width hint.
    """
    return dispatch("softmax_fixedpoint", x, in_frac=in_frac, in_bits=in_bits)


def attention_pv(
    p: torch.Tensor, v: torch.Tensor, *, shift: Optional[int] = None,
    p_bits: Optional[int] = None, v_bits: Optional[int] = None,
) -> torch.Tensor:
    """Probability-weighted value mix ``(M, T) p × (T, Dv) v → (M, Dv)
    int32``, the int32 accumulator arithmetically shifted right by ``shift``
    (default ``SOFTMAX_F``).  ``shift`` reaches the kernel only when given,
    as in the JAX package, so Program signatures stay equal."""
    kwargs = dict(p_bits=p_bits, v_bits=v_bits)
    if shift is not None:
        kwargs["shift"] = shift
    return dispatch("attention_pv", p, v, **kwargs)


def decode_gemv(
    w: torch.Tensor, x: torch.Tensor, *,
    w_bits: Optional[int] = None, x_bits: Optional[int] = None,
) -> torch.Tensor:
    """Single-token decode projection ``(M, K) w × (K,) x → (M,) int32``
    (wrapping); int8 or int32 operands.  ``w_bits``/``x_bits`` are precision
    hints of the simulator lowering and do not change the math."""
    return dispatch("decode_gemv", w, x, w_bits=w_bits, x_bits=x_bits)


def kv_append(cache: torch.Tensor, new: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """``(T, D)`` cache with the rows selected by the nonzero entries of
    ``onehot (T,)`` replaced by the ``(D,)`` ``new`` row (all-zero selector →
    unchanged), as a new tensor in the cache's dtype; the input cache is
    left as it was."""
    return dispatch("kv_append", cache, new, onehot)


# ---------------------------------------------------------------------------
# H-tree reduction and the RG-LRU scan
# ---------------------------------------------------------------------------


def htree_reduce(x: torch.Tensor) -> torch.Tensor:
    """``(N, D) → (D,)`` log-depth H-tree reduction: adjacent pairs first,
    N a power of two; float32, bfloat16 or int32 (wrapping)."""
    return dispatch("htree_reduce", x)


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """RG-LRU linear recurrence ``h_t = a_t·h_{t-1} + b_t`` over axis 1 of
    float32 ``a, b (B, T, W)`` from ``h0 (B, W)``, each step one fused
    multiply-add."""
    return dispatch("rglru_scan", a, b, h0)


# ---------------------------------------------------------------------------
# the pimsab backend's reports (repro_torch.kernels.pimsab_backend)
# ---------------------------------------------------------------------------


def last_sim_report():
    """The :class:`~repro_torch.kernels.pimsab_backend.SimReport` of the most
    recent pimsab-backend kernel call on this thread (``None`` before any):
    modeled ``total_cycles`` (the overlapped makespan), ``serialized_cycles``,
    ``overlapped_cycles``, energy, the instruction mix, the mapping."""
    from repro_torch.kernels import pimsab_backend

    return pimsab_backend.last_sim_report()


def sim_report_log():
    """Bounded ring of recent pimsab :class:`SimReport` s on this thread,
    oldest first (the last entry is :func:`last_sim_report`)."""
    from repro_torch.kernels import pimsab_backend

    return pimsab_backend.sim_report_log()


def clear_sim_report_log():
    """Empty this thread's :func:`sim_report_log` ring."""
    from repro_torch.kernels import pimsab_backend

    return pimsab_backend.clear_sim_report_log()


def last_verify_report():
    """Static-verifier :class:`~repro_torch.core.compiler.verify.VerifyReport`
    tuple of the most recent pimsab compile on this thread (empty before
    any)."""
    from repro_torch.kernels import pimsab_backend

    return pimsab_backend.last_verify_report()


def profile_timelines(enable: bool = True):
    """Context manager: pimsab timing runs inside it record per-instruction
    scheduling intervals on their :class:`SimReport` (``report.timeline``)."""
    from repro_torch.kernels import pimsab_backend

    return pimsab_backend.profile_timelines(enable)


# Mapping autotuner of the timing model, scope-wide via ``with
# api.tuning(...):`` (the eager pimsab calls inside tune their timing stream).
from repro_torch.core.compiler.autotune import TuneConfig, tuning  # noqa: E402

# Multi-chip scale-out (``api.compile(program, "pimsab", chips=N)`` or the
# explicit cluster/report entry points): sharded bit-exact execution over an
# inter-chip link model, see repro_torch.kernels.multichip.
from repro_torch.core.noc import ChipCluster, ChipLink  # noqa: E402

_MULTICHIP = ("ClusterExecutor", "ClusterReport", "compile_cluster",
              "cluster_timing_report", "weak_scaling_report")


def __getattr__(name: str) -> Any:
    # multichip imports pimsab_backend, which a kernel module importing this
    # module must not reach before it registers (see _ensure_registered):
    # the multichip names resolve on first use
    if name in _MULTICHIP:
        from repro_torch.kernels import multichip

        return getattr(multichip, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
