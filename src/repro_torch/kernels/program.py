"""Program API of the PyTorch port: trace → compile once → execute.

The port's counterpart of the JAX package's ``kernels/program.py``:

* :func:`trace` wraps a function of registry-kernel calls; calling the traced
  function captures the calls into a :class:`Program` — a dataflow DAG over
  slots (the leaves of the call's arguments), captured constants and node
  outputs, in trace order (topological by construction).  Each call's output
  shape and dtype come from running the kernel's plain oracle on ``meta``
  tensors, so tracing reads no values and launches nothing.
* :func:`compile_program` (``api.compile``) returns a cached
  :class:`Executor` for a Program, the counterpart of the JAX package's
  compiled executable, for one of two targets:

  - the device (``backend`` ``None`` outside any scope): on the card the
    Executor captures the ops once into a CUDA graph and replays it on every
    later call; on the CPU it replays the ops eagerly through
    ``api.dispatch``, which runs the plain versions.  Such an Executor runs
    its ops on their device in any backend scope (``api.on_device``);
  - ``"pimsab"`` (``backend="pimsab"``, or any compile inside
    ``api.use_backend("pimsab")``): the chain becomes one
    ``tensor_dsl.WorkloadGraph`` compiled jointly
    (:func:`repro_torch.kernels.pimsab_backend.compile_traced_program`):
    integer producer→consumer intermediates stay CRAM-resident and the
    DRAM store/load pair at the boundary is elided.  The Executor runs the
    fused stream on the host's functional simulator every call, in any
    scope, and carries the aggregated ``SimReport``, the verifier reports
    and the bound ``ResidentState`` handles (``states=``).

* The compile cache is keyed on the Program's signature — kernel names,
  operand references, static kwargs, output and slot avals, both argument
  structures, the output references and a content fingerprint per captured
  constant — equal, field for field, to the JAX package's for the same
  traced function, plus the target: the constants' devices for the device
  target, and, as the JAX package keys it, the functional machine config,
  ``verify``, the state specs and the resolved ``TuneConfig`` for pimsab.
  :func:`compile_cache_info` counts hits and misses.

Argument structures are flattened as ``jax.tree_util`` does: dict keys in
sorted order, ``None`` a node without leaves, and registered classes
(:func:`register_pytree_node`, e.g. ``SlicedTensor``) by their
``tree_flatten``; slot numbers therefore match the JAX package's.  Avals are
``(shape, numpy dtype name)`` pairs such as ``((4, 8), "int32")``.

``compile_program(..., chips=N)`` or ``cluster=`` on ``"pimsab"`` shards the
program across a ``ChipCluster`` instead
(:func:`repro_torch.kernels.multichip.compile_cluster`), and returns a
``ClusterExecutor`` whose results are bit-equal to the one-chip Executor's.
"""
from __future__ import annotations

import contextvars
import hashlib
import threading
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs

__all__ = [
    "TraceError",
    "ProgramValue",
    "OpCall",
    "Program",
    "TreeDef",
    "register_pytree_node",
    "tree_flatten",
    "tree_unflatten",
    "TracedFunction",
    "trace",
    "ResidentState",
    "Executor",
    "compile_program",
    "compile_cache_info",
    "clear_compile_cache",
    "cached_executable",
    "CacheInfo",
]


class TraceError(TypeError):
    """A traced function did something the Program IR cannot capture."""


# ---------------------------------------------------------------------------
# argument structures (the port's pytree)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TreeDef:
    """The structure of a flattened argument tree: ``kind`` is ``"leaf"``,
    ``"none"``, ``tuple``, ``list``, ``dict`` (``aux``: the sorted keys), a
    namedtuple class or a registered class (``aux``: its static data)."""

    kind: Any
    aux: Any
    children: Tuple["TreeDef", ...]


_LEAF = TreeDef("leaf", None, ())
_NODES: set = set()


def register_pytree_node(cls):
    """Class decorator: flatten ``cls`` instances as tree nodes, through
    ``obj.tree_flatten() -> (children, aux)`` and
    ``cls.tree_unflatten(aux, children)``."""
    _NODES.add(cls)
    return cls


def tree_flatten(tree: Any) -> Tuple[List[Any], TreeDef]:
    """The leaves of ``tree`` in ``jax.tree_util`` order, and its structure."""
    leaves: List[Any] = []

    def walk(x: Any) -> TreeDef:
        if x is None:
            return TreeDef("none", None, ())
        if isinstance(x, dict):
            keys = tuple(sorted(x))
            return TreeDef(dict, keys, tuple(walk(x[k]) for k in keys))
        if isinstance(x, (tuple, list)):
            kind = type(x) if hasattr(x, "_fields") else (tuple if isinstance(x, tuple) else list)
            return TreeDef(kind, None, tuple(walk(c) for c in x))
        if type(x) in _NODES:
            children, aux = x.tree_flatten()
            return TreeDef(type(x), aux, tuple(walk(c) for c in children))
        leaves.append(x)
        return _LEAF

    return leaves, walk(tree)


def tree_unflatten(treedef: TreeDef, leaves: List[Any]) -> Any:
    """Rebuild the tree of ``treedef`` around ``leaves``."""
    it = iter(leaves)

    def build(td: TreeDef) -> Any:
        if td.kind == "leaf":
            return next(it)
        if td.kind == "none":
            return None
        kids = [build(c) for c in td.children]
        if td.kind is dict:
            return dict(zip(td.aux, kids))
        if td.kind is list:
            return kids
        if td.kind is tuple:
            return tuple(kids)
        if td.kind in _NODES:
            return td.kind.tree_unflatten(td.aux, kids)
        return td.kind(*kids)  # namedtuple

    return build(treedef)


# ---------------------------------------------------------------------------
# IR
# ---------------------------------------------------------------------------

# input references: ("slot", i) — i-th leaf of the call arguments;
# ("node", i) — output of the i-th captured kernel call;
# ("const", i) — a tensor captured from the traced function's closure.
InRef = Tuple[str, int]
Aval = Tuple[Tuple[int, ...], str]  # (shape, numpy dtype name)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


@dataclass(frozen=True)
class OpCall:
    """One captured registry-kernel call."""

    kernel: str
    inputs: Tuple[InRef, ...]
    kwargs: Tuple[Tuple[str, Any], ...]
    out_aval: Aval


@dataclass(frozen=True)
class Program:
    """A traced sequence of registry kernel calls (the compile unit)."""

    name: str
    ops: Tuple[OpCall, ...]
    n_slots: int
    slot_avals: Tuple[Aval, ...]
    consts: Tuple[torch.Tensor, ...]
    in_tree: TreeDef  # structure of (args, kwargs)
    out_tree: TreeDef
    out_refs: Tuple[InRef, ...]

    @property
    def kernels(self) -> Tuple[str, ...]:
        return tuple(op.kernel for op in self.ops)

    def const_fingerprints(self) -> Tuple[Tuple[Tuple[int, ...], str, str], ...]:
        """``(shape, dtype, sha1 of the bytes)`` per captured constant, as
        the JAX package computes it (a constant on the card is copied to the
        host once, here)."""
        return tuple(
            (tuple(c.shape), _dtype_name(c.dtype),
             hashlib.sha1(np.ascontiguousarray(c.detach().cpu().numpy())).hexdigest())
            for c in self.consts
        )

    def signature(self) -> Tuple:
        """Hashable compile key: everything replay depends on except the
        slot values — ops, slot avals, both argument structures, the output
        refs and the constants' fingerprints.  Memoized per Program."""
        sig = getattr(self, "_signature_cache", None)
        if sig is None:
            sig = (self.name, self.ops, self.slot_avals, self.in_tree,
                   self.out_tree, self.out_refs, self.const_fingerprints())
            object.__setattr__(self, "_signature_cache", sig)
        return sig


class ProgramValue:
    """Placeholder for a kernel output inside :func:`trace`.

    It can only be passed to another registry kernel or returned; any other
    use (arithmetic, a torch function, an attribute such as ``.to``,
    materialization) raises :class:`TraceError` naming the capture position.
    """

    def __init__(self, node: int, aval: Aval, kernel: str):
        self._node = node
        self._aval = aval
        self._kernel = kernel

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._aval[0]

    @property
    def dtype(self) -> torch.dtype:
        return _torch_dtype(self._aval[1])

    @property
    def ndim(self) -> int:
        return len(self._aval[0])

    def _refuse(self, what: str):
        raise TraceError(
            f"the output of kernel {self._kernel!r} (node {self._node}) is a "
            f"program-trace placeholder and does not support {what}; inside "
            "api.trace(...) kernel outputs can only feed other registry "
            "kernels (or be returned). Compute everything else outside the "
            "traced function."
        )

    def __array__(self, *a, **k):
        self._refuse("materialization")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        pv = next(a for a in args if isinstance(a, ProgramValue))
        pv._refuse(f"torch function {getattr(func, '__name__', func)!r}")

    def __getattr__(self, name):
        raise TraceError(
            f"the output of kernel {self._kernel!r} (node {self._node}) is a "
            f"program-trace placeholder (no attribute {name!r}); inside "
            "api.trace(...) kernel outputs can only feed other registry "
            "kernels or be returned."
        )


def _refuser(op: str):
    def refuse(self, *a):
        self._refuse(f"arithmetic (__{op}__)")
    return refuse


for _op in ("add", "radd", "sub", "rsub", "mul", "rmul", "truediv",
            "rtruediv", "matmul", "neg", "lt", "le", "gt", "ge"):
    setattr(ProgramValue, f"__{_op}__", _refuser(_op))
del _op


def _aval_of(x: Any) -> Aval:
    if isinstance(x, ProgramValue):
        return x._aval
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), _dtype_name(x.dtype))
    a = np.asarray(x)
    return (tuple(a.shape), str(a.dtype))


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------


class _TraceCtx:
    def __init__(self, name: str, leaves: List[Any]):
        self.name = name
        self.slots_by_id = {id(l): i for i, l in enumerate(leaves)}
        self.slot_avals = tuple(_aval_of(l) for l in leaves)
        self.ops: List[OpCall] = []
        self.consts: List[Any] = []  # original objects (keeps ids alive)
        self.consts_by_id: Dict[int, int] = {}

    def _ref(self, a: Any) -> InRef:
        if isinstance(a, ProgramValue):
            return ("node", a._node)
        aid = id(a)
        if aid in self.slots_by_id:
            return ("slot", self.slots_by_id[aid])
        if aid not in self.consts_by_id:
            self.consts_by_id[aid] = len(self.consts)
            self.consts.append(a)
        return ("const", self.consts_by_id[aid])

    @staticmethod
    def _freeze_kwargs(kw: Optional[Dict[str, Any]]) -> Tuple[Tuple[str, Any], ...]:
        items = tuple(sorted((kw or {}).items()))
        try:
            hash(items)
        except TypeError:
            raise TraceError(
                f"kernel kwargs {kw!r} are not hashable — program signatures "
                "require static (hashable) kwargs"
            ) from None
        return items

    def record(self, kernel: str, args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> ProgramValue:
        from repro_torch.kernels import api

        refs = tuple(self._ref(a) for a in args)
        # meta stand-ins for shape inference (node refs use the recorded aval)
        metas = []
        for (kind, i), a in zip(refs, args):
            shape, dtype = self.ops[i].out_aval if kind == "node" else _aval_of(a)
            metas.append(torch.empty(shape, dtype=_torch_dtype(dtype), device="meta"))
        out = api.get_kernel(kernel).oracle(*metas, **(kwargs or {}))
        aval = (tuple(out.shape), _dtype_name(out.dtype))
        self.ops.append(OpCall(kernel=kernel, inputs=refs,
                               kwargs=self._freeze_kwargs(kwargs), out_aval=aval))
        return ProgramValue(len(self.ops) - 1, aval, kernel)


_trace_ctx: contextvars.ContextVar[Optional[_TraceCtx]] = contextvars.ContextVar(
    "repro_torch_program_trace_ctx", default=None
)


def active_trace() -> Optional[_TraceCtx]:
    """The trace context ``api.dispatch`` must record into (None = eager)."""
    return _trace_ctx.get()


class TracedFunction:
    """``trace(fn)`` wrapper: call it like ``fn``.  Each call traces ``fn``
    anew and runs the Program through its cached :class:`Executor`."""

    def __init__(self, fn: Callable[..., Any], name: Optional[str] = None):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "program")
        self._programs: Dict[Tuple, Program] = {}
        self._lock = threading.Lock()

    def trace(self, *args, **kwargs) -> Program:
        """Capture a fresh Program for these arguments (no caching)."""
        leaves, in_tree = tree_flatten((args, kwargs))
        return self._trace(leaves, in_tree, args, kwargs)

    def _trace(self, leaves, in_tree, args, kwargs) -> Program:
        ctx = _TraceCtx(self.name, leaves)
        token = _trace_ctx.set(ctx)
        try:
            result = self.fn(*args, **kwargs)
        finally:
            _trace_ctx.reset(token)
        if not ctx.ops:
            raise TraceError(
                f"trace({self.name}) captured no registry kernel calls — "
                "nothing to compile; call kernels via repro_torch.kernels.api"
            )
        out_leaves, out_tree = tree_flatten(result)
        out_refs = tuple(ctx._ref(l) for l in out_leaves)
        return Program(
            name=self.name,
            ops=tuple(ctx.ops),
            n_slots=len(leaves),
            slot_avals=ctx.slot_avals,
            consts=tuple(c if isinstance(c, torch.Tensor) else torch.as_tensor(np.asarray(c))
                         for c in ctx.consts),
            in_tree=in_tree,
            out_tree=out_tree,
            out_refs=out_refs,
        )

    def program_for(self, *args, **kwargs) -> Program:
        """The (cached) Program this call signature maps to.

        The per-signature trace cache assumes captured constants are
        stable; use it for introspection or when you own that guarantee —
        ``__call__`` re-traces instead, so it never replays stale constants.
        """
        leaves, in_tree = tree_flatten((args, kwargs))
        key = (in_tree, tuple(_aval_of(l) for l in leaves))
        with self._lock:
            prog = self._programs.get(key)
        if prog is None:
            prog = self._trace(leaves, in_tree, args, kwargs)
            with self._lock:
                prog = self._programs.setdefault(key, prog)
        return prog

    def __call__(self, *args, **kwargs):
        # Re-trace on every call, as the JAX package does: a tensor computed
        # from the arguments inside fn is captured as a constant, so a cached
        # trace would replay its old value.  Fresh constants change the
        # signature's fingerprint and so reach a fresh Executor.
        prog = self.trace(*args, **kwargs)
        ex = compile_program(prog)
        leaves, _ = tree_flatten((args, kwargs))
        call = obs.call("program.call", program=prog.name) if obs.recording() else obs.NULL
        with call:
            out = ex._execute_leaves(leaves)
            call.note("route", ex.replay)
            return out


def trace(fn: Callable[..., Any], *, name: Optional[str] = None) -> TracedFunction:
    """Wrap ``fn`` (a chain of ``repro_torch.kernels.api`` kernel calls) so
    each call is captured into a Program and run through a cached
    :class:`Executor`."""
    return TracedFunction(fn, name=name)


# ---------------------------------------------------------------------------
# executors + compile cache
# ---------------------------------------------------------------------------


class ResidentState:
    """A persistent integer ``(rows, fields)`` tensor stored at ``prec`` bits
    per field, which the pimsab backend keeps CRAM-resident across program
    executions — the serve engine's KV cache.

    Bind it to a traced program's slot with
    ``compile_program(prog, "pimsab", states={slot_index: handle})``: the
    compiler reserves a wordline region for it, pins the slot's
    ``kv_append`` updater to that region (the append updates CRAM in place,
    no DRAM traffic for the cache), and the Executor seeds and harvests the
    region around each run.  ``.value`` (an int64 CPU tensor) mirrors the
    logical cache after the most recent execution, so parking a request's
    cache is reading and reassigning ``.value``.  The slot still takes an
    aval-matching argument at call time (:meth:`placeholder`), whose
    contents are ignored.  When the mapping layer declines residency (see the
    compile's N-PLAN notes), the value streams through DRAM instead: the
    same results."""

    def __init__(self, name: str, shape: Tuple[int, int], prec: int,
                 dtype: str = "int8", init: Optional[Any] = None):
        if len(shape) != 2:
            raise ValueError(f"ResidentState {name!r} must be 2-D (rows, fields)")
        self.name = str(name)
        self.shape = (int(shape[0]), int(shape[1]))
        self.prec = int(prec)
        self.dtype = _torch_dtype(dtype)
        self.value = (
            torch.zeros(self.shape, dtype=torch.int64) if init is None
            else torch.as_tensor(init).to(torch.int64).clone()
        )
        if tuple(self.value.shape) != self.shape:
            raise ValueError(
                f"ResidentState {name!r} init shape {tuple(self.value.shape)} != {self.shape}"
            )

    def spec(self) -> Tuple[str, Tuple[int, int], int]:
        """The hashable compile-key identity: (name, shape, prec)."""
        return (self.name, self.shape, self.prec)

    def placeholder(self) -> torch.Tensor:
        """An aval-matching argument for the state's slot."""
        return torch.zeros(self.shape, dtype=self.dtype)

    def to_array(self) -> torch.Tensor:
        """The logical cache at its declared dtype (a copy)."""
        return self.value.to(self.dtype)

    def __repr__(self) -> str:
        return f"ResidentState({self.name!r}, shape={self.shape}, prec={self.prec})"


@dataclass(frozen=True)
class CacheInfo:
    """Compile-cache counters plus one record per cached Executor,
    ``{"name", "backend", "kernels", "verify"}``.  For a pimsab Executor
    ``verify`` summarizes the static verifier of its compile — ``ok``, the
    error and warning counts and the ``N-PLAN`` notes on why residency or
    double buffering was declined — and ``autotune`` holds the tuner's
    provenance when the compile was tuned; ``verify`` is ``None`` for a
    device Executor and for a compile with ``verify=False``."""

    hits: int
    misses: int
    size: int
    entries: Tuple[Dict[str, Any], ...] = ()


# the device type whose operands an Executor captures into a graph (a test
# seam, with _CudaGraph: the CPU tests drive the replay rules through a fake)
_GRAPH_DEVICE = "cuda"
GRAPH_REASON = "replays the CUDA graph captured at its first call on this device and leaf layout"
PIMSAB_REASON = ("runs the fused WorkloadGraph on the host's functional simulator every call; "
                 "a pimsab Executor never captures a CUDA graph")


class _CudaGraph:
    """One CUDA graph of a program's ops on ``device``: the seam between the
    :class:`Executor` and ``torch.cuda``, which the CPU tests replace."""

    @staticmethod
    def capturing() -> bool:
        """Whether the current stream is being captured into a graph."""
        return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()

    def __init__(self, device: torch.device):
        self.device = device
        self.graph = torch.cuda.CUDAGraph()
        self._raw = self._stream = None  # the stream of the last call

    def capture(self, fn: Callable[[], List[Any]]) -> List[Any]:
        """Capture ``fn()`` (nothing runs) on a side stream; returns its
        outputs, the graph's own buffers, which each replay rewrites."""
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.device(self.device), torch.cuda.stream(stream):
            # thread_local: another thread's CUDA calls do not break this capture
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                outputs = fn()
            except BaseException:
                try:
                    self.graph.capture_end()
                except RuntimeError:  # the capture was invalidated by the error being raised
                    pass
                raise
            self.graph.capture_end()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        return outputs

    def follow_last_call(self) -> None:
        """Order this call after the last one, which may have run on another
        stream: both use the same static buffers."""
        raw = torch._C._cuda_getCurrentRawStream(self.device.index)
        if raw != self._raw:
            stream = torch.cuda.current_stream(self.device)
            if self._stream is not None:
                stream.wait_stream(self._stream)
            self._raw, self._stream = raw, stream

    def replay(self) -> None:
        self.graph.replay()

    def reset(self) -> None:
        self.graph.reset()


@dataclass
class _GraphReplay:
    """A captured program: the static input buffers its graph reads (one per
    slot leaf, of the leaf's shape, dtype and layout), the graph, its output
    buffers and the launches it makes (``api.LaunchLog``)."""

    graph: Any
    inputs: List[torch.Tensor]
    outputs: List[torch.Tensor]
    log: Any

    def run(self, leaves: List[torch.Tensor]) -> List[torch.Tensor]:
        from repro_torch.kernels import api

        with obs.span("program.copy_in"):
            self.graph.follow_last_call()
            torch._foreach_copy_(self.inputs, leaves)
        with obs.span("program.replay"):
            self.graph.replay()
        with obs.span("program.copy_out"):
            # fresh tensors, as a jitted call returns: the next replay rewrites the buffers
            outputs = [o.clone() for o in self.outputs]
            api.replay_launches(self.log)
        return outputs


def _graph_device(leaves: List[Any], consts: Tuple[torch.Tensor, ...]) -> Tuple[Optional[torch.device], str]:
    """The device on which a program over these operands is captured into a
    graph, or ``None`` and the reason its ops replay eagerly instead."""
    if not all(isinstance(l, torch.Tensor) for l in leaves):
        return None, "a leaf is not a tensor: only tensors can be copied into a graph's input buffers"
    devices = {t.device for t in (*leaves, *consts)}
    if len(devices) != 1 or next(iter(devices)).type != _GRAPH_DEVICE:
        if devices == {torch.device("cpu")}:
            return None, "the operands lie on the CPU, where there are no CUDA graphs: the plain versions run eagerly"
        return None, f"the operands lie on {sorted(map(str, devices))}, not on one CUDA device"
    if _CudaGraph.capturing():
        return None, ("the current stream is being captured into the caller's graph: the ops replay "
                      "eagerly into that capture")
    return next(iter(devices)), GRAPH_REASON


class Executor:
    """A compiled Program.  Call it with the argument structure and leaf
    avals the traced function took.

    On CUDA operands the first call for a device and layout of the leaves
    replays the ops eagerly through ``api.dispatch`` (which builds the
    kernels' libraries and launch plans and the p·V ticket) and then captures
    them into one CUDA graph that reads static input buffers the Executor
    owns.  Every later call copies the leaves into those buffers, replays
    the graph and returns fresh copies of its outputs; the graph's launches
    are added to ``api.launch_counts`` and its launch records restored on
    every replay.  The ops replay eagerly instead, each on the device its
    operands lie on, when the operands lie on the CPU, when the current
    stream is already being captured (the ops then go into the caller's
    graph), and when the capture raised (then for good on that signature,
    with one warning).  ``replay`` (``"graph"`` or ``"eager"``) and
    ``replay_reason`` tell the route of the last call and why.

    With span recording on (:mod:`repro_torch.obs`, off by default) a call
    records ``program.call`` (ids ``program`` and ``route``) around
    ``program.check`` (flatten and aval check) and the route's spans:
    ``program.eager``; ``program.capture`` after the first call's eager
    run; or ``program.copy_in``, ``program.replay`` and ``program.copy_out``.

    A pimsab Executor (``backend == "pimsab"``) takes neither route: every
    call runs ``pimsab_backend.execute_traced_program`` on the host
    (``replay`` is ``"pimsab"``), whatever the scope and wherever the leaves
    lie, and a call while the current CUDA stream is captured raises
    ``api.PimsabTracerError``.  It carries the aggregated ``report``
    (a ``SimReport``), the ``verify_reports`` of its compile and the
    ``states`` it seeds and harvests (:meth:`bind_states`).
    """

    def __init__(self, program: Program, backend: str, run: Callable[[List[Any]], Any],
                 report: Optional[Any] = None, verify_reports: Tuple[Any, ...] = ()):
        self.program = program
        self.backend = backend
        self._eager = run
        self.report = report  # aggregated SimReport (pimsab), else None
        self.verify_reports = verify_reports  # VerifyReports (pimsab, verify=True)
        self.states: Optional[Dict[int, ResidentState]] = None
        # (device, leaf strides) → its _GraphReplay, or why its capture failed
        self._graphs: Dict[Tuple, Any] = {}
        self._lock = threading.Lock()  # the static buffers serve one call at a time
        self.replay = "eager"
        self.replay_reason = "not called yet"

    def bind_states(self, states: Dict[int, ResidentState]) -> None:
        """Swap in the ResidentState handles the next calls seed and harvest.

        The compiled artifact is keyed on state specs, not handles, so one
        Executor serves many requests: rebind each request's caches before
        its step (spec-compatible handles only; the run checks them)."""
        self.states = dict(states)

    def __call__(self, *args, **kwargs):
        call = obs.call("program.call", program=self.program.name) if obs.recording() else obs.NULL
        with call:
            with obs.span("program.check"):
                leaves = self._check(args, kwargs)
            out = self._execute_leaves(leaves)
            call.note("route", self.replay)
            return out

    def _check(self, args, kwargs) -> List[Any]:
        """The call's leaves, once their structure and avals are the traced ones."""
        leaves, in_tree = tree_flatten((args, kwargs))
        if in_tree != self.program.in_tree:
            raise TypeError(
                f"Executor({self.program.name!r}) called with a different "
                f"argument structure than it was traced with:\n"
                f"  traced: {self.program.in_tree}\n  got:    {in_tree}"
            )
        avals = tuple(_aval_of(l) for l in leaves)
        if avals != self.program.slot_avals:
            diffs = [
                f"  leaf {i}: traced {t}, got {g}"
                for i, (t, g) in enumerate(zip(self.program.slot_avals, avals))
                if t != g
            ]
            raise TypeError(
                f"Executor({self.program.name!r}) called with different leaf "
                "shapes/dtypes than it was compiled for (compile a new "
                "program for this signature):\n" + "\n".join(diffs)
            )
        return leaves

    def _execute_leaves(self, leaves: List[Any]):
        return tree_unflatten(self.program.out_tree, self._run(leaves))

    def _run(self, leaves: List[Any]) -> List[Any]:
        if self.backend == "pimsab":
            return self._run_pimsab(leaves)
        device, reason = _graph_device(leaves, self.program.consts)
        if device is None:
            self.replay, self.replay_reason = "eager", reason
            return self._eager_call(leaves)
        key = (device, tuple(l.stride() for l in leaves))
        with self._lock:
            replay = self._graphs.get(key)
            if replay is None:
                outputs = self._eager_call(leaves)
                with obs.span("program.capture"):
                    replay = self._graphs[key] = self._capture(device, leaves)
            elif isinstance(replay, _GraphReplay):
                outputs = replay.run(leaves)
            else:
                outputs = self._eager_call(leaves)
            if isinstance(replay, _GraphReplay):
                self.replay, self.replay_reason = "graph", GRAPH_REASON
            else:
                self.replay, self.replay_reason = "eager", replay
            return outputs

    def _eager_call(self, leaves: List[Any]) -> List[Any]:
        with obs.span("program.eager"):
            return self._eager(leaves)

    def _run_pimsab(self, leaves: List[Any]) -> List[Any]:
        from repro_torch.kernels import api

        if _CudaGraph.capturing():
            raise api.PimsabTracerError(
                f"Executor({self.program.name!r}) runs on the 'pimsab' backend, which copies "
                "its operands to the host; a CUDA graph capture on the current stream cannot "
                "hold that: call it outside the capture"
            )
        self.replay, self.replay_reason = "pimsab", PIMSAB_REASON
        return self._eager(leaves)

    def _capture(self, device: torch.device, leaves: List[torch.Tensor]):
        """Capture the ops over static copies of ``leaves``: a
        :class:`_GraphReplay`, or the text of the error the capture raised."""
        from repro_torch.kernels import _build, api

        inputs = [torch.empty_like(l) for l in leaves]  # keeps a dense leaf's strides
        graph = _CudaGraph(device)
        try:
            with api.recording_launches() as log:
                outputs = graph.capture(lambda: self._eager(inputs))
        except _build.KernelLaunchError:
            raise
        except RuntimeError as exc:  # e.g. an op that reads back to the host
            reason = f"the CUDA graph capture raised {type(exc).__name__}: {exc}"
            warnings.warn(f"Executor({self.program.name!r}): {reason}; this signature replays eagerly",
                          RuntimeWarning, stacklevel=4)
            return reason
        return _GraphReplay(graph, inputs, outputs, log)

    def _drop_graphs(self) -> None:
        with self._lock:
            for replay in self._graphs.values():
                if isinstance(replay, _GraphReplay):
                    replay.graph.reset()
            self._graphs.clear()


_cache_lock = threading.Lock()
_cache: Dict[Any, Any] = {}
_cache_meta: Dict[Any, Dict[str, Any]] = {}
_hits = 0
_misses = 0


def compile_cache_info() -> CacheInfo:
    """Hit/miss/size counters of the global compile cache, plus one record
    per cached executable (see :class:`CacheInfo`)."""
    with _cache_lock:
        return CacheInfo(
            hits=_hits, misses=_misses, size=len(_cache),
            entries=tuple(dict(m) for m in _cache_meta.values()),
        )


def clear_compile_cache() -> None:
    """Empty the global compile cache and reset its hit/miss counters; the
    cached Executors drop their CUDA graphs and the graphs' memory."""
    global _hits, _misses
    with _cache_lock:
        for artifact in _cache.values():
            if isinstance(artifact, Executor):
                artifact._drop_graphs()
        _cache.clear()
        _cache_meta.clear()
        _hits = 0
        _misses = 0


def cached_executable(key: Any, build: Callable[[], Any],
                      meta: Optional[Callable[[Any], Dict[str, Any]]] = None) -> Any:
    """Compile once: return the cached artifact for ``key`` or build it
    (outside the lock).  ``meta``, if given, maps the freshly built artifact
    to the :class:`CacheInfo` entry recorded for it."""
    global _hits, _misses
    with _cache_lock:
        if key in _cache:
            _hits += 1
            return _cache[key]
    artifact = build()
    with _cache_lock:
        if key in _cache:  # lost a race: keep the first, still a miss for us
            _misses += 1
            return _cache[key]
        _misses += 1
        _cache[key] = artifact
        if meta is not None:
            _cache_meta[key] = meta(artifact)
    return artifact


def _eager_run(program: Program) -> Callable[[List[Any]], List[Any]]:
    """Replay the program's ops one by one through ``api.dispatch``, outside
    any backend scope (``api.on_device``: on their device): the Executor's
    eager route, and what its CUDA graph captures."""
    from repro_torch.kernels import api

    def run(leaves: List[Any]) -> List[Any]:
        env: Dict[int, Any] = {}

        def resolve(ref: InRef) -> Any:
            kind, i = ref
            if kind == "slot":
                return leaves[i]
            if kind == "const":
                return program.consts[i]
            return env[i]

        with api.on_device():
            for idx, op in enumerate(program.ops):
                env[idx] = api.dispatch(op.kernel, *(resolve(r) for r in op.inputs), **dict(op.kwargs))
        return [resolve(r) for r in program.out_refs]

    return run


def _executor_meta(ex: Executor) -> Dict[str, Any]:
    """The :class:`CacheInfo` entry for a freshly compiled Executor: identity
    plus the static-verifier summary (error/warning counts and the N-PLAN
    notes recording why residency/double-buffering was declined)."""
    entry: Dict[str, Any] = {"name": ex.program.name, "backend": ex.backend,
                             "kernels": list(ex.program.kernels), "verify": None}
    if ex.verify_reports:
        entry["verify"] = {
            "ok": all(r.ok for r in ex.verify_reports),
            "errors": sum(len(r.errors) for r in ex.verify_reports),
            "warnings": sum(len(r.warnings) for r in ex.verify_reports),
            "notes": sorted({(d.node, d.message) for r in ex.verify_reports for d in r.notes}),
        }
    if ex.report is not None and getattr(ex.report, "autotune", None):
        entry["autotune"] = dict(ex.report.autotune)
    return entry


def compile_program(program: Program, backend: Optional[str] = None, *,
                    verify: bool = True,
                    states: Optional[Dict[int, ResidentState]] = None,
                    tune: Any = None,
                    chips: Optional[int] = None,
                    cluster: Any = None,
                    plan: str = "auto") -> Executor:
    """Return the :class:`Executor` of ``program`` for ``backend`` (default:
    the active scope), cached so that an identical second compile is a
    cache hit.

    ``backend`` ``None`` outside any scope gives a device Executor, cached
    on the signature and the constants' devices: it replays a CUDA graph of
    the program on the card and the ops eagerly on the CPU (see
    :class:`Executor`), in any backend scope; ``verify`` and ``tune`` do
    nothing there, and ``states`` raises.

    ``"pimsab"`` (explicit, or any compile inside ``api.use_backend(
    "pimsab")``) lowers the program into one fused ``WorkloadGraph``
    (:func:`repro_torch.kernels.pimsab_backend.compile_traced_program`),
    cached as the JAX package caches it, on (signature, backend, functional
    machine config, ``verify``, state specs, resolved ``TuneConfig``).
    ``verify=True`` runs the static verifier over both fused streams and
    raises ``VerifierError`` on any error; its summary lands on the cache
    entry.  ``states`` maps a slot index to a :class:`ResidentState`, whose
    cache stays CRAM-resident across calls; spec-identical handles share
    one Executor, which :meth:`Executor.bind_states` (done here) rebinds.
    ``tune`` opts the timing lowering into the mapping autotuner: ``True``,
    a ``TuneConfig``, ``False`` (off) or ``None`` (inherit an enclosing
    ``api.tuning`` scope).

    ``chips``/``cluster`` (pimsab only) compile the program for a multi-chip
    :class:`~repro_torch.core.noc.ChipCluster` instead of one chip: the
    returned :class:`~repro_torch.kernels.multichip.ClusterExecutor` runs
    the sharded plan bit-exactly against the one-chip result.  ``plan``
    forces ``"tp"``/``"pp"`` or leaves the cost model to choose (``"auto"``,
    the default).  ``chips=1`` is the one-chip Executor; the device path
    (``backend`` ``None``) and ``states`` with a cluster raise
    ``NotImplementedError``, as the JAX package does.
    """
    from repro_torch.kernels import api

    backend = backend or api.current_backend()
    if backend is not None and backend not in api.BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}: the port has no backend scope but "
            f"{api.BACKENDS}; an Executor runs each op on the device its operands lie on"
        )
    if cluster is not None or (chips is not None and int(chips) != 1):
        if backend != "pimsab":
            raise NotImplementedError(
                "chips/cluster sharding is a pimsab-backend concept; the "
                "device Executor replays the whole program on one device"
            )
        if states:
            raise NotImplementedError(
                "ResidentState stays CRAM-resident on one chip and does not "
                "shard across a ChipCluster; serve on chips=1"
            )
        from repro_torch.kernels import multichip

        return multichip.compile_cluster(
            program, chips=chips, cluster=cluster,
            plan=plan, verify=verify, tune=tune,
        )
    key: Tuple = ("program", program.signature(), backend)
    if backend == "pimsab":
        from repro_torch.core.compiler import autotune
        from repro_torch.kernels import pimsab_backend as pb

        tc = autotune.resolve(tune) if tune is not None else autotune.active()
        state_specs = tuple(sorted((slot, st.spec()) for slot, st in (states or {}).items()))
        key = key + (pb._functional_cfg(), bool(verify), state_specs, tc)

        def build() -> Executor:
            compiled = pb.compile_traced_program(
                program, verify=verify,
                state_slots={slot: st.spec() for slot, st in states.items()} if states else None,
                tune=tc if tc is not None else False,
            )
            ex = Executor(program, backend, run=None,  # set below: the run reads ex.states per call
                          report=compiled.report, verify_reports=compiled.verify_reports)
            ex._eager = lambda leaves: pb.execute_traced_program(compiled, leaves, states=ex.states)
            return ex
    else:
        if states:
            raise NotImplementedError(
                "ResidentState is a pimsab-backend concept; the device Executor "
                "replays the whole chain functionally on the operands' device"
            )
        key = key + (tuple(str(c.device) for c in program.consts),)

        def build() -> Executor:
            return Executor(program, "eager", run=_eager_run(program))

    ex = cached_executable(key, build, meta=_executor_meta)
    if states is not None:
        ex.bind_states(states)
    return ex
