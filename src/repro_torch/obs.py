"""Spans and counters of the port's own layers.

**Spans** say where the host spends a call's time: ``with obs.span(name):``
around a piece of work.  Recording is off by default and switched by a call,
:func:`enable` and :func:`disable`.  Off, :func:`span` tests one flag and
returns one shared null context (:data:`NULL`): it allocates nothing,
records nothing and calls nothing in torch.  On, each span records its name,
its start and end on ``time.perf_counter_ns()``, its parent (the innermost
span open on the same thread) and the call it serves.  :func:`call` opens a
span that also opens a call, with ids (``obs.call("serve.run",
requests=(...))``): its sequence number is the call id, and the spans inside
it share that id; ``note(key, value)`` adds an id once it is known.  A
caller builds a call's ids only while :func:`recording`, and otherwise
enters :data:`NULL`, so that the off path builds nothing.  :func:`record`
reads the spans back.  The record is bounded: :func:`enable` preallocates
:data:`CAPACITY` slots in flat arrays, and once they are full each new span
takes the slot of the oldest, which is counted as dropped.  While a
``torch.profiler`` session records, and only then, each recorded span is
also a profiler range (``record_function``) named ``repro_torch.<name>``, so
the device trace places the program's spans on the clock of the device's
operations.

The spans the port records:

* ``program.call`` (ids: ``program``, ``route``) around an ``Executor``
  call, inside it ``program.check`` (flatten and aval check) and one of
  ``program.eager`` (the ops replayed eagerly), ``program.capture`` (the
  CUDA-graph capture), or ``program.copy_in`` (the leaves copied into the
  graph's buffers), ``program.replay`` (the graph's replay) and
  ``program.copy_out`` (the outputs cloned, the graph's launches counted);
* ``serve.run`` (ids: ``requests``, the request ids) around
  ``ServeEngine.run``, inside it ``serve.prompt_batch``, ``serve.prefill``,
  ``serve.decode`` (each decode step) and ``serve.sample`` (argmax and the
  tokens' read-back: a request's first token is on the host at the end of
  the run's first ``serve.sample``);
* ``model.act_quant`` (an activation's scale and quantization) and
  ``model.dequant`` (int32 accumulators to float times the scales, cast to
  the activation's dtype, where that runs as PyTorch ops:
  ``models.common.dequantize``; a product dequantized in the GEMM's
  epilogue has none) in ``quant_linear`` and ``quant_linear_relu``, and
  ``model.attention`` (the attention core, from the keys and queries after
  RoPE to the output before ``wo``) in the transformer's prefill and decode;
  in latent attention ``model.mla.latent`` (``wkv_a``, the latent's norm and
  RoPE'd key part, the latent cache's row written at a decode step, and the
  expansion through ``wkv_b``); in the dropless expert layer
  (``models.moe.dropless_moe_ffn``) ``model.moe.route`` (router, scores,
  top-k, the stable sort by expert, the offsets, the rows' gather),
  ``model.moe.experts`` (the grouped products with their quantize and
  SwiGLU) and ``model.moe.combine`` (the rows back in token order,
  weighted and summed, the shared experts' output added).

**Counters** are always on: :func:`count` adds to a named counter of the
process, :func:`counts` reads them.  The kernel wrappers' launch counters
(``api.count_launch``) are the ``launch.<kernel>`` counters of this
registry.  While a thread captures a CUDA graph, its counts go to the
capture's log instead (:func:`diverting_counts`), and each replay of the
graph adds them (:func:`add_counts`), as a replay does the same work again.
Besides the launches, the port counts ``serve.prompt_slots`` and
``serve.padding_slots`` (the slots of each prefill batch's ``tokens``, and
those of them that are padding), and ``model.act_quant.torch`` (a
single-pass row-parallel ``quant_linear`` on the card, whose activations take
the PyTorch chain, not the ``act_quant`` kernel: the kernel's share is
``launch.act_quant`` over the two), ``model.dequant.epilogue`` (a card
linear or grouped linear dequantized in the GEMM's epilogue) and
``model.dequant.torch`` (a card linear whose int32 sums took the PyTorch
dequantize: the epilogue's share is the first over the two), and
``moe.routed_rows`` (the rows a
dropless expert layer hands its grouped products: tokens × experts a token,
known on the host).  The grouped bit-sliced GEMM counts its launches as
``launch.grouped_matmul``.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from array import array
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional

import torch

PREFIX = "repro_torch."
CAPACITY = 1 << 18

__all__ = ["PREFIX", "CAPACITY", "NULL", "enable", "disable", "recording", "span", "call", "record",
           "Span", "Record",
           "count", "counts", "reset_counts", "add_counts", "diverting_counts"]


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


class _Null:
    """What :func:`span` and :func:`call` return while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, key: str, value: Any) -> None:
        pass


NULL = _Null()
_on = False
_names: List[str] = []          # name id → name
_name_ids: Dict[str, int] = {}
_ranges: List[str] = []         # name id → its profiler range's name
_names_lock = threading.Lock()
_open = threading.local()       # .stack: this thread's open spans, (seq, call)


class _Ring:
    """Preallocated slots of the span record: the slot of span ``seq`` is
    ``seq % capacity``; ``end`` stays 0 until the span closes."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"the span record needs a capacity of at least 1, not {capacity}")
        self.capacity = capacity
        self.seq = array("q", [-1]) * capacity
        self.name = array("q", [0]) * capacity
        self.start = array("q", [0]) * capacity
        self.end = array("q", [0]) * capacity
        self.parent = array("q", [-1]) * capacity
        self.call = array("q", [-1]) * capacity
        self.ids: Dict[int, Dict[str, Any]] = {}   # call id → the ids its span was given
        self.next = itertools.count()


_ring = _Ring(1)


def _name_id(name: str) -> int:
    i = _name_ids.get(name)
    if i is None:
        with _names_lock:
            i = _name_ids.get(name)
            if i is None:
                i = len(_names)
                _names.append(name)
                _ranges.append(PREFIX + name)
                _name_ids[name] = i
    return i


class _Span:
    __slots__ = ("ring", "name", "ids", "seq", "slot", "range")

    def __init__(self, name: int, ids: Optional[Dict[str, Any]]):
        self.ring, self.name, self.ids, self.range = _ring, name, ids, None

    def __enter__(self):
        ring = self.ring
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        seq = next(ring.next)
        slot = self.slot = seq % ring.capacity
        old = ring.seq[slot]
        if old >= 0 and ring.call[slot] == old:
            ring.ids.pop(old, None)  # the oldest call's opening span is dropped, and its ids with it
        parent, call = stack[-1] if stack else (-1, -1)
        if self.ids is not None:  # the span opens a call
            call = seq
            ring.ids[seq] = self.ids
        self.seq = seq
        ring.seq[slot], ring.name[slot], ring.parent[slot], ring.call[slot], ring.end[slot] = \
            seq, self.name, parent, call, 0
        stack.append((seq, call))
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(_ranges[self.name])
            self.range.__enter__()
        ring.start[slot] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t = time.perf_counter_ns()
        ring = self.ring
        if ring.seq[self.slot] == self.seq:  # not overwritten while it was open
            ring.end[self.slot] = t
        _open.stack.pop()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        return False

    def note(self, key: str, value: Any) -> None:
        """Set the id ``key`` of the call this span opened."""
        if self.ring.seq[self.slot] == self.seq and self.seq in self.ring.ids:
            self.ring.ids[self.seq][key] = value


def span(name: str):
    """A context manager that records the span ``name`` while recording is
    on.  Off, :data:`NULL`."""
    if not _on:
        return NULL
    return _Span(_name_id(name), None)


def call(name: str, **ids):
    """The span ``name``, opening a call with ``ids`` (see the module
    docstring).  Off, :data:`NULL`."""
    if not _on:
        return NULL
    return _Span(_name_id(name), ids)


def recording() -> bool:
    """Whether spans are being recorded."""
    return _on


def enable() -> None:
    """Start recording spans into a fresh record of :data:`CAPACITY` slots."""
    global _ring, _on
    _ring = _Ring(CAPACITY)
    _on = True


def disable() -> None:
    """Stop recording spans; the record stays readable (:func:`record`)."""
    global _on
    _on = False


@dataclass(frozen=True)
class Span:
    seq: int        # order of opening, from 0 at enable()
    name: str
    start_ns: int   # time.perf_counter_ns()
    end_ns: int
    parent: int     # seq of the enclosing span, -1 for none
    call: int       # seq of the span that opened the call it serves, -1 for none


@dataclass(frozen=True)
class Record:
    spans: List[Span]                 # the closed spans kept, in order of opening
    calls: Dict[int, Dict[str, Any]]  # call id → the ids its opening span was given
    dropped: int                      # spans whose slots later spans took

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]


def record() -> Record:
    """The spans of the latest :func:`enable` that the record still holds."""
    ring = _ring
    started = max(ring.seq) + 1
    lo = max(0, started - ring.capacity)
    out = []
    for seq in range(lo, started):
        slot = seq % ring.capacity
        if ring.seq[slot] == seq and ring.end[slot]:
            out.append(Span(seq, _names[ring.name[slot]], ring.start[slot], ring.end[slot],
                            ring.parent[slot], ring.call[slot]))
    return Record(out, {c: dict(ids) for c, ids in ring.ids.items()}, lo)


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

_counts: Dict[str, int] = {}
_count_lock = threading.Lock()
_diverted = threading.local()   # .to: where this thread's counts go while it captures a graph


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (to the capture's log while this
    thread captures a graph)."""
    to = getattr(_diverted, "to", None)
    if to is not None:
        to[name] = to.get(name, 0) + n
        return
    with _count_lock:
        _counts[name] = _counts.get(name, 0) + n


def add_counts(taken: Dict[str, int]) -> None:
    """Add counts taken elsewhere (a graph's capture, at each replay)."""
    with _count_lock:
        for name, n in taken.items():
            _counts[name] = _counts.get(name, 0) + n


def counts(prefix: str = "") -> Dict[str, int]:
    """The counters whose names start with ``prefix``."""
    with _count_lock:
        return {k: v for k, v in _counts.items() if k.startswith(prefix)}


def reset_counts(prefix: str = "") -> None:
    """Drop the counters whose names start with ``prefix``."""
    with _count_lock:
        for k in [k for k in _counts if k.startswith(prefix)]:
            del _counts[k]


@contextlib.contextmanager
def diverting_counts() -> Iterator[Dict[str, int]]:
    """Send this thread's counts to a fresh dict while the block runs (a
    CUDA graph capture, which does no work); the process's counters are
    untouched."""
    if getattr(_diverted, "to", None) is not None:
        raise RuntimeError("this thread already diverts its counts (one capture at a time)")
    taken: Dict[str, int] = {}
    _diverted.to = taken
    try:
        yield taken
    finally:
        _diverted.to = None
