"""Simulator-backed mapping autotuner: search the §V-B space, don't guess.

``distribute()`` commits to one heuristic mapping (occupancy-first, then
DRAM traffic) and ``distribute_graph`` greedily accepts or declines each
residency opportunity.  Both are good defaults and both leave modeled
cycles on the table — the occupancy objective overspreads small workloads
across tiles, paying the NoC broadcast's per-destination pipeline fill on
every operand load, and a declined plan note is a dead end rather than a
search direction.  This module turns those single-candidate paths into a
search:

* **axes** — tile count, reduction lane-split, ``k_chunk``, double
  buffering on/off, and the accumulator width (bit-serial-aware adaptive
  precision vs the full ``acc_prec`` layout), enumerated by
  :func:`repro_torch.core.compiler.distribute.mapping_candidates`; at the graph
  level additionally the residency set (each accepted resident edge is a
  drop/keep choice — the beam axis).
* **scoring** — the phase-timeline simulator's *makespan* of the compiled
  stream (timing-only lowering; functional execution is never tuned, so
  results stay bit-exact by construction).
* **verifier gate** — every scored candidate's stream must pass the static
  verifier (:func:`~repro_torch.core.compiler.verify.verify_stream` per node);
  the committed graph winner is additionally re-verified whole
  (:func:`~repro_torch.core.compiler.verify.verify_graph`).  A candidate the
  verifier rejects is never scored as a winner.
* **budget/beam/seed** — :class:`TuneConfig`.  ``budget`` caps scored
  candidates, ``beam`` caps residency-set variants explored at the graph
  level, ``seed`` deterministically rotates the candidate order (same
  seed + budget ⇒ same winner; there is no wall-clock or RNG anywhere in
  the loop).
* **never worse** — the heuristic plan is the incumbent; a winner must
  strictly beat its modeled makespan or the heuristic mapping is returned
  unchanged.

Winners are cached (:func:`tune_cache_info`, keyed by workload/graph
signature + config + :class:`TuneConfig`) and carry a JSON provenance
dict — candidate counts, verifier rejections, baseline vs tuned cycles,
and the changed axes — which the backend surfaces in ``SimReport.autotune``
and ``compile_cache_info().entries``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

from repro_torch.core.machine import PimsabConfig
from repro_torch.core.compiler import codegen
from repro_torch.core.compiler.distribute import (
    GraphMapping,
    Mapping,
    NOTE_TUNED,
    _account_elision,
    _allocate_graph_mappings,
    _note,
    _phases,
    distribute,
    distribute_graph,
    mapping_candidates,
)
from repro_torch.core.compiler.tensor_dsl import Workload, WorkloadGraph
from repro_torch.core.compiler.verify import verify_compiled, verify_graph
from repro_torch.core.simulator import Simulator

__all__ = [
    "TuneConfig",
    "TunedWorkload",
    "TunedGraph",
    "resolve",
    "tuning",
    "active",
    "tune_workload",
    "tune_graph",
    "tune_cache_info",
    "clear_tune_cache",
    "TuneCacheInfo",
]


@dataclass(frozen=True)
class TuneConfig:
    """Search knobs: ``budget`` caps candidates scored per tune call,
    ``beam`` caps graph residency-set variants, ``seed`` deterministically
    rotates the candidate visiting order.  Frozen (hashable) — it joins
    the tune- and compile-cache keys."""

    budget: int = 64
    beam: int = 4
    seed: int = 0

    def to_json(self) -> Dict[str, int]:
        return {"budget": self.budget, "beam": self.beam, "seed": self.seed}


TuneArg = Union[None, bool, TuneConfig]


def resolve(tune: TuneArg) -> Optional[TuneConfig]:
    """Normalize the public ``tune=`` argument: ``True`` ⇒ default
    :class:`TuneConfig`, ``False``/``None`` ⇒ no tuning."""
    if tune is None or tune is False:
        return None
    if tune is True:
        return TuneConfig()
    if isinstance(tune, TuneConfig):
        return tune
    raise TypeError(
        f"tune must be a bool or TuneConfig, got {type(tune).__name__}"
    )


_tls = threading.local()


@contextlib.contextmanager
def tuning(tune: TuneArg) -> Iterator[Optional[TuneConfig]]:
    """Scope in which pimsab *timing* compilations autotune by default —
    the hook for eager kernel dispatch, where no ``tune=`` argument
    reaches the backend (``kernels_bench`` wraps its pinned rows in
    this).  Functional lowerings never consult it."""
    tc = resolve(tune)
    prev = getattr(_tls, "active", None)
    _tls.active = tc
    try:
        yield tc
    finally:
        _tls.active = prev


def active() -> Optional[TuneConfig]:
    """The :class:`TuneConfig` of the innermost :func:`tuning` scope on
    this thread, or ``None``."""
    return getattr(_tls, "active", None)


@dataclass(frozen=True)
class TunedWorkload:
    """One workload-level tune: the winning mapping (the heuristic's when
    nothing beat it), its modeled makespan, and the search provenance."""

    mapping: Mapping
    cycles: float
    baseline_cycles: float
    provenance: Dict[str, Any]


@dataclass(frozen=True)
class TunedGraph:
    """One graph-level tune: the winning :class:`GraphMapping` (allocated
    and elision-accounted, ready for ``compile_graph(..., gm=)``)."""

    gm: GraphMapping
    cycles: float
    baseline_cycles: float
    provenance: Dict[str, Any]


# ---------------------------------------------------------------------------
# tune cache (keyed like the compile cache: signature + config + TuneConfig)
# ---------------------------------------------------------------------------

_cache: Dict[Any, Any] = {}
_cache_meta: Dict[Any, Dict[str, Any]] = {}
_hits = 0
_misses = 0


@dataclass(frozen=True)
class TuneCacheInfo:
    """Snapshot of the tune cache — mirrors ``compile_cache_info()``:
    hit/miss counters plus one provenance entry per cached winner."""

    hits: int
    misses: int
    size: int
    entries: Tuple[Dict[str, Any], ...]


def tune_cache_info() -> TuneCacheInfo:
    """Hits/misses/size of the tuned-winner cache, with each entry's kind
    (workload/graph), name, tune knobs, and search provenance."""
    return TuneCacheInfo(
        hits=_hits, misses=_misses, size=len(_cache),
        entries=tuple(dict(m) for m in _cache_meta.values()),
    )


def clear_tune_cache() -> None:
    """Empty the tuned-winner cache and reset its counters (tests)."""
    global _hits, _misses
    _cache.clear()
    _cache_meta.clear()
    _hits = 0
    _misses = 0


def _cached(key: Any, meta: Dict[str, Any], build):
    global _hits, _misses
    if key in _cache:
        _hits += 1
        return _cache[key]
    _misses += 1
    out = build()
    _cache[key] = out
    _cache_meta[key] = {**meta, "provenance": out.provenance}
    return out


# ---------------------------------------------------------------------------
# candidate ordering
# ---------------------------------------------------------------------------


def _tile_ladder(cfg: PimsabConfig, extra: Tuple[int, ...] = ()) -> set:
    """Geometric tile counts (1, 2, 4, … , num_tiles) plus any pinned
    extras — the budgeted search visits tile *scales*, not all 120 counts
    (neighboring counts differ only marginally in fill cost)."""
    out = {1, cfg.num_tiles}
    t = 2
    while t < cfg.num_tiles:
        out.add(t)
        t *= 2
    out.update(x for x in extra if 1 <= x <= cfg.num_tiles)
    return out


def _axes(m: Mapping) -> Tuple[int, int, int, bool, int]:
    return (m.tiles_used, m.reduce_split, m.k_chunk,
            m.double_buffered, m.out_prec)


def _axes_json(m: Mapping) -> Dict[str, Any]:
    return {
        "tiles": m.tiles_used, "reduce_split": m.reduce_split,
        "k_chunk": m.k_chunk, "double_buffered": m.double_buffered,
        "out_prec": m.out_prec,
    }


def _ordered_candidates(
    w: Workload, cfg: PimsabConfig, tc: TuneConfig, baseline: Mapping,
    **constraints,
) -> List[Mapping]:
    """Feasible candidates (baseline's axes excluded), deterministically
    ordered: stratified round-robin across tile-count groups — so a small
    budget still samples every tile scale — with the heuristic's own
    ranking inside each group and the seed rotating the group order."""
    ladder = _tile_ladder(cfg, extra=(baseline.tiles_used,))
    base = _axes(baseline)
    groups: Dict[int, List[Mapping]] = {}
    n = 0
    for m in mapping_candidates(w, cfg, **constraints):
        if m.tiles_used not in ladder or _axes(m) == base:
            continue
        groups.setdefault(m.tiles_used, []).append(m)
        n += 1
    for grp in groups.values():
        grp.sort(key=lambda m: (
            -m.occupancy, m.dram_bits, _phases(m),
            not m.double_buffered, m.out_prec,
        ))
    tiles = sorted(groups)
    if tiles:
        r = tc.seed % len(tiles)
        tiles = tiles[r:] + tiles[:r]
    out: List[Mapping] = []
    idx = 0
    while len(out) < n:
        for t in tiles:
            grp = groups[t]
            if idx < len(grp):
                out.append(grp[idx])
        idx += 1
    return out


class _Budget:
    def __init__(self, total: int):
        self.total = total
        self.spent = 0

    @property
    def exhausted(self) -> bool:
        return self.spent >= self.total

    def spend(self, n: int = 1) -> None:
        self.spent += n


# ---------------------------------------------------------------------------
# workload-level tuning (eager kernels, standalone large shapes)
# ---------------------------------------------------------------------------


def _score_workload(
    w: Workload, cfg: PimsabConfig, m: Mapping, elide: frozenset,
    tag_prefix: str, *, gate: bool = True,
) -> Optional[float]:
    cp = codegen.compile_workload(
        w, cfg, mapping=m, elide=elide, tag_prefix=tag_prefix,
    )
    if gate and verify_compiled(cp, cfg).errors:
        return None
    return Simulator(cfg).run(cp.program).makespan


def tune_workload(
    w: Workload, cfg: PimsabConfig, tc: TuneConfig, *,
    elide: frozenset = frozenset(), tag_prefix: str = "",
) -> TunedWorkload:
    """Search the mapping space of one standalone workload; the heuristic
    ``distribute()`` pick is the incumbent and the returned mapping never
    models more cycles than it.  Cached on (workload, config, knobs)."""
    key = ("workload", w, cfg, tc, elide, tag_prefix)

    def build() -> TunedWorkload:
        base_m = distribute(w, cfg)
        # the incumbent is today's shipped mapping: score it ungated (the
        # compile path verifies it regardless of tuning)
        base = _score_workload(w, cfg, base_m, elide, tag_prefix, gate=False)
        budget = _Budget(tc.budget)
        rejected = 0
        best_m, best = base_m, base
        for m in _ordered_candidates(w, cfg, tc, base_m):
            if budget.exhausted:
                break
            budget.spend()
            c = _score_workload(w, cfg, m, elide, tag_prefix)
            if c is None:
                rejected += 1
                continue
            if c < best - 1e-9:
                best, best_m = c, m
        prov = {
            "mode": "workload", "workload": w.name,
            **tc.to_json(),
            "scored": budget.spent, "verifier_rejected": rejected,
            "baseline_cycles": base, "tuned_cycles": best,
            "improvement_pct": round(100.0 * (1.0 - best / base), 2) if base else 0.0,
            "baseline": _axes_json(base_m), "winner": _axes_json(best_m),
        }
        if best_m is not base_m:
            _note(
                best_m.notes, NOTE_TUNED,
                f"mapping autotuned over {budget.spent} candidates "
                f"(seed {tc.seed}): modeled {base:.0f}->{best:.0f} cycles",
            )
        return TunedWorkload(best_m, best, base, prov)

    return _cached(key, {"kind": "workload", "name": w.name,
                         "tune": tc.to_json()}, build)


# ---------------------------------------------------------------------------
# graph-level tuning (traced programs: e2e networks, serve decode steps)
# ---------------------------------------------------------------------------


def _pins_key(state_pins) -> Tuple:
    return tuple(sorted(
        (n, tuple(sorted(
            (b, tuple(tuple(r) for r in rr)) for b, rr in pins.items()
        )))
        for n, pins in (state_pins or {}).items()
    ))


def _clone_gm(gm: GraphMapping) -> GraphMapping:
    return GraphMapping(
        graph=gm.graph,
        mappings={
            k: dataclasses.replace(v, notes=list(v.notes))
            for k, v in gm.mappings.items()
        },
        resident=gm.resident,
        notes=list(gm.notes),
        state_pins={
            n: {b: [tuple(r) for r in rr] for b, rr in pins.items()}
            for n, pins in gm.state_pins.items()
        },
        must_store=set(gm.must_store),
    )


def _locked_nodes(gm: GraphMapping) -> set:
    """Nodes whose mapping is pinned by a residency or state decision —
    their tilings are boundary contracts, not free axes."""
    out = set(gm.state_pins)
    for e in gm.resident:
        out.add(e.src)
        out.add(e.dst)
    return out


def _dead_inputs(gm: GraphMapping, w: Workload) -> frozenset:
    dead = {e.dst_input for e in gm.resident if e.dst == w.name}
    if gm.store_elided(w.name):
        dead.add("out")
    dead |= gm.state_elides(w.name)
    return frozenset(dead)


def _node_span(
    w: Workload, cfg: PimsabConfig, m: Mapping, dead: frozenset,
    *, gate: bool,
) -> Optional[float]:
    """Standalone makespan of one node's segment — the cheap ranking
    metric (segments start at barriers, so a node's standalone span is a
    tight proxy for its in-stream share; commits re-simulate the full
    stream exactly)."""
    cp = codegen.compile_workload(
        w, cfg, mapping=m, elide=dead, tag_prefix=f"{w.name}:",
    )
    if gate and verify_compiled(cp, cfg).errors:
        return None
    return Simulator(cfg).run(cp.program).makespan


def _graph_cycles(g: WorkloadGraph, cfg: PimsabConfig, gm: GraphMapping) -> float:
    prog, _ = codegen.emit_graph(g, cfg, gm)
    return Simulator(cfg).run(prog).makespan


def _reallocate(gm: GraphMapping, cfg: PimsabConfig) -> bool:
    """Joint-allocate a candidate graph plan; ``False`` when infeasible."""
    try:
        _allocate_graph_mappings(gm, cfg)
    except RuntimeError:
        return False
    gm.elided_bits = {}
    _account_elision(gm)
    return True


def _drop_edge(gm0: GraphMapping, edge, cfg: PimsabConfig) -> Optional[GraphMapping]:
    gm = _clone_gm(gm0)
    gm.resident = tuple(e for e in gm0.resident if e != edge)
    _note(
        gm.notes, NOTE_TUNED,
        f"residency {edge.src}->{edge.dst} dropped by the autotuner's "
        "residency-set search",
    )
    if not _reallocate(gm, cfg):
        return None
    return gm


@dataclass
class _DescentResult:
    gm: GraphMapping
    cycles: float
    changed: Dict[str, Dict[str, Any]]
    rejected: int


def _descend(
    g: WorkloadGraph, cfg: PimsabConfig, tc: TuneConfig,
    gm: GraphMapping, cycles: float, budget: _Budget,
) -> _DescentResult:
    """Per-node coordinate descent under a fixed residency/state set.

    Candidates are ranked by their standalone segment span (verifier-
    gated); the best few are committed only if the joint allocator keeps
    the plan intact — same residency set, same state pins, nobody's
    double buffering degraded — and the exact full-stream makespan
    improves.  Locked (chained/state-pinned) nodes are boundary contracts
    and keep their planned mappings."""
    gm_cur, cycles_cur = gm, cycles
    locked = _locked_nodes(gm)
    changed: Dict[str, Dict[str, Any]] = {}
    rejected = 0
    for w in g.nodes:
        if w.name in locked or budget.exhausted:
            continue
        base_m = gm_cur.mappings[w.name]
        dead = _dead_inputs(gm_cur, w)
        base_span = _node_span(w, cfg, base_m, dead, gate=False)
        ranked: List[Tuple[float, int, Mapping]] = []
        for m in _ordered_candidates(w, cfg, tc, base_m):
            if budget.exhausted:
                break
            budget.spend()
            span = _node_span(w, cfg, m, dead, gate=True)
            if span is None:
                rejected += 1
                continue
            if span < base_span - 1e-9:
                ranked.append((span, len(ranked), m))
        ranked.sort(key=lambda t: (t[0], t[1]))
        for _, _, m in ranked[:3]:
            gm_try = _clone_gm(gm_cur)
            gm_try.mappings[w.name] = dataclasses.replace(m, notes=list(m.notes))
            if not _reallocate(gm_try, cfg):
                continue
            if (
                gm_try.resident != gm_cur.resident
                or set(gm_try.state_pins) != set(gm_cur.state_pins)
                or any(
                    gm_try.mappings[n].double_buffered
                    != gm_cur.mappings[n].double_buffered
                    for n in gm_try.mappings if n != w.name
                )
                or gm_try.mappings[w.name].double_buffered != m.double_buffered
            ):
                continue  # the allocator degraded the plan to fit — skip
            total = _graph_cycles(g, cfg, gm_try)
            if total < cycles_cur - 1e-9:
                changed[w.name] = {
                    "baseline": _axes_json(base_m), "winner": _axes_json(m),
                }
                gm_cur, cycles_cur = gm_try, total
                break
    return _DescentResult(gm_cur, cycles_cur, changed, rejected)


def tune_graph(
    g: WorkloadGraph, cfg: PimsabConfig, tc: TuneConfig, *,
    state_pins=None,
) -> TunedGraph:
    """Search a traced program's graph plan: residency-set variants (the
    ``beam`` axis — the greedy plan plus drop-one-edge alternatives) each
    refined by per-node coordinate descent.  The greedy
    :func:`distribute_graph` plan is the incumbent; the committed winner
    is re-verified whole (:func:`verify_graph`) and must strictly beat
    the incumbent's modeled makespan.  Cached on (graph, config, knobs,
    state pins)."""
    key = ("graph", g, cfg, tc, _pins_key(state_pins))

    def build() -> TunedGraph:
        cost_fn = lambda w, m, elide: codegen._data_movement_cycles(w, m, cfg, elide)
        gm0 = distribute_graph(g, cfg, cost_fn, state_pins=state_pins)
        base = _graph_cycles(g, cfg, gm0)
        budget = _Budget(tc.budget)
        results = [_descend(g, cfg, tc, gm0, base, budget)]
        dropped_of = {id(results[0].gm): []}
        for e in gm0.resident[: max(0, tc.beam - 1)]:
            if budget.exhausted:
                break
            gm_v = _drop_edge(gm0, e, cfg)
            if gm_v is None:
                continue
            budget.spend()
            cv = _graph_cycles(g, cfg, gm_v)
            r = _descend(g, cfg, tc, gm_v, cv, budget)
            dropped_of[id(r.gm)] = [f"{e.src}->{e.dst}"]
            results.append(r)
        best = min(results, key=lambda r: r.cycles)
        rejected = sum(r.rejected for r in results)
        gm_best, cycles_best = best.gm, best.cycles
        if cycles_best < base - 1e-9 and gm_best is not gm0:
            prog, segs = codegen.emit_graph(g, cfg, gm_best)
            cg = codegen.CompiledGraph(prog, g, gm_best, segs)
            if verify_graph(cg, cfg).errors:
                gm_best, cycles_best = gm0, base  # belt and braces
            else:
                _note(
                    gm_best.notes, NOTE_TUNED,
                    f"graph plan autotuned over {budget.spent} candidates "
                    f"(seed {tc.seed}): {len(best.changed)} node mappings "
                    f"replaced, modeled {base:.0f}->{cycles_best:.0f} cycles",
                )
        else:
            gm_best, cycles_best = gm0, base
        prov = {
            "mode": "graph", "graph": g.name,
            **tc.to_json(),
            "scored": budget.spent, "verifier_rejected": rejected,
            "residency_variants": len(results),
            "baseline_cycles": base, "tuned_cycles": cycles_best,
            "improvement_pct": (
                round(100.0 * (1.0 - cycles_best / base), 2) if base else 0.0
            ),
            "nodes_changed": (
                best.changed if gm_best is not gm0 else {}
            ),
            "residency_dropped": (
                dropped_of.get(id(gm_best), []) if gm_best is not gm0 else []
            ),
        }
        return TunedGraph(gm_best, cycles_best, base, prov)

    return _cached(key, {"kind": "graph", "name": g.name,
                         "tune": tc.to_json()}, build)
