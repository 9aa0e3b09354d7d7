"""The port's continuous-batching scheduler (``repro_torch.serve.scheduler``)
and its decode-step wrappers (``pimsab_step.decode_executor`` /
``run_decode_step``) against the JAX package's.

The counterparts of ``tests/test_serve_pimsab.py``'s four batcher tests, its
report-ring test and its two (slow-tier there) decode-step tests, each run
by both packages side by side: generations, ``summary()`` (the modeled
seconds, energy and cycles summed in the same order, so the floats are
exactly equal), ``ResidentState`` values and compile-cache deltas equal to
JAX's, no tolerance anywhere; preemption on buckets (4, 8), bucket 8 being
the one whose residency the planner declines.  Then the ``serve`` section of
``BENCH_kernels.json`` reproduced by ``benchmarks/serve_bench.py``'s recipe
(its ``energy_j`` and ``joules_per_token`` within 1e-12 relative, pinned on
another host; everything else exactly), the toy model's rows equal to
JAX's, ``detok``'s first-maximum rule, and the device edges: contexts on the
batcher's device, no launch counted.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import api as japi  # noqa: E402
from repro.serve import pimsab_step as jstep  # noqa: E402
from repro.serve import scheduler as jsched  # noqa: E402
from repro_torch.core.compiler import autotune as tautotune  # noqa: E402
from repro_torch.kernels import api as tapi  # noqa: E402
from repro_torch.serve import pimsab_step as tstep  # noqa: E402
from repro_torch.serve import scheduler as tsched  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SERVE = json.loads((REPO / "BENCH_kernels.json").read_text())["serve"]
# benchmarks/serve_bench.py's recipe, restated (benchmarks/ is the JAX package's)
DEFAULT_TUNE = dict(budget=96, beam=4, seed=0)
BATCH_SIZES = (1, 4, 16)
MAX_NEW_TOKENS = 2
PROMPTS = [[1, 2], [2, 3], [3, 1], [1, 3]]


@pytest.fixture(autouse=True)
def fresh_compile_caches():
    """Both packages' compile caches start empty, so that hit and miss
    deltas do not depend on which tests ran before in the process."""
    japi.clear_compile_cache()
    tapi.clear_compile_cache()


def _batcher(mod, **kw):
    if mod is tsched:
        kw["device"] = "cpu"
    return mod.ContinuousBatcher(**kw)


def _run(mod, api, submits, **kw):
    """Submit ``(prompt, max_new_tokens)`` pairs, run to the end; returns
    the batcher, its retired requests and the compile-cache deltas."""
    before = api.compile_cache_info()
    sched = _batcher(mod, **kw)
    for prompt, n in submits:
        sched.submit(prompt, max_new_tokens=n)
    done = sched.run()
    after = api.compile_cache_info()
    return sched, done, (after.hits - before.hits, after.misses - before.misses)


def _assert_runs_equal(jrun, trun):
    (jsch, jdone, jd), (tsch, tdone, td) = jrun, trun
    assert td == jd
    assert [(r.rid, r.prompt, r.generated, r.state, r.capacity, r.pos, r.preemptions) for r in tdone] == \
        [(r.rid, r.prompt, r.generated, r.state, r.capacity, r.pos, r.preemptions) for r in jdone]
    for t, j in zip(tdone, jdone):
        for ts, js in ((t.k_state, j.k_state), (t.v_state, j.v_state)):
            assert ts.spec() == js.spec()
            assert ts.value.dtype == torch.int64 and ts.value.device.type == "cpu"
            np.testing.assert_array_equal(ts.value.numpy(), np.asarray(js.value))
    assert tsch.summary() == jsch.summary()


# ---------------------------------------------------------------------------
# tests/test_serve_pimsab.py's scheduler cases, both packages
# ---------------------------------------------------------------------------


def test_continuous_batcher_two_requests_share_compiled_program():
    submits = [([1, 2], 2), ([2, 3], 2)]
    jrun = _run(jsched, japi, submits, max_active=2, buckets=(4,))
    jrep = japi.last_sim_report()
    tapi.reset_launch_counts()
    trun = _run(tsched, tapi, submits, max_active=2, buckets=(4,))
    assert tapi.launch_counts() == {}
    rep = tapi.last_sim_report()
    _assert_runs_equal(jrun, trun)
    sched, done, (hits, misses) = trun
    assert len(done) == 2 and all(r.state == tsched.RETIRED for r in done)
    assert all(len(r.generated) == 2 for r in done)
    assert misses <= 1 and hits >= 1
    assert any(e.startswith("state:") for e in rep.resident_edges)
    assert rep.to_json() == jrep.to_json()
    assert sched.stats.tokens == 4 and sched.stats.modeled_seconds > 0


def _preemption_runs(mod, api, max_active):
    return _run(mod, api, [([1], 5), ([2, 3], 2)], max_active=max_active, buckets=(4, 8))


def test_continuous_batcher_preemption_is_lossless():
    """Under lane pressure the long request (bucket 8, residency declined)
    is preempted for the short one (bucket 4, resident); it keeps its
    handles, its cache parked in ``.value``, and resumes exactly: the
    generations equal the run without pressure, in both packages."""
    runs = {}
    for mod, api in ((jsched, japi), (tsched, tapi)):
        for max_active in (1, 2):
            api.clear_compile_cache()
            runs[mod, max_active] = _preemption_runs(mod, api, max_active)
    for max_active in (1, 2):
        _assert_runs_equal(runs[jsched, max_active], runs[tsched, max_active])

    def gens(run):
        return {tuple(r.prompt): list(r.generated) for r in run[1]}

    assert gens(runs[tsched, 1]) == gens(runs[tsched, 2])
    assert any(r.preemptions > 0 for r in runs[tsched, 1][1])
    assert {r.capacity for r in runs[tsched, 1][1]} == {4, 8}


def test_batcher_rejects_oversized_and_empty_requests():
    for mod in (jsched, tsched):
        sched = _batcher(mod, buckets=(4,))
        with pytest.raises(ValueError, match="largest bucket is 4"):
            sched.submit([1, 2, 3], max_new_tokens=9)
        with pytest.raises(ValueError, match="empty prompt"):
            sched.submit([], max_new_tokens=1)
        with pytest.raises(ValueError, match="no bucket holds 9"):
            sched._bucket_for(9)


def test_toy_token_model_is_deterministic_and_equals_jax():
    m, jm = tsched.ToyTokenModel(tstep.AttnServeConfig()), jsched.ToyTokenModel(jstep.AttnServeConfig())
    q1, k1, v1 = m.embed(3)
    q2, k2, v2 = m.embed(3)
    assert torch.equal(q1, q2) and torch.equal(k1, k2) and torch.equal(v1, v2)
    assert q1.abs().max() <= 7 and k1.abs().max() <= 15
    for tok in range(-3, 12):
        for got, want in zip(m.embed(tok), jm.embed(tok)):
            assert got.dtype == torch.int8 and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), want)
    wide, jwide = tsched.ToyTokenModel(tstep.AttnServeConfig(), vocab=7), jsched.ToyTokenModel(
        jstep.AttnServeConfig(), vocab=7)
    assert wide.vocab == jwide.vocab == 7
    np.testing.assert_array_equal(wide.embed(9)[2].numpy(), jwide.embed(9)[2])


def test_detok_takes_the_first_maximum_on_a_host_copy():
    m, jm = tsched.ToyTokenModel(tstep.AttnServeConfig()), jsched.ToyTokenModel(jstep.AttnServeConfig())
    for ctx in ([[3, 9, 9, 1]], [[-5, -5, -5, -5]], [[0, 1, 2, 7]], [[7, 0, 0, 7]]):
        arr = np.array(ctx, np.int32)
        assert m.detok(torch.from_numpy(arr)) == m.detok(arr) == jm.detok(arr)
    assert m.detok(torch.tensor([[3, 9, 9, 1]], dtype=torch.int32)) == 1


def test_sim_report_log_ring():
    tapi.clear_sim_report_log()
    sched = _batcher(tsched, max_active=1, buckets=(4,))
    sched.submit([1, 2], max_new_tokens=2)
    sched.run()
    log = tapi.sim_report_log()
    assert len(log) == sched.stats.steps == 2
    assert log[-1] is tapi.last_sim_report()
    tapi.clear_sim_report_log()
    assert tapi.sim_report_log() == ()


def test_contexts_lie_on_the_batchers_device_and_every_step_is_recorded(monkeypatch):
    ctxs = []
    real = tsched.run_decode_step

    def spy(*a, **k):
        out = real(*a, **k)
        ctxs.append(out)
        return out

    monkeypatch.setattr(tsched, "run_decode_step", spy)
    sched = _batcher(tsched, max_active=2, buckets=(4,))
    assert sched.device == torch.device("cpu")
    sched.submit([1, 2], max_new_tokens=2)
    sched.run()
    assert len(ctxs) == 2
    assert all(c.device.type == "cpu" and c.dtype == torch.int32 and c.shape == (1, 4) for c in ctxs)


# ---------------------------------------------------------------------------
# the decode step: decode_executor + run_decode_step (resident and declined)
# ---------------------------------------------------------------------------


def _decode_steps(capacity, steps, seed):
    res = []
    for step, arr in ((jstep, np.asarray), (tstep, torch.from_numpy)):
        cfg = step.AttnServeConfig()
        kst, vst = step.kv_states(cfg, capacity)
        ex = step.decode_executor(cfg, capacity, kst, vst)
        assert ex.backend == "pimsab" and ex.states == {0: kst, 1: vst}
        rng = np.random.default_rng(seed)
        outs, vals = [], []
        for pos in range(steps):
            q = rng.integers(-7, 8, cfg.head_dim).astype(np.int8)
            kn = rng.integers(-15, 16, cfg.head_dim).astype(np.int8)
            vn = rng.integers(-100, 100, cfg.value_dim).astype(np.int8)
            outs.append(step.run_decode_step(ex, cfg, capacity, arr(q), arr(kn), arr(vn), pos))
            vals.append((np.array(kst.value), np.array(vst.value)))
        mod_api = japi if step is jstep else tapi
        res.append((outs, vals, mod_api.last_sim_report()))
    return res


@pytest.mark.parametrize("capacity,steps,seed,resident", [(4, 4, 0, True), (8, 3, 1, False)],
                         ids=["bucket4-resident", "bucket8-declined"])
def test_decode_step_equals_jax(capacity, steps, seed, resident):
    """JAX's ``test_decode_step_bit_exact_and_resident`` and
    ``..._declined_bucket_still_bit_exact``: every context and both caches
    after every step bit-equal to JAX's, the reports equal."""
    (jouts, jvals, jrep), (outs, vals, rep) = _decode_steps(capacity, steps, seed)
    for o, jo in zip(outs, jouts):
        assert isinstance(o, torch.Tensor) and o.dtype == torch.int32 and o.shape == (1, 4)
        np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    for (k, v), (jk, jv) in zip(vals, jvals):
        np.testing.assert_array_equal(k, jk)
        np.testing.assert_array_equal(v, jv)
    assert rep.to_json() == jrep.to_json()
    state_edges = [e for e in rep.resident_edges if "state:" in e]
    assert len(state_edges) == (4 if resident else 0)
    if resident:
        for node, t in rep.dram_traffic.items():
            if "kv_append" in node:
                assert t.get("a", 0) == 0 and t.get("out", 0) == 0, (node, t)


def test_second_request_in_a_bucket_hits_the_compile_cache_and_rebinds():
    cfg = tstep.AttnServeConfig()
    k1, v1 = tstep.kv_states(cfg, 4)
    k2, v2 = tstep.kv_states(cfg, 4)
    before = tapi.compile_cache_info()
    ex1 = tstep.decode_executor(cfg, 4, k1, v1)
    ex2 = tstep.decode_executor(cfg, 4, k2, v2)
    after = tapi.compile_cache_info()
    assert ex1 is ex2 and ex2.states == {0: k2, 1: v2}
    assert (after.hits - before.hits, after.misses - before.misses) == (1, 1)


# ---------------------------------------------------------------------------
# BENCH_kernels.json's serve section (benchmarks/serve_bench.py's recipe)
# ---------------------------------------------------------------------------


def _serve_row(batch):
    before = tapi.compile_cache_info()
    sched = _batcher(tsched, max_active=batch, buckets=(4,), tune=tapi.TuneConfig(**DEFAULT_TUNE))
    for i in range(batch):
        sched.submit(PROMPTS[i % len(PROMPTS)], max_new_tokens=MAX_NEW_TOKENS)
    sched.run()
    after = tapi.compile_cache_info()
    rep = tapi.last_sim_report()
    resident = any(e.startswith("state:") for e in rep.resident_edges)
    append_traffic = sum(t.get("a", 0.0) + t.get("out", 0.0) for node, t in rep.dram_traffic.items()
                         if "kv_append" in node)
    s = sched.summary()
    return {
        "batch": batch,
        "requests": batch,
        "max_new_tokens": MAX_NEW_TOKENS,
        "tokens": int(s["tokens"]),
        "steps": int(s["steps"]),
        "modeled_seconds": s["modeled_seconds"],
        "total_cycles": int(s["total_cycles"]),
        "energy_j": s["energy_j"],
        "tokens_per_sec": round(s["tokens_per_sec"], 1),
        "joules_per_token": s["joules_per_token"],
        "kv_resident": bool(resident and append_traffic == 0.0),
        "autotune": dict(rep.autotune),
        "compile_cache": {"hits_added": after.hits - before.hits, "misses_added": after.misses - before.misses},
    }


def test_serve_section_of_bench_kernels_reproduced():
    """``serve_bench.collect()`` on the port: batches 1, 4 and 16 in order
    (the cache deltas assume a fresh tune cache and compile cache)."""
    tautotune.clear_tune_cache()
    cfg = tstep.AttnServeConfig()
    assert SERVE["config"] == {"head_dim": cfg.head_dim, "value_dim": cfg.value_dim, "kv_bits": cfg.kv_bits,
                               "score_bits": cfg.score_bits, "score_frac": cfg.score_frac}
    for batch, pinned in zip(BATCH_SIZES, SERVE["batches"]):
        row, pinned = json.loads(json.dumps(_serve_row(batch))), dict(pinned)
        for key in ("energy_j", "joules_per_token"):
            assert row.pop(key) == pytest.approx(pinned.pop(key), rel=1e-12, abs=0), (batch, key)
        assert row == pinned, batch
    assert [r["total_cycles"] for r in SERVE["batches"]] == [10516, 42064, 168256]
    assert {r["tokens_per_sec"] for r in SERVE["batches"]} == {285279.6}
