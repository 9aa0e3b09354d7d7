"""The port's pimsab Program lowering against the JAX package's.

``api.compile(prog, "pimsab", verify=, tune=, states=)`` and ``api.trace``
under ``use_backend("pimsab")`` lower a traced Program into one fused
``WorkloadGraph`` (``repro_torch.kernels.pimsab_backend.
compile_traced_program``) and run it on the port's functional simulator.
Every case feeds the same numpy-seeded inputs to the JAX package (under its
own ``use_backend("pimsab")``) and to the port: integer outputs and
``ResidentState`` values bit-equal, float outputs within the JAX test's
tolerance (here exactly equal: both sides quantize with the same numpy
code), ``SimReport`` s field-equal, and equal compile-cache hit/miss deltas
and ``CacheInfo`` verifier summaries.  The counterparts of
``tests/test_program.py``'s pimsab cases, ``tests/test_autotune.py``'s
program cases, the ``program`` row of ``BENCH_kernels.json``, the decode
step with its caches bound as ``ResidentState`` (resident and declined),
``_plan_states``' structural refusals, and the Executor's pimsab route
(host execution in any scope, refusal during a CUDA graph capture, no
launch counted).
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.compiler import autotune as jautotune  # noqa: E402
from repro.kernels import api as japi  # noqa: E402
from repro.kernels import pimsab_backend as jpb  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import resnet as jres  # noqa: E402
from repro.serve import pimsab_step as jstep  # noqa: E402
from repro_torch.core.compiler import autotune as tautotune  # noqa: E402
from repro_torch.kernels import api as tapi  # noqa: E402
from repro_torch.kernels import pimsab_backend as tpb  # noqa: E402
from repro_torch.kernels import program as tprogram  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import resnet as tres  # noqa: E402
from repro_torch.serve import pimsab_step as tstep  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
REPORT_FIELDS = ("kernel", "workload", "total_cycles", "serialized_cycles", "overlapped_cycles", "cycles",
                 "energy_j", "instrs", "instr_mix", "functional_instrs", "kernels", "per_kernel",
                 "dram_traffic", "resident_edges", "elided_dram_bits", "autotune")
TC = dict(budget=64, beam=4, seed=0)  # tests/test_autotune.py's TC


def ints(shape, lo=-100, hi=100, seed=0):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(np.int32)


def normals(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def assert_reports_equal(got, want):
    """Port and JAX ``SimReport`` s field for field, and as JSON."""
    for f in REPORT_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.to_json() == want.to_json()


def assert_out_equal(got, want):
    """A port output (tensor or tuple of them) bit-equal to JAX's."""
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_out_equal(g, w)
        return
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    w = np.asarray(want)
    assert got.dtype == getattr(torch, str(w.dtype)), (got.dtype, w.dtype)
    np.testing.assert_array_equal(got.numpy(), w)


def cache_delta(info_fn, fn):
    before = info_fn()
    out = fn()
    after = info_fn()
    return out, (after.hits - before.hits, after.misses - before.misses)


def both(jfn, tfn, args, *, name):
    """Trace ``jfn``/``tfn`` under each package's pimsab scope over the same
    numpy ``args``; returns ((jax out, report), (port out, report))."""
    res = []
    for pkg, fn, arr in ((japi, jfn, jnp.asarray), (tapi, tfn, _t)):
        with pkg.use_backend("pimsab"):
            out = pkg.trace(fn, name=name)(*(arr(a) for a in args))
            res.append((out, pkg.last_sim_report()))
    return res


@pytest.fixture(autouse=True)
def fresh_compile_caches():
    """Both packages' compile caches start empty, so that hit and miss
    deltas do not depend on which tests ran before in the process."""
    japi.clear_compile_cache()
    tapi.clear_compile_cache()


# ---------------------------------------------------------------------------
# the matmul → ewise_add → relu chain (tests/test_program.py)
# ---------------------------------------------------------------------------


def _jchain(xs, ws, y):
    return japi.relu(japi.ewise_add(japi.matmul(xs, ws), y))


def _tchain(xs, ws, y):
    return tapi.relu(tapi.ewise_add(tapi.matmul(xs, ws), y))


def chain_operands(m=8, k=8, n=8, seed=0, x_bits=8, xlo=-100, xhi=100):
    """Both packages' ``(xs, ws, y)`` over the same numpy draws."""
    x, w, y = ints((m, k), xlo, xhi, seed), ints((k, n), seed=seed + 1), ints((m, n), seed=seed + 2)
    jops = (japi.SlicedTensor.from_int(jnp.asarray(x), x_bits), japi.SlicedTensor.from_int(jnp.asarray(w), 8),
            jnp.asarray(y))
    tops = (tapi.SlicedTensor.from_int(_t(x), x_bits), tapi.SlicedTensor.from_int(_t(w), 8), _t(y))
    return jops, tops


def _eager_chain(pkg, xs, ws, y):
    with pkg.use_backend("pimsab"):
        acc = pkg.matmul(xs, ws)
        r_mm = pkg.last_sim_report()
        s = pkg.ewise_add(acc, y)
        r_add = pkg.last_sim_report()
        out = pkg.relu(s)
        r_relu = pkg.last_sim_report()
    return out, (r_mm, r_add, r_relu)


def test_traced_chain_bit_exact_and_fewer_dram_cycles_than_eager():
    jops, tops = chain_operands()
    t_eager, t_reports = _eager_chain(tapi, *tops)
    eager_dram = sum(r.cycles["dram"] for r in t_reports)
    with japi.use_backend("pimsab"):
        jgot = japi.trace(_jchain, name="_chain")(*jops)
    jrep = japi.last_sim_report()
    with tapi.use_backend("pimsab"):
        got = tapi.trace(_tchain, name="_chain")(*tops)
    rep = tapi.last_sim_report()
    assert_out_equal(got, jgot)
    assert torch.equal(got, t_eager)
    assert_reports_equal(rep, jrep)
    assert rep.cycles["dram"] < eager_dram
    assert rep.kernel == "program" and rep.kernels == ("bitslice_matmul", "ewise_add", "relu")
    assert len(rep.resident_edges) == 2 and rep.elided_dram_bits > 0
    assert rep.dram_traffic["n0.bitslice_matmul"]["out"] == 0.0
    assert rep.dram_traffic["n1.ewise_add"]["a"] == 0.0 and rep.dram_traffic["n1.ewise_add"]["b"] > 0
    assert rep.dram_traffic["n2.relu"]["a"] == 0.0 and rep.dram_traffic["n2.relu"]["out"] > 0
    assert sum(p["total_cycles"] for p in rep.per_kernel) == pytest.approx(rep.total_cycles)


def test_second_compile_with_identical_signature_is_cache_hit():
    jops, tops = chain_operands(seed=10)
    deltas = []
    for pkg, fn, ops in ((japi, _jchain, jops), (tapi, _tchain, tops)):
        traced = pkg.trace(fn, name="cache_hit_chain")
        with pkg.use_backend("pimsab"):
            prog = traced.program_for(*ops)
            ex1, d1 = cache_delta(pkg.compile_cache_info, lambda: pkg.compile(prog))
            ex2, d2 = cache_delta(pkg.compile_cache_info, lambda: pkg.compile(prog))
            assert ex1 is ex2
            prog2 = traced.trace(*ops)
            assert prog2.signature() == prog.signature() and pkg.compile(prog2) is ex1
        deltas.append((d1, d2))
    assert deltas[0] == deltas[1] == ((0, 1), (1, 0))
    ex = tapi.compile(tapi.trace(_tchain, name="cache_hit_chain").program_for(*tops), "pimsab")
    assert ex.backend == "pimsab" and ex.report.kernel == "program"


def test_cache_miss_on_shape_and_precision_change():
    deltas = []
    for pkg, fn, side in ((japi, _jchain, 0), (tapi, _tchain, 1)):
        traced = pkg.trace(fn, name="cache_miss_chain")
        seq = []
        with pkg.use_backend("pimsab"):
            base, _ = cache_delta(pkg.compile_cache_info,
                                  lambda: pkg.compile(traced.program_for(*chain_operands(seed=20)[side])))
            for ops in (chain_operands(seed=21)[side],                      # fresh values: hit
                        chain_operands(m=4, seed=22)[side],                 # new shape: miss
                        chain_operands(seed=23, x_bits=16, xlo=-3000, xhi=3000)[side]):  # two slices: miss
                ex, d = cache_delta(pkg.compile_cache_info, lambda: pkg.compile(traced.program_for(*ops)))
                seq.append(d)
        assert ex is not base
        deltas.append(seq)
    assert deltas[0] == deltas[1] == [(1, 0), (0, 1), (0, 1)]


def test_executor_replays_with_fresh_values():
    outs = []
    for pkg, fn, side in ((japi, _jchain, 0), (tapi, _tchain, 1)):
        with pkg.use_backend("pimsab"):
            ex = pkg.compile(pkg.trace(fn, name="replay_chain").program_for(*chain_operands(seed=30)[side]))
            got1 = ex(*chain_operands(seed=30)[side])
            got2 = ex(*chain_operands(seed=31)[side])
            want2 = fn(*chain_operands(seed=31)[side])  # eager chain, same backend
        outs.append((got1, got2, want2))
    (j1, j2, jw), (t1, t2, tw) = outs
    assert_out_equal(t2, j2)
    assert_out_equal(t1, j1)
    assert torch.equal(t2, tw) and not torch.equal(t1, t2)


def test_multi_consumer_output_keeps_store_but_elides_consumer_load():
    def jfan(xs, ws):
        acc = japi.matmul(xs, ws)
        return acc, japi.relu(acc)

    def tfan(xs, ws):
        acc = tapi.matmul(xs, ws)
        return acc, tapi.relu(acc)

    jops, tops = chain_operands(seed=90)
    with japi.use_backend("pimsab"):
        jgot = japi.trace(jfan, name="fanout")(*jops[:2])
    jrep = japi.last_sim_report()
    with tapi.use_backend("pimsab"):
        got = tapi.trace(tfan, name="fanout")(*tops[:2])
    rep = tapi.last_sim_report()
    assert isinstance(got, tuple) and len(got) == 2
    assert_out_equal(got, jgot)
    assert_reports_equal(rep, jrep)
    assert rep.dram_traffic["n0.bitslice_matmul"]["out"] > 0 and rep.dram_traffic["n1.relu"]["a"] == 0.0
    assert len(rep.resident_edges) == 1


def test_residency_cost_gate_declines_when_repinning_adds_phases():
    jops, tops = chain_operands(k=64, seed=95)
    _, t_reports = _eager_chain(tapi, *tops)
    with japi.use_backend("pimsab"):
        jgot = japi.trace(_jchain, name="cost_gate_chain")(*jops)
    jrep = japi.last_sim_report()
    with tapi.use_backend("pimsab"):
        got = tapi.trace(_tchain, name="cost_gate_chain")(*tops)
    rep = tapi.last_sim_report()
    assert_out_equal(got, jgot)
    assert_reports_equal(rep, jrep)
    assert rep.resident_edges == ("n1.ewise_add->n2.relu",)
    assert any("residency declined" in n for n in rep.mapping["notes"])
    assert rep.mapping == jrep.mapping
    assert rep.cycles["dram"] < sum(r.cycles["dram"] for r in t_reports)


def test_float_chain_keeps_dram_round_trip_and_matches_eager():
    x, y = normals((8, 16), 0), normals((8, 16), 1)
    (jgot, jrep), (got, rep) = both(lambda a, b: japi.relu(japi.ewise_add(a, b)),
                                    lambda a, b: tapi.relu(tapi.ewise_add(a, b)), (x, y), name="fchain")
    with tapi.use_backend("pimsab"):
        eager = tapi.relu(tapi.ewise_add(_t(x), _t(y)))
    assert rep.resident_edges == ()
    assert_out_equal(got, jgot)
    assert torch.equal(got, eager)
    np.testing.assert_allclose(np.maximum(x + y, 0), got.numpy(), atol=1e-3)
    assert_reports_equal(rep, jrep)


def test_traced_htree_reduce_and_rglru_on_pimsab():
    xr = ints((8, 16), -50, 50, seed=100)
    (jgot, jrep), (got, rep) = both(lambda v: japi.htree_reduce(v), lambda v: tapi.htree_reduce(v), (xr,),
                                    name="prog_htree")
    assert_out_equal(got, jgot)
    np.testing.assert_array_equal(xr.sum(axis=0), got.numpy())
    assert_reports_equal(rep, jrep)

    a = (1.0 / (1.0 + np.exp(-normals((1, 6, 12), 2).astype(np.float64)))).astype(np.float32)
    b, h0 = normals((1, 6, 12), 3), normals((1, 12), 4)
    (jgot, jrep), (got, rep) = both(lambda a, b, h: japi.rglru_scan(a, b, h),
                                    lambda a, b, h: tapi.rglru_scan(a, b, h), (a, b, h0), name="prog_rglru")
    assert_out_equal(got, jgot)
    oracle = tapi.get_kernel("rglru_scan").oracle(_t(a), _t(b), _t(h0))
    np.testing.assert_allclose(oracle.numpy(), got.numpy(), atol=5e-2)
    assert_reports_equal(rep, jrep)


def test_traced_bfloat16_htree_reduce_equals_jax():
    """A bfloat16 slot (no numpy dtype in the port; the host copy widens it
    to float32 exactly) lowers as JAX's does."""
    x = normals((8, 16), 101)
    with japi.use_backend("pimsab"):
        jgot = japi.trace(lambda v: japi.htree_reduce(v), name="prog_htree_bf16")(jnp.asarray(x, jnp.bfloat16))
    jrep = japi.last_sim_report()
    with tapi.use_backend("pimsab"):
        got = tapi.trace(lambda v: tapi.htree_reduce(v), name="prog_htree_bf16")(_t(x).to(torch.bfloat16))
    rep = tapi.last_sim_report()
    assert_out_equal(got, jgot)
    assert_reports_equal(rep, jrep)


# ---------------------------------------------------------------------------
# DAG programs
# ---------------------------------------------------------------------------


def _diamond(api):
    def diamond(x, y):
        s = api.ewise_add(x, y)
        p = api.relu(s)
        q = api.ewise_add(s, y)
        return api.ewise_add(p, q)
    return diamond


def test_diamond_reconvergence_bit_exact_vs_eager_on_pimsab():
    x, y = ints((8, 16), seed=200), ints((8, 16), seed=201)
    (jgot, jrep), (got, rep) = both(_diamond(japi), _diamond(tapi), (x, y), name="diamond")
    with tapi.use_backend("pimsab"):
        eager = _diamond(tapi)(_t(x), _t(y))
    assert_out_equal(got, jgot)
    assert torch.equal(got, eager)
    assert_reports_equal(rep, jrep)
    assert rep.kernels == ("ewise_add", "relu", "ewise_add", "ewise_add") and len(rep.per_kernel) == 4


def test_diamond_matches_jax_backends():
    x, y = ints((8, 16), seed=202), ints((8, 16), seed=203)
    with japi.use_backend("xla"):
        want = _diamond(japi)(jnp.asarray(x), jnp.asarray(y))
    with tapi.use_backend("pimsab"):
        got = tapi.trace(_diamond(tapi), name="diamond_pimsab")(_t(x), _t(y))
    device = tapi.trace(_diamond(tapi), name="diamond_device")(_t(x), _t(y))
    assert_out_equal(got, want)
    assert torch.equal(got, device)


def test_multi_output_program_returns_both_branches_on_pimsab():
    def fork(api):
        def f(x, y):
            s = api.ewise_add(x, y)
            return api.relu(s), api.ewise_add(s, x)
        return f

    x, y = ints((4, 8), seed=210), ints((4, 8), seed=211)
    (jgot, jrep), (got, rep) = both(fork(japi), fork(tapi), (x, y), name="fork")
    with tapi.use_backend("pimsab"):
        eager = fork(tapi)(_t(x), _t(y))
    assert_out_equal(got, jgot)
    assert all(torch.equal(g, e) for g, e in zip(got, eager))
    assert_reports_equal(rep, jrep)
    assert rep.dram_traffic["n1.relu"]["out"] > 0 and rep.dram_traffic["n2.ewise_add"]["out"] > 0


def test_same_kernel_multiset_different_edges_do_not_collide_in_cache():
    def wired(api):
        return lambda x, y: api.ewise_add(api.relu(x), api.relu(y))

    def rewired(api):
        def f(x, y):
            a = api.relu(x)
            api.relu(y)
            return api.ewise_add(a, a)
        return f

    x, y = ints((4, 8), -50, 50, seed=220), ints((4, 8), 10, 90, seed=221)
    outs = []
    for pkg, arr in ((japi, jnp.asarray), (tapi, _t)):
        p1 = pkg.trace(wired(pkg), name="multiset").program_for(arr(x), arr(y))
        p2 = pkg.trace(rewired(pkg), name="multiset").program_for(arr(x), arr(y))
        assert p1.kernels == p2.kernels and p1.signature() != p2.signature()
        with pkg.use_backend("pimsab"):
            ex1, ex2 = pkg.compile(p1), pkg.compile(p2)
            assert ex1 is not ex2
            outs.append((ex1(arr(x), arr(y)), ex2(arr(x), arr(y))))
    assert_out_equal(outs[1], outs[0])
    np.testing.assert_array_equal(outs[1][0].numpy(), np.maximum(x, 0) + np.maximum(y, 0))
    np.testing.assert_array_equal(outs[1][1].numpy(), np.maximum(x, 0) * 2)


def _block(api):
    def block(x, w1, w2, wh):
        y = api.relu(api.conv2d(x, w1, stride=1, padding=1, x_bits=4, w_bits=3))
        y = api.conv2d(y, w2, stride=1, padding=1, x_bits=13, w_bits=3)
        h = api.relu(api.ewise_add(y, x))
        h = api.maxpool2d(h, window=2)
        g = api.global_avgpool(h)
        return api.int_matmul(g, wh)
    return block


def test_residual_block_shape_with_conv_and_pools_on_pimsab():
    rng = np.random.default_rng(230)
    args = (rng.integers(-7, 8, (1, 4, 8, 8)).astype(np.int32), rng.integers(-3, 4, (4, 4, 3, 3)).astype(np.int32),
            rng.integers(-3, 4, (4, 4, 3, 3)).astype(np.int32), rng.integers(-3, 4, (4, 10)).astype(np.int32))
    (jgot, jrep), (got, rep) = both(_block(japi), _block(tapi), args, name="basic_block")
    assert_out_equal(got, jgot)
    assert torch.equal(got, _block(tapi)(*(_t(a) for a in args)))  # the plain versions
    assert_reports_equal(rep, jrep)
    assert any(e.startswith("n0.conv2d->") for e in rep.resident_edges)


def test_quant_linear_relu_program_block_on_pimsab():
    x, w = normals((8, 8), 5), normals((8, 16), 6) * np.float32(0.1)
    with japi.use_backend("pimsab"):
        jgot = jcommon.quant_linear_relu(jcommon.quantize_weight(jnp.asarray(w), 8), jnp.asarray(x))
    jrep = japi.last_sim_report()
    with tapi.use_backend("pimsab"):
        got = tcommon.quant_linear_relu(tcommon.quantize_weight(_t(w), 8), _t(x))
    rep = tapi.last_sim_report()
    want = np.maximum(x @ w, 0)
    rel = float(np.abs(got.numpy() - want).max() / (np.abs(want).max() + 1e-9))
    assert rel < 0.05, rel
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-6, atol=1e-6)
    assert rep.kernel == "program" and len(rep.resident_edges) == 1
    assert_reports_equal(rep, jrep)


# ---------------------------------------------------------------------------
# the program row of BENCH_kernels.json (benchmarks/kernels_bench.py
# program_mode, restated: seed 0, BENCH_TUNE budget 96, beam 4, seed 0)
# ---------------------------------------------------------------------------


def test_program_row_of_bench_kernels_reproduced_exactly():
    pinned = json.loads((REPO / "BENCH_kernels.json").read_text())["program"]
    rng = np.random.default_rng(0)
    x, w, y = (rng.integers(-100, 100, s).astype(np.int32) for s in ((16, 8), (8, 16), (16, 16)))
    xs, ws = tapi.SlicedTensor.from_int(_t(x), 8), tapi.SlicedTensor.from_int(_t(w), 8)
    tune = tapi.TuneConfig(budget=96, beam=4, seed=0)
    with tapi.tuning(tune):
        eager, eager_reports = _eager_chain(tapi, xs, ws, _t(y))
    traced = tapi.trace(_tchain, name="bench_matmul_add_relu")
    before = tapi.compile_cache_info()
    with tapi.tuning(tune), tapi.use_backend("pimsab"):
        got = traced(xs, ws, _t(y))
        rep = tapi.last_sim_report()
        tapi.compile(traced.program_for(xs, ws, _t(y)))
    after = tapi.compile_cache_info()
    eager_dram = sum(r.cycles["dram"] for r in eager_reports)
    row = {
        "chain": list(rep.kernels),
        "bit_exact_vs_eager": bool(torch.equal(got, eager)),
        "modeled_cycles": rep.total_cycles,
        "serialized_cycles": rep.serialized_cycles,
        "overlapped_cycles": rep.overlapped_cycles,
        "critical_path": {k: round(v, 1) for k, v in rep.critical_path.items()},
        "utilization": {k: round(v, 4) for k, v in rep.utilization.items()},
        "dram_cycles": rep.cycles["dram"],
        "eager_dram_cycles_sum": eager_dram,
        "eager_modeled_cycles_sum": sum(r.total_cycles for r in eager_reports),
        "dram_cycle_win": eager_dram - rep.cycles["dram"],
        "elided_dram_bits": rep.elided_dram_bits,
        "resident_edges": list(rep.resident_edges),
        "per_kernel_cycles": {p["kernel"]: p["total_cycles"] for p in rep.per_kernel},
        "autotune": dict(rep.autotune),
        "compile_cache": {"second_compile_was_hit": after.hits > before.hits,
                          "misses_added": after.misses - before.misses},
    }
    assert (row["modeled_cycles"], row["dram_cycles"], row["eager_modeled_cycles_sum"],
            row["eager_dram_cycles_sum"], row["elided_dram_bits"]) == (1546.0, 404.0, 1628.0, 808.0, 29952.0)
    assert json.loads(json.dumps(row)) == pinned


# ---------------------------------------------------------------------------
# the autotuner on programs (tests/test_autotune.py)
# ---------------------------------------------------------------------------


def _autotune_chain(api, arr):
    rng = np.random.default_rng(0)
    x, w = arr(rng.integers(-100, 100, (16, 32)).astype(np.int32)), arr(rng.integers(-100, 100, (32, 8)).astype(np.int32))
    with api.use_backend("pimsab"):
        prog = api.trace(lambda x, w: api.relu(api.int_matmul(x, w, x_bits=8, w_bits=8)),
                         name="autotune_test_chain").program_for(x, w)
    return prog, x, w


def test_compile_tune_is_cached_and_bit_exact():
    res = []
    for api, arr in ((japi, jnp.asarray), (tapi, _t)):
        prog, x, w = _autotune_chain(api, arr)
        tc = api.TuneConfig(**TC)
        with api.use_backend("pimsab"):
            ex_base = api.compile(prog)
            base = ex_base(x, w)
            ex1 = api.compile(prog, tune=tc)
            got = ex1(x, w)
            ex2, d = cache_delta(api.compile_cache_info, lambda: api.compile(prog, tune=tc))
        assert ex1 is not ex_base and ex2 is ex1 and d == (1, 0)
        assert ex1.report.total_cycles <= ex_base.report.total_cycles
        assert ex1.report.autotune["mode"] == "graph" and ex1.report.autotune["budget"] == TC["budget"]
        entries = [e for e in api.compile_cache_info().entries if "autotune" in e]
        assert entries and entries[-1]["autotune"]["mode"] == "graph"
        res.append((base, got, ex_base.report, ex1.report, entries[-1]))
    (jb, jg, jrb, jr1, je), (tb, tg, trb, tr1, te) = res
    assert_out_equal(tg, jg)
    assert_out_equal(tb, jb)
    assert torch.equal(tg, tb)
    assert_reports_equal(trb, jrb)
    assert_reports_equal(tr1, jr1)
    assert te == je


def test_tuning_scope_matches_explicit_argument():
    for api, arr in ((japi, jnp.asarray), (tapi, _t)):
        prog, _, _ = _autotune_chain(api, arr)
        tc = api.TuneConfig(**TC)
        with api.use_backend("pimsab"):
            ex_explicit = api.compile(prog, tune=tc)
            with api.tuning(tc):
                ex_scoped = api.compile(prog)
            ex_off = api.compile(prog, tune=False)
        assert ex_scoped is ex_explicit and ex_off is not ex_explicit
        assert not ex_off.report.autotune


def test_second_program_compile_hits_tune_cache():
    deltas = []
    for api, arr, autotune in ((japi, jnp.asarray, jautotune), (tapi, _t, tautotune)):
        prog, _, _ = _autotune_chain(api, arr)
        tc = api.TuneConfig(**TC)
        with api.use_backend("pimsab"):
            api.compile(prog, tune=tc)
            api.clear_compile_cache()  # force a recompile; the tune survives
            _, d = cache_delta(autotune.tune_cache_info, lambda: api.compile(prog, tune=tc))
        deltas.append(d)
    assert deltas[0] == deltas[1] == (1, 0)


# ---------------------------------------------------------------------------
# the timing-only lowering
# ---------------------------------------------------------------------------

SMALL_NET = dict(in_channels=3, input_hw=16, stem_channels=16, stem_pool="max",
                 stage_channels=(16, 32), blocks_per_stage=(1, 1), num_classes=10)


@pytest.mark.parametrize("tuned", [False, True])
def test_compile_timing_program_on_a_small_network_equals_jax(tuned):
    got = []
    for res, pb in ((jres, jpb), (tres, tpb)):
        cfg = res.ResNetConfig(**SMALL_NET)
        kw = {} if res is jres else {"device": "cpu"}
        params, x = res.init_params(cfg, **kw), res.make_input(cfg, **kw)
        prog = (japi if res is jres else tapi).trace(lambda p, v: res.forward(cfg, p, v), name="rn_timing").trace(params, x)
        tune = (japi if res is jres else tapi).TuneConfig(**TC) if tuned else False
        cg, rep = pb.compile_timing_program(prog, tune=tune)
        assert pb.timing_program_report(prog, tune=tune).to_json() == rep.to_json()
        got.append((cg, rep, pb.last_verify_report()))
    (jcg, jrep, jvr), (cg, rep, vr) = got
    assert_reports_equal(rep, jrep)
    assert [repr(i) for i in cg.program] == [repr(i) for i in jcg.program]
    assert cg.segments == jcg.segments and len(cg.program) == rep.instrs
    assert len(vr) == 1 and vr[0].ok and [d.message for d in vr[0].notes] == [d.message for d in jvr[0].notes]
    assert rep.functional_instrs == 0 and len(rep.per_kernel) == len(rep.kernels)
    assert bool(rep.autotune) == tuned


# ---------------------------------------------------------------------------
# ResidentState: the decode step with its caches bound (states=)
# ---------------------------------------------------------------------------


def _decode_steps(capacity, steps, seed, rebind):
    """Run ``steps`` decode steps in both packages with the caches bound as
    ResidentState; with ``rebind`` each step rebinds freshly copied handles
    (a scheduler swapping requests) through a second compile.  Returns the
    per-step outputs, the final handles and reports, and the cache deltas."""
    res = []
    for api, step, arr in ((japi, jstep, np.asarray), (tapi, tstep, _t)):
        cfg = step.AttnServeConfig()
        k, v = step.kv_states(cfg, capacity)
        prog = step.decode_program(cfg, capacity)
        ex, d0 = cache_delta(api.compile_cache_info, lambda: api.compile(prog, "pimsab", states={0: k, 1: v}))
        rng = np.random.default_rng(seed)
        outs, deltas = [], [d0]
        for pos in range(steps):
            q = rng.integers(-7, 8, (1, cfg.head_dim)).astype(np.int8)
            kn = rng.integers(-15, 16, cfg.head_dim).astype(np.int8)
            vn = rng.integers(-100, 100, cfg.value_dim).astype(np.int8)
            onehot = np.zeros(capacity, np.int8)
            onehot[pos] = 1
            if rebind and pos:
                k2, v2 = step.kv_states(cfg, capacity)
                k2.value, v2.value = k.value, v.value
                k, v = k2, v2
                ex2, d = cache_delta(api.compile_cache_info, lambda: api.compile(prog, "pimsab", states={0: k, 1: v}))
                assert ex2 is ex and ex.states == {0: k, 1: v}
                deltas.append(d)
            outs.append(ex(k.placeholder(), v.placeholder(), *(arr(a) for a in (q, kn, vn, onehot))))
        res.append((outs, (k.value, v.value), api.last_sim_report(), ex, deltas))
    return res


@pytest.mark.parametrize("rebind", [False, True])
def test_decode_step_with_resident_states_equals_jax(rebind):
    (jouts, jvals, jrep, jex, jd), (outs, vals, rep, ex, d) = _decode_steps(4, 3, seed=0, rebind=rebind)
    for o, jo in zip(outs, jouts):
        assert_out_equal(o, jo)
    for v, jv in zip(vals, jvals):
        assert v.dtype == torch.int64 and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), jv)
    assert d == jd and d[0] == (0, 1) and all(x == (1, 0) for x in d[1:])  # caches cleared per test
    state_edges = [e for e in rep.resident_edges if "state:" in e]
    assert len(state_edges) == 4 and state_edges == [e for e in jrep.resident_edges if "state:" in e]
    assert_reports_equal(rep, jrep)
    assert [s.spec() for s in ex.states.values()] == [s.spec() for s in jex.states.values()]
    entry = [e for e in tapi.compile_cache_info().entries if e["name"] == "decode_4x4"][-1]
    jentry = [e for e in japi.compile_cache_info().entries if e["name"] == "decode_4x4"][-1]
    assert entry["verify"] == jentry["verify"] and entry["verify"]["ok"]


def test_decode_step_declined_residency_streams_through_dram_and_equals_jax():
    (jouts, jvals, jrep, _, _), (outs, vals, rep, _, _) = _decode_steps(8, 3, seed=1, rebind=False)
    for o, jo in zip(outs, jouts):
        assert_out_equal(o, jo)
    for v, jv in zip(vals, jvals):
        np.testing.assert_array_equal(v.numpy(), jv)
    assert not any(e.startswith("state:") or "->state:" in e for e in rep.resident_edges)
    assert_reports_equal(rep, jrep)


def test_state_handle_mismatch_and_missing_handle_raise():
    cfg = tstep.AttnServeConfig()
    k, v = tstep.kv_states(cfg, 4)
    ex = tapi.compile(tstep.decode_program(cfg, 4), "pimsab", states={0: k, 1: v})
    args = [k.placeholder(), v.placeholder(), torch.zeros((1, 4), dtype=torch.int8),
            torch.zeros(4, dtype=torch.int8), torch.zeros(4, dtype=torch.int8), torch.zeros(4, dtype=torch.int8)]
    ex.bind_states({0: tapi.ResidentState(k.name, (4, 4), 7), 1: v})
    with pytest.raises(ValueError, match="does not match the compiled spec"):
        ex(*args)
    ex.bind_states({0: k})
    with pytest.raises(ValueError, match="no handle was bound"):
        ex(*args)
    with pytest.raises(NotImplementedError, match="ResidentState is a pimsab-backend concept"):
        tapi.compile(tstep.decode_program(cfg, 4), states={0: k, 1: v})


def _state_program(api, arr, second_reader=False):
    def f(kc, new, onehot, q):
        c = api.kv_append(kc, new, onehot)
        return api.attention_qk(q, kc if second_reader else c)
    return api.trace(f, name="state_prog").trace(
        arr(np.zeros((4, 4), np.int8)), arr(np.zeros(4, np.int8)), arr(np.zeros(4, np.int8)),
        arr(np.zeros((1, 4), np.int8)))


@pytest.mark.parametrize("case,match", [
    ("no updater", "needs exactly one kv_append node"),
    ("second reader", "is also read by"),
    ("spec mismatch", "does not match its updater's lowering"),
    ("too many wordlines", "exceeding the"),
])
def test_plan_states_structural_errors_equal_jax(case, match):
    msgs = []
    for api, pb, arr in ((japi, jpb, np.asarray), (tapi, tpb, _t)):
        if case == "no updater":
            prog, slots = _state_program(api, arr), {3: ("q", (1, 4), 8)}
        elif case == "second reader":
            prog, slots = _state_program(api, arr, second_reader=True), {0: ("kc", (4, 4), 8)}
        elif case == "spec mismatch":
            prog, slots = _state_program(api, arr), {0: ("kc", (4, 4), 5)}
        else:
            prog, slots = _state_program(api, arr), {0: ("kc", (4, 600), 8)}
        if case == "too many wordlines":
            # the updater's lowering must match the spec for the capacity check to be reached
            def f(kc, new, onehot):
                return api.kv_append(kc, new, onehot)
            prog = api.trace(f, name="wide_state").trace(
                arr(np.zeros((4, 600), np.int8)), arr(np.zeros(600, np.int8)), arr(np.zeros(4, np.int8)))
        node_names, lowerings, _ = pb._build_graph(prog)
        with pytest.raises(ValueError, match=match) as ei:
            pb._plan_states(prog, node_names, lowerings, pb.FUNCTIONAL_CFG.cram_rows, slots)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# the Executor's pimsab route
# ---------------------------------------------------------------------------


def test_device_and_pimsab_executors_of_one_program_do_not_collide():
    _, tops = chain_operands(seed=300)
    prog = tapi.trace(_tchain, name="two_targets").program_for(*tops)
    dev, d0 = cache_delta(tapi.compile_cache_info, lambda: tapi.compile(prog))
    pim, d1 = cache_delta(tapi.compile_cache_info, lambda: tapi.compile(prog, "pimsab"))
    unverified, d2 = cache_delta(tapi.compile_cache_info, lambda: tapi.compile(prog, "pimsab", verify=False))
    assert (d0, d1, d2) == ((0, 1), (0, 1), (0, 1))
    assert len({id(dev), id(pim), id(unverified)}) == 3
    assert dev.backend == "eager" and dev.report is None and pim.backend == "pimsab"
    entries = [e for e in tapi.compile_cache_info().entries if e["name"] == "two_targets"]
    assert [e["backend"] for e in entries] == ["eager", "pimsab", "pimsab"]
    assert entries[0]["verify"] is None and entries[1]["verify"]["ok"] and entries[2]["verify"] is None
    assert pim.verify_reports and not unverified.verify_reports
    tapi.clear_sim_report_log()
    tapi.reset_launch_counts()
    want = dev(*tops)
    assert tapi.sim_report_log() == () and dev.replay == "eager"  # the device Executor never simulates
    with tapi.use_backend("pimsab"):
        assert torch.equal(dev(*tops), want) and tapi.sim_report_log() == ()
    got = pim(*tops)  # outside the scope too: a pimsab Executor stays bound to its backend
    assert torch.equal(got, want) and pim.replay == "pimsab" and "never captures" in pim.replay_reason
    assert [r.kernel for r in tapi.sim_report_log()] == ["program"] and tapi.last_sim_report() is pim.report
    assert tapi.launch_counts() == {}
    assert torch.equal(unverified(*tops), want)


def test_pimsab_executor_refuses_a_call_during_a_capture_and_meta_leaves(monkeypatch):
    _, tops = chain_operands(seed=310)
    ex = tapi.compile(tapi.trace(_tchain, name="refusals").program_for(*tops), "pimsab")
    monkeypatch.setattr(tprogram._CudaGraph, "capturing", staticmethod(lambda: True))
    with pytest.raises(tapi.PimsabTracerError, match="capture"):
        ex(*tops)
    monkeypatch.undo()
    metas = [t.to("meta") if isinstance(t, torch.Tensor) else t for t in tprogram.tree_flatten(tops)[0]]
    with pytest.raises(tapi.PimsabTracerError, match="hold values"):
        ex._execute_leaves(metas)


def test_slot_and_constant_outputs_return_the_leaf_and_the_constant():
    x, c = _t(ints((4, 8), seed=320)), _t(ints((4, 8), seed=321))
    ex = tapi.compile(tapi.trace(lambda v: (tapi.relu(v), v, c), name="passthrough").program_for(x), "pimsab")
    r, v, k = ex(x)
    assert v is x and k is ex.program.consts[0] and torch.equal(k, c)
    assert torch.equal(r, torch.clamp_min(x, 0)) and r.dtype == torch.int32


def test_a_kernel_without_program_lowering_raises(monkeypatch):
    x = _t(ints((4, 8), seed=330))
    prog = tapi.trace(lambda v: tapi.relu(v), name="no_lowering").program_for(x)
    monkeypatch.delitem(tpb._PROGRAM_LOWERINGS, "relu")
    with pytest.raises(NotImplementedError, match="has no program lowering for the pimsab backend"):
        tapi.compile(prog, "pimsab")


def test_last_verify_report_reads_the_program_compile():
    _, tops = chain_operands(seed=340)
    prog = tapi.trace(_tchain, name="verify_reports").program_for(*tops)
    ex = tapi.compile(prog, "pimsab")
    assert tapi.last_verify_report() == ex.verify_reports and len(ex.verify_reports) == 2
    assert all(r.ok for r in ex.verify_reports)


def test_a_verifier_error_raises_and_caches_nothing(monkeypatch):
    from repro_torch.core.compiler.verify import Diagnostic, VerifierError, VerifyReport

    x = _t(ints((4, 8), seed=350))
    prog = tapi.trace(lambda v: tapi.relu(v), name="verifier_error").program_for(x)
    bad = VerifyReport("bad", 1, (Diagnostic("E-TEST", "error", "injected"),))
    monkeypatch.setattr(tpb, "verify_graph", lambda cg, cfg: bad)
    size = tapi.compile_cache_info().size
    with pytest.raises(VerifierError, match="injected"):
        tapi.compile(prog, "pimsab")
    assert tapi.compile_cache_info().size == size
    assert tapi.compile(prog, "pimsab", verify=False)(x).equal(torch.clamp_min(x, 0))
