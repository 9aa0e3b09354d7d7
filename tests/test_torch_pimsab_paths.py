"""The port's eager pimsab backend on its paths, against the JAX package.

* The scope's boundaries: ``use_backend`` takes only ``"pimsab"``; a Program
  compiled inside the scope gives a pimsab Executor (the Program lowering,
  ``tests/test_torch_pimsab_program.py``); an Executor compiled outside runs
  its ops on their device inside the scope and never reaches the simulator.
* The ``large_shapes`` rows of ``BENCH_kernels.json``: the three workloads
  of ``benchmarks/kernels_bench.py``, restated on the port's DSL and modeled
  by the port's ``timing_report`` on the full PIMSAB machine under the
  benchmark's tuning budget, reproduce every pinned number.
* The eager ``MICRO`` residual network (``tests/test_resnet_e2e.py``) under
  the scope: logits equal to JAX's eager forward under
  ``use_backend("pimsab")`` and to the device forward, with the same report
  sequence.
* The paper-scale cases of ``tests/test_pimsab_conformance.py`` on
  ``FUNCTIONAL_CFG_LARGE`` (slow tier).
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import api as japi  # noqa: E402
from repro.kernels import pimsab_backend as jpb  # noqa: E402
from repro.models import resnet as jresnet  # noqa: E402
from repro_torch.core.compiler.tensor_dsl import Loop, Ref, Workload  # noqa: E402
from repro_torch.kernels import api as tapi  # noqa: E402
from repro_torch.kernels import pimsab_backend as tpb  # noqa: E402
from repro_torch.models import resnet as tres  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _ints(shape, lo, hi, seed=0):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the scope's boundaries
# ---------------------------------------------------------------------------


def _block(x, y):
    return tapi.relu(tapi.ewise_add(tapi.relu(x), y))


def test_use_backend_takes_only_pimsab():
    for name in ("xla", "interpret", "pallas", "cuda"):
        with pytest.raises(ValueError, match="no backend scope"):
            with tapi.use_backend(name):
                pass
    assert tapi.BACKENDS == ("pimsab",) and tapi.current_backend() is None
    with tapi.use_backend("pimsab"):
        with tapi.use_backend("pimsab"):
            assert tapi.current_backend() == "pimsab"
        assert tapi.current_backend() == "pimsab"
    assert tapi.current_backend() is None


def _jblock(x, y):
    return japi.relu(japi.ewise_add(japi.relu(x), y))


def test_compile_inside_the_scope_raises_naming_item_5c():
    """A compile inside the scope (item 5c, now ported) gives the pimsab
    Executor that ``backend="pimsab"`` gives, and ``api.trace(...)(...)``
    runs through it; outputs and reports equal JAX's."""
    xn, yn = _ints((4, 8), -50, 50, 1), _ints((4, 8), -50, 50, 2)
    x, y = _t(xn), _t(yn)
    prog = tapi.trace(_block, name="scope_block").program_for(x, y)
    with japi.use_backend("pimsab"):
        want = japi.trace(_jblock, name="scope_block")(jnp.asarray(xn), jnp.asarray(yn))
    jrep = japi.last_sim_report()
    with tapi.use_backend("pimsab"):
        ex = tapi.compile(prog)
        got = ex(x, y)
        assert tapi.last_sim_report().to_json() == jrep.to_json()
        traced = tapi.trace(_block, name="scope_block")(x, y)
        assert tapi.last_sim_report().to_json() == jrep.to_json()
    assert ex.backend == "pimsab" and ex.replay == "pimsab"
    assert tapi.compile(prog, backend="pimsab") is ex
    assert np.array_equal(got.numpy(), np.asarray(want)) and torch.equal(traced, got)
    assert ex.report.to_json() == jrep.to_json()


def test_an_executor_called_inside_the_scope_runs_on_its_device():
    x, y = _t(_ints((4, 8), -50, 50, 3)), _t(_ints((4, 8), -50, 50, 4))
    ex = tapi.compile(tapi.trace(_block, name="scope_exec").program_for(x, y))
    want = torch.clamp_min(torch.clamp_min(x, 0) + y, 0)
    tapi.clear_sim_report_log()
    with tapi.use_backend("pimsab"):
        got = ex(x, y)
        assert tapi.sim_report_log() == ()
        eager = tapi.relu(x)  # a call outside the Executor still lowers
    assert torch.equal(got, want) and torch.equal(eager, torch.clamp_min(x, 0))
    assert [r.kernel for r in tapi.sim_report_log()] == ["relu"]


# ---------------------------------------------------------------------------
# BENCH_kernels.json's large_shapes rows
# ---------------------------------------------------------------------------


def _large_shape_workloads():
    """``benchmarks/kernels_bench.py``'s ``_large_shape_workloads``, restated
    on the port's DSL (the benchmark itself is the JAX package's)."""
    gemm = Workload(
        name="matmul_256x1024x1024_i8",
        loops=(Loop("x", 256, "data"), Loop("y", 1024, "data"), Loop("k", 1024, "reduce")),
        out=Ref("c", ("x", "y"), prec=32),
        ins=(Ref("a", ("x", "k"), prec=9), Ref("b", ("k", "y"), prec=9)),
        op="mac",
        acc_prec=32,
    )
    ewise = Workload(
        name="ewise_add_65536_i16",
        loops=(Loop("i", 65536, "data"),),
        out=Ref("y", ("i",), prec=17),
        ins=(Ref("xa", ("i",), prec=16), Ref("xb", ("i",), prec=16)),
        op="map_add",
        acc_prec=17,
    )
    relu = Workload(
        name="relu_65536_i16",
        loops=(Loop("i", 65536, "data"),),
        out=Ref("y", ("i",), prec=16),
        ins=(Ref("xa", ("i",), prec=16), Ref("z", ("i",), prec=16, is_const=True, const_value=0)),
        op="relu",
        acc_prec=16,
    )
    return [gemm, ewise, relu]


def _large_shape_row(w):
    """One ``large_shapes`` row, built as ``kernels_bench.large_shapes`` does,
    under its tuning budget ``TuneConfig(budget=96, beam=4, seed=0)``."""
    rep = tpb.timing_report(w, kernel=w.name, tune=tapi.TuneConfig(budget=96, beam=4, seed=0))
    return {
        "workload": w.name,
        "modeled_cycles": rep.total_cycles,
        "serialized_cycles": rep.serialized_cycles,
        "overlapped_cycles": rep.overlapped_cycles,
        "modeled_seconds": rep.modeled_seconds,
        "cycle_breakdown": {k: round(v, 4) for k, v in rep.cycle_breakdown.items()},
        "critical_path": {k: round(v, 1) for k, v in rep.critical_path.items()},
        "utilization": {k: round(v, 4) for k, v in rep.utilization.items()},
        "double_buffered": rep.mapping["double_buffered"],
        "serial_iters": rep.mapping["serial_iters"],
        "instrs": rep.instrs,
        "autotune": dict(rep.autotune),
    }


def test_the_restated_large_shapes_are_the_benchmarks():
    from benchmarks import kernels_bench

    assert [repr(w) for w in _large_shape_workloads()] == [
        repr(w) for w in kernels_bench._large_shape_workloads()]


def test_large_shapes_rows_of_bench_kernels_reproduced_exactly():
    pinned = json.loads((REPO / "BENCH_kernels.json").read_text())["large_shapes"]
    rows = [json.loads(json.dumps(_large_shape_row(w))) for w in _large_shape_workloads()]
    assert [(r["workload"], r["modeled_cycles"], r["serialized_cycles"], r["overlapped_cycles"], r["instrs"])
            for r in rows] == [
        ("matmul_256x1024x1024_i8", 12045.0, 23553.0, 11508.0, 81),
        ("ewise_add_65536_i16", 461.0, 1596.0, 1135.0, 16),
        ("relu_65536_i16", 370.0, 1220.0, 850.0, 24),
    ]
    assert rows == pinned


# ---------------------------------------------------------------------------
# the eager MICRO residual network
# ---------------------------------------------------------------------------

MICRO = dict(in_channels=2, input_hw=8, stem_channels=4, stem_pool="max",
             stage_channels=(4,), blocks_per_stage=(1,), num_classes=5)


def test_eager_micro_resnet_under_the_scope_equals_jax():
    jcfg, tcfg = jresnet.ResNetConfig(**MICRO), tres.ResNetConfig(**MICRO)
    jparams = jresnet.init_params(jcfg, seed=0)
    jx = jresnet.make_input(jcfg, batch=1, seed=1)
    japi.clear_sim_report_log()
    with japi.use_backend("pimsab"):
        want = np.asarray(jresnet.forward(jcfg, jparams, jx))
    jlog = japi.sim_report_log()

    params = tres.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    x = _t(np.asarray(jx))
    assert torch.equal(x, tres.make_input(tcfg, 1, seed=1, device="cpu"))
    device_logits = tres.forward(tcfg, params, x)
    tapi.clear_sim_report_log()
    with tapi.use_backend("pimsab"):
        got = tres.ResNet(tcfg, params, device="cpu")(x)
    log = tapi.sim_report_log()

    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert torch.equal(got, device_logits)
    assert [r.kernel for r in log] == tres.layer_names(tcfg) == [r.kernel for r in jlog]
    assert [r.to_json() for r in log] == [r.to_json() for r in jlog]


# ---------------------------------------------------------------------------
# paper scale (slow tier, as in the JAX conformance tests)
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_paper_scale_int_matmul_256x1024x1024_equals_jax():
    x, w = _ints((256, 1024), -128, 128, 50), _ints((1024, 1024), -128, 128, 51)
    with tpb.functional_config(tpb.FUNCTIONAL_CFG_LARGE), tapi.use_backend("pimsab"):
        got = tapi.int_matmul(_t(x), _t(w), x_bits=8, w_bits=8)
        rep = tapi.last_sim_report()
    assert torch.equal(got, tapi.int_matmul(_t(x), _t(w)))
    with jpb.functional_config(jpb.FUNCTIONAL_CFG_LARGE), japi.use_backend("pimsab"):
        want = japi.int_matmul(jnp.asarray(x), jnp.asarray(w), x_bits=8, w_bits=8)
        jrep = japi.last_sim_report()
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert rep.to_json() == jrep.to_json() and rep.functional_instrs > 0


@pytest.mark.slow
def test_paper_scale_ewise_64k_int32_wrap_equals_jax():
    m = 2**31 - 1
    x, y = _ints((256, 256), -m, m, 52), _ints((256, 256), -m, m, 53)
    with tpb.functional_config(tpb.FUNCTIONAL_CFG_LARGE), tapi.use_backend("pimsab"):
        got = tapi.ewise_add(_t(x), _t(y))
        rep = tapi.last_sim_report()
    assert torch.equal(got, _t(x) + _t(y))
    with jpb.functional_config(jpb.FUNCTIONAL_CFG_LARGE), japi.use_backend("pimsab"):
        japi.ewise_add(jnp.asarray(x), jnp.asarray(y))
        jrep = japi.last_sim_report()
    assert rep.to_json() == jrep.to_json()
