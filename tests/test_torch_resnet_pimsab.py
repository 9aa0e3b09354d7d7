"""The paper's end-to-end ResNet on the port's pimsab Program lowering.

``api.trace(lambda p, v: resnet.forward(cfg, p, v))`` under
``use_backend("pimsab")`` compiles the whole network into one fused
``WorkloadGraph`` and runs it bit-exactly on the port's functional
simulator, as ``tests/test_resnet_e2e.py`` does in the JAX package: the
counterparts of its cases over the same seeded parameters and inputs
(outputs bit-equal, ``SimReport`` s field-equal), the traced ``TINY`` under
``benchmarks/e2e_resnet.py``'s ``DEFAULT_TUNE`` reproducing
``BENCH_kernels.json``'s ``e2e.tiny`` row, the paper-shaped ``RESNET18``
through ``timing_program_report`` reproducing ``e2e.resnet18`` tuned and
JAX's report untuned, and (slow tier) ``TINY`` and ``RESNET18`` bit-exact on
``FUNCTIONAL_CFG_LARGE``.
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
from repro.models import resnet as jres  # noqa: E402
from repro_torch.kernels import api as tapi  # noqa: E402
from repro_torch.kernels import pimsab_backend as tpb  # noqa: E402
from repro_torch.models import resnet as tres  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
E2E = json.loads((REPO / "BENCH_kernels.json").read_text())["e2e"]
# benchmarks/e2e_resnet.py's DEFAULT_TUNE, restated (benchmarks/ is the JAX package's)
DEFAULT_TUNE = dict(budget=256, beam=4, seed=0)
MICRO = dict(in_channels=2, input_hw=8, stem_channels=4, stem_pool="max",
             stage_channels=(4,), blocks_per_stage=(1,), num_classes=5)
REPORT_FIELDS = ("kernel", "workload", "total_cycles", "serialized_cycles", "overlapped_cycles", "cycles",
                 "energy_j", "instrs", "instr_mix", "functional_instrs", "kernels", "per_kernel",
                 "dram_traffic", "resident_edges", "elided_dram_bits", "autotune")


def assert_reports_equal(got, want):
    for f in REPORT_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.to_json() == want.to_json()


def _params(cfg_kw, seed, in_seed, batch=1):
    """Both packages' params and input: JAX's, and the port's from the same
    numpy arrays (equal to the port's own ``init_params``/``make_input``)."""
    jcfg, tcfg = jres.ResNetConfig(**cfg_kw), tres.ResNetConfig(**cfg_kw)
    jp, jx = jres.init_params(jcfg, seed=seed), jres.make_input(jcfg, batch=batch, seed=in_seed)
    tp = tres.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    tx = torch.from_numpy(np.array(jx))
    assert torch.equal(tx, tres.make_input(tcfg, batch, seed=in_seed, device="cpu"))
    return (jcfg, jp, jx), (tcfg, tp, tx)


def _run_both(cfg_kw, seed=0, name=None):
    (jcfg, jp, jx), (tcfg, tp, tx) = _params(cfg_kw, seed, seed + 1)
    name = name or f"rn_{cfg_kw['input_hw']}"
    with japi.use_backend("pimsab"):
        jgot = japi.trace(lambda p, v: jres.forward(jcfg, p, v), name=name)(jp, jx)
    jrep = japi.last_sim_report()
    with tapi.use_backend("pimsab"):
        got = tapi.trace(lambda p, v: tres.forward(tcfg, p, v), name=name)(tp, tx)
    rep = tapi.last_sim_report()
    return tcfg, (tp, tx), (jgot, jrep), (got, rep)


def test_micro_resnet_bit_exact_on_pimsab():
    cfg, (tp, tx), (jgot, jrep), (got, rep) = _run_both(MICRO)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(jgot))
    assert torch.equal(got, tres.forward(cfg, tp, tx))
    assert_reports_equal(rep, jrep)
    assert rep.kernel == "program" and list(rep.kernels) == tres.layer_names(cfg)
    assert len(rep.resident_edges) >= 1 and rep.elided_dram_bits > 0
    assert [p["kernel"] for p in rep.per_kernel] == list(rep.kernels)
    assert sum(p["total_cycles"] for p in rep.per_kernel) == pytest.approx(rep.total_cycles)


def test_avg_stem_resnet_bit_exact_with_adversarial_magnitudes():
    kw = dict(MICRO, stem_pool="avg")
    jcfg, tcfg = jres.ResNetConfig(**kw), tres.ResNetConfig(**kw)
    jp = jres.init_params(jcfg, seed=11)
    jx = jnp.full((1, 2, 8, 8), 2 ** (jcfg.input_bits - 1) - 1, jnp.int32)
    jp["stem"] = jnp.full_like(jp["stem"], 2 ** (jcfg.weight_bits - 1) - 1)
    tp = tres.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    tx = torch.from_numpy(np.array(jx))
    with japi.use_backend("pimsab"):
        jgot = japi.trace(lambda p, v: jres.forward(jcfg, p, v), name="rn_avgstem")(jp, jx)
    jrep = japi.last_sim_report()
    with tapi.use_backend("pimsab"):
        got = tapi.trace(lambda p, v: tres.forward(tcfg, p, v), name="rn_avgstem")(tp, tx)
    rep = tapi.last_sim_report()
    assert np.array_equal(got.numpy(), np.asarray(jgot))
    assert torch.equal(got, tres.forward(tcfg, tp, tx))
    assert list(rep.kernels) == tres.layer_names(tcfg)
    assert_reports_equal(rep, jrep)


def test_micro_resnet_executor_replays_with_fresh_input():
    (jcfg, jp, jx1), (tcfg, tp, tx1) = _params(MICRO, 3, 4)
    (_, _, jx2), (_, _, tx2) = _params(MICRO, 3, 5)
    with japi.use_backend("pimsab"):
        jex = japi.compile(japi.trace(lambda p, v: jres.forward(jcfg, p, v), name="rn_replay").program_for(jp, jx1))
        jgot = jex(jp, jx2)
    with tapi.use_backend("pimsab"):
        ex = tapi.compile(tapi.trace(lambda p, v: tres.forward(tcfg, p, v), name="rn_replay").program_for(tp, tx1))
        got1 = ex(tp, tx1)
        got2 = ex(tp, tx2)
    assert ex.backend == "pimsab" and ex.replay == "pimsab"
    assert np.array_equal(got2.numpy(), np.asarray(jgot))
    assert torch.equal(got2, tres.forward(tcfg, tp, tx2)) and torch.equal(got1, tres.forward(tcfg, tp, tx1))
    assert_reports_equal(ex.report, jex.report)


def test_timing_only_lowering_models_full_network():
    kw = dict(in_channels=3, input_hw=16, stem_channels=16, stem_pool="max",
              stage_channels=(16, 32), blocks_per_stage=(1, 1), num_classes=10)
    (jcfg, jp, jx), (tcfg, tp, tx) = _params(kw, 0, 1)
    jrep = jpb.timing_program_report(japi.trace(lambda p, v: jres.forward(jcfg, p, v), name="rn_timing").trace(jp, jx))
    rep = tpb.timing_program_report(tapi.trace(lambda p, v: tres.forward(tcfg, p, v), name="rn_timing").trace(tp, tx))
    assert list(rep.kernels) == tres.layer_names(tcfg)
    assert rep.total_cycles > 0 and rep.energy_j > 0 and len(rep.per_kernel) == len(rep.kernels)
    assert rep.functional_instrs == 0
    assert_reports_equal(rep, jrep)


def _per_layer(rep):
    return [{k: p[k] for k in ("node", "kernel", "total_cycles", "serialized_cycles", "dram_cycles")}
            for p in rep.per_kernel]


def test_traced_tiny_reproduces_e2e_tiny_of_bench_kernels():
    """``benchmarks/e2e_resnet.py``'s ``run_tiny`` on the port: TINY with
    params from seed 0 and the input from seed 1, compiled under
    ``DEFAULT_TUNE``, executed bit-exactly, second compile a cache hit."""
    cfg = tres.TINY
    params = tres.init_params(cfg, seed=0, device="cpu")
    x = tres.make_input(cfg, batch=1, seed=1, device="cpu")
    want = tres.forward(cfg, params, x)  # the plain versions, equal to JAX's xla forward
    traced = tapi.trace(lambda p, v: tres.forward(cfg, p, v), name="resnet_tiny")
    tapi.clear_compile_cache()
    before = tapi.compile_cache_info()
    with tapi.tuning(tapi.TuneConfig(**DEFAULT_TUNE)), tapi.use_backend("pimsab"):
        got = traced(params, x)
        rep = tapi.last_sim_report()
        tapi.compile(traced.program_for(params, x))  # identical signature
    after = tapi.compile_cache_info()
    row = {
        "config": "TINY",
        "layers": len(rep.kernels),
        "kernels": list(rep.kernels),
        "bit_exact_vs_oracle": bool(torch.equal(got, want)),
        "modeled_cycles": rep.total_cycles,
        "serialized_cycles": rep.serialized_cycles,
        "overlapped_cycles": rep.overlapped_cycles,
        "dram_cycles": rep.cycles["dram"],
        "modeled_seconds": rep.modeled_seconds,
        "energy_j": rep.energy_j,
        "cycle_breakdown": {k: round(v, 4) for k, v in rep.cycle_breakdown.items()},
        "utilization": {k: round(v, 4) for k, v in rep.utilization.items()},
        "resident_edges": list(rep.resident_edges),
        "elided_dram_bits": rep.elided_dram_bits,
        "per_layer": _per_layer(rep),
        "autotune": dict(rep.autotune),
        "compile_cache": {"second_compile_was_hit": after.hits > before.hits,
                          "misses_added": after.misses - before.misses},
    }
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert (row["layers"], row["modeled_cycles"], row["serialized_cycles"], row["overlapped_cycles"],
            row["dram_cycles"], len(row["resident_edges"]), row["elided_dram_bits"]) == (
        16, 33367.0, 50838.0, 17471.0, 17776.0, 7, 55552.0)
    assert json.loads(json.dumps(row)) == E2E["tiny"]


def _resnet18_timing(tune):
    cfg = tres.RESNET18
    params = tres.init_params(cfg, seed=0, device="cpu")
    x = tres.make_input(cfg, batch=1, seed=1, device="cpu")
    prog = tapi.trace(lambda p, v: tres.forward(cfg, p, v), name="resnet18").trace(params, x)
    return tpb.timing_program_report(prog, tune=tune)


def test_resnet18_timing_tuned_reproduces_e2e_resnet18_of_bench_kernels():
    """``benchmarks/e2e_resnet.py``'s ``run_resnet18_timing`` on the port."""
    rep = _resnet18_timing(tapi.TuneConfig(**DEFAULT_TUNE))
    row = {
        "config": "RESNET18",
        "layers": len(rep.kernels),
        "modeled_cycles": rep.total_cycles,
        "serialized_cycles": rep.serialized_cycles,
        "overlapped_cycles": rep.overlapped_cycles,
        "dram_cycles": rep.cycles["dram"],
        "modeled_seconds": rep.modeled_seconds,
        "energy_j": rep.energy_j,
        "cycle_breakdown": {k: round(v, 4) for k, v in rep.cycle_breakdown.items()},
        "resident_edges": len(rep.resident_edges),
        "elided_dram_bits": rep.elided_dram_bits,
        "per_layer": _per_layer(rep),
        "autotune": dict(rep.autotune),
    }
    assert (row["layers"], row["modeled_cycles"], row["serialized_cycles"], row["overlapped_cycles"],
            row["dram_cycles"], row["resident_edges"], row["elided_dram_bits"]) == (
        47, 132758.0, 255863.0, 123105.0, 98671.0, 9, 18612224.0)
    # energy_j is a float sum of per-category picojoules whose last bit
    # depends on the host's numpy: the JAX package itself gives
    # 0.008859532486079999 here against the pinned ...079997, and the port
    # equals it (test_resnet18_timing_untuned_equals_jax holds the whole
    # report, energy included, equal to JAX's)
    pinned = dict(E2E["resnet18"])
    assert row.pop("energy_j") == pytest.approx(pinned.pop("energy_j"), rel=1e-12, abs=0)
    assert json.loads(json.dumps(row)) == pinned


def test_resnet18_timing_untuned_equals_jax():
    rep = _resnet18_timing(False)
    jcfg = jres.RESNET18
    jprog = japi.trace(lambda p, v: jres.forward(jcfg, p, v), name="resnet18").trace(
        jres.init_params(jcfg, seed=0), jres.make_input(jcfg, batch=1, seed=1))
    jrep = jpb.timing_program_report(jprog, tune=False)
    assert rep.total_cycles == 132930.0 and not rep.autotune
    assert_reports_equal(rep, jrep)


# ---------------------------------------------------------------------------
# paper scale, bit-exact on the 16-tile × 4-CRAM functional machine (slow tier)
# ---------------------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("name", ["TINY", "RESNET18"])
def test_resnet_bit_exact_on_functional_cfg_large(name):
    cfg, jcfg = getattr(tres, name), getattr(jres, name)
    params = tres.init_params(cfg, seed=0, device="cpu")
    x = tres.make_input(cfg, batch=1, seed=1, device="cpu")
    with japi.use_backend("xla"):
        want = jres.forward(jcfg, jres.init_params(jcfg, seed=0), jres.make_input(jcfg, batch=1, seed=1))
    traced = tapi.trace(lambda p, v: tres.forward(cfg, p, v), name=f"rn_large_{name}")
    with tpb.functional_config(tpb.FUNCTIONAL_CFG_LARGE), tapi.use_backend("pimsab"):
        got = traced(params, x)
        rep = tapi.last_sim_report()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, tres.forward(cfg, params, x))
    assert list(rep.kernels) == tres.layer_names(cfg)
    assert rep.functional_instrs > 0  # really executed, not timing-modeled
