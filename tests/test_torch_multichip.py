"""The port's multi-chip scale-out (``repro_torch.kernels.multichip``) against
the JAX package's.

Every case of ``tests/test_multichip.py``, with the port and the JAX package
side by side on the same workloads and the same numpy-seeded operands: the
matmul chain, the conv block and the attention decode step at meshes 1×2,
2×2 and 2×4 under the auto, forced tensor-parallel and forced pipeline
plans, and the transformer decode layer at 2, 4 and 8 chips.  Outputs are
bit-equal to JAX's and to the port's one-chip pimsab Executor (int32, no
tolerance); plans, notes and segments equal; ``ClusterReport.to_json()``
equal to JAX's, ``energy_j`` within 1e-12 relative (a float sum of
per-category picojoules; every other field exactly).  Then the chips=1
passthrough, the ``api.compile`` routing and both refusals, the compile
cache, the timeline invariants, the golden inter-chip allreduce timeline
(``tests/golden/interchip_allreduce_timeline.json``, rebuilt from the port's
``core`` as ``scripts/make_golden_interchip.py`` builds it, read only), the
per-chip streams re-verified by the port's static verifier as
``scripts/check_isa.py`` does, and the executor's edges: results on the
first operand's device, no launch counted, refusals during a CUDA graph
capture and of operands without values.
"""
import functools
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import api as japi  # noqa: E402
from repro.kernels import multichip as jmc  # noqa: E402
from repro.serve import pimsab_step as jstep  # noqa: E402
from repro_torch.core import isa as tisa  # noqa: E402
from repro_torch.core.compiler.verify import verify_stream  # noqa: E402
from repro_torch.core.machine import PIMSAB  # noqa: E402
from repro_torch.core.noc import ChipCluster  # noqa: E402
from repro_torch.core.simulator import Simulator  # noqa: E402
from repro_torch.kernels import api as tapi  # noqa: E402
from repro_torch.kernels import multichip as tmc  # noqa: E402
from repro_torch.kernels import pimsab_backend as tpb  # noqa: E402
from repro_torch.kernels import program as tprogram  # noqa: E402
from repro_torch.models import resnet as tres  # noqa: E402
from repro_torch.serve import pimsab_step as tstep  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
MESHES = [(1, 2), (2, 2), (2, 4)]
ENERGY_RTOL = 1e-12


# ---------------------------------------------------------------------------
# workloads: tests/test_multichip.py's, traced by both packages
# ---------------------------------------------------------------------------


def _matmul_chain_fn(api):
    def f(x, w1, w2):
        h = api.relu(api.int_matmul(x, w1, x_bits=4, w_bits=4))
        return api.int_matmul(h, w2, w_bits=4)
    return f


def _conv_block_fn(api):
    def f(x, w1, w2):
        h = api.relu(api.conv2d(x, w1, padding=1, x_bits=3, w_bits=3))
        return api.conv2d(h, w2, padding=1, w_bits=3)
    return f


def _attn_decode_fn(api):
    def f(q, kc, vc):
        s = api.attention_qk(q, kc, q_bits=3, k_bits=3, out_bits=10)
        p = api.softmax_fixedpoint(s, in_frac=7)
        return api.attention_pv(p, vc)
    return f


# name → (traced function, slot shapes, seed, value range)
SPECS = {
    "matmul_chain": (_matmul_chain_fn, ((4, 16), (16, 16), (16, 8)), 11, 4),
    "conv_block": (_conv_block_fn, ((1, 8, 6, 6), (8, 8, 3, 3), (8, 8, 3, 3)), 12, 3),
    "attn_decode": (_attn_decode_fn, ((1, 16), (8, 16), (8, 16)), 13, 3),
}
PROG_NAMES = {"matmul_chain": "mc_matmul_chain", "conv_block": "mc_conv_block", "attn_decode": "mc_attn_decode"}


@functools.lru_cache(maxsize=None)
def _workload(name):
    """Both packages' Programs of ``name`` and its operands (numpy)."""
    fn, shapes, seed, r = SPECS[name]
    zeros = [np.zeros(s, np.int8) for s in shapes]
    jprog = japi.trace(fn(japi), name=PROG_NAMES[name]).trace(*zeros)
    tprog = tapi.trace(fn(tapi), name=PROG_NAMES[name]).trace(*(torch.from_numpy(z) for z in zeros))
    rng = np.random.default_rng(seed)
    args = tuple(rng.integers(-r, r + 1, s, dtype=np.int8) for s in shapes)
    return jprog, tprog, args


def _decode_layer_args():
    rng = np.random.default_rng(7)
    D = 16
    return (rng.integers(-3, 4, (8, D), dtype=np.int8),
            rng.integers(-3, 4, (8, D), dtype=np.int8),
            rng.integers(-3, 4, (1, D), dtype=np.int8),
            rng.integers(-7, 8, (D, 256), dtype=np.int8),
            rng.integers(-7, 8, (256, 512), dtype=np.int8),
            rng.integers(-7, 8, (512, 256), dtype=np.int8))


@functools.lru_cache(maxsize=None)
def _decode_layer():
    return jstep.decode_layer_program(), tstep.decode_layer_program(), _decode_layer_args()


def _t(args):
    return [torch.from_numpy(np.array(a)) for a in args]


@functools.lru_cache(maxsize=None)
def _one_chip(name):
    """The port's one-chip pimsab Executor output of a workload (numpy)."""
    _, tprog, args = _decode_layer() if name == "decode_layer" else _workload(name)
    return tapi.compile(tprog, "pimsab")(*_t(args)).numpy()


def assert_reports_equal(got, want):
    """Port and JAX ``ClusterReport`` s: every field exactly, ``energy_j``
    within 1e-12 relative."""
    g, w = json.loads(json.dumps(got.to_json())), json.loads(json.dumps(want.to_json()))
    ge, we = g.pop("energy_j"), w.pop("energy_j")
    assert ge == pytest.approx(we, rel=ENERGY_RTOL, abs=0)
    assert g == w


def _both(name, mesh=None, chips=None, plan="auto"):
    """Compile ``name`` for the cluster in both packages; run both on the
    workload's operands.  Returns (jex, tex, jout, tout)."""
    jprog, tprog, args = _decode_layer() if name == "decode_layer" else _workload(name)
    kw = dict(plan=plan)
    jkw = dict(kw, cluster=japi.ChipCluster(mesh=mesh)) if mesh else dict(kw, chips=chips)
    tkw = dict(kw, cluster=tapi.ChipCluster(mesh=mesh)) if mesh else dict(kw, chips=chips)
    jex = japi.compile_cluster(jprog, **jkw)
    tex = tapi.compile_cluster(tprog, **tkw)
    tapi.reset_launch_counts()
    tout = tex(*_t(args))
    assert tapi.launch_counts() == {}
    return jex, tex, np.asarray(jex(*args)), tout


def assert_cluster_equal(jex, tex, jout, tout, name):
    assert isinstance(tex, tapi.ClusterExecutor) and tex.backend == "pimsab"
    assert isinstance(tout, torch.Tensor) and tout.device.type == "cpu" and tout.dtype == torch.int32
    np.testing.assert_array_equal(tout.numpy(), jout)
    np.testing.assert_array_equal(tout.numpy(), _one_chip(name))
    assert tex.plan == jex.plan and tex.notes == jex.notes
    assert tex.cluster.mesh == jex.cluster.mesh and tex.cluster.chips == jex.cluster.chips
    assert [(cs.seg.idxs, cs.seg.shard, cs.sub.name, cs.report.total_cycles) for cs in tex._segments] == \
        [(cs.seg.idxs, cs.seg.shard, cs.sub.name, cs.report.total_cycles) for cs in jex._segments]
    assert_reports_equal(tex.report, jex.report)
    assert len(tex.verify_reports) == len(jex.verify_reports)
    assert [v.to_json() for v in tex.verify_reports] == [v.to_json() for v in jex.verify_reports]


# ---------------------------------------------------------------------------
# sharded bit-exactness across meshes and plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", list(SPECS))
def test_sharded_bit_exact_auto(name, mesh):
    jex, tex, jout, tout = _both(name, mesh=mesh)
    assert tex.plan in ("tp", "pp", "replicated")
    assert_cluster_equal(jex, tex, jout, tout, name)
    assert any(n.startswith("N-PLAN-CHIP") for n in tex.notes)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", list(SPECS))
def test_sharded_bit_exact_forced_tp(name, mesh):
    jex, tex, jout, tout = _both(name, mesh=mesh, plan="tp")
    assert tex.plan in ("tp", "replicated")
    assert_cluster_equal(jex, tex, jout, tout, name)


@pytest.mark.parametrize("name", list(SPECS))
def test_sharded_bit_exact_forced_pp(name):
    jex, tex, jout, tout = _both(name, mesh=(1, 2), plan="pp")
    assert tex.plan == "pp"
    assert any(tmc.NOTE_CHIP_PP in n for n in tex.notes)
    assert_cluster_equal(jex, tex, jout, tout, name)


def test_decode_layer_forced_pp_2x2_bit_exact():
    jex, tex, jout, tout = _both("decode_layer", mesh=(2, 2), plan="pp")
    assert tex.plan == "pp"
    assert_cluster_equal(jex, tex, jout, tout, "decode_layer")


def test_forced_pp_declined_raises():
    jprog, tprog, _ = _workload("matmul_chain")
    with pytest.raises(ValueError, match="pipeline plan") as te:
        tapi.compile_cluster(tprog, cluster=tapi.ChipCluster(mesh=(2, 4)), plan="pp")
    with pytest.raises(ValueError, match="pipeline plan") as je:
        japi.compile_cluster(jprog, cluster=japi.ChipCluster(mesh=(2, 4)), plan="pp")
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="unknown cluster plan"):
        tapi.compile_cluster(tprog, chips=2, plan="dp")


def test_declined_tp_falls_back_replicated_bit_exact():
    def f(api):
        def g(x, w):
            return api.int_matmul(x, w, x_bits=3, w_bits=3)
        return g

    z = (np.zeros((2, 8), np.int8), np.zeros((8, 4), np.int8))
    jprog = japi.trace(f(japi), name="mc_tiny_mm").trace(*z)
    tprog = tapi.trace(f(tapi), name="mc_tiny_mm").trace(*_t(z))
    rng = np.random.default_rng(5)
    a = rng.integers(-3, 4, (2, 8), dtype=np.int8)
    b = rng.integers(-3, 4, (8, 4), dtype=np.int8)
    jex = japi.compile_cluster(jprog, cluster=japi.ChipCluster(mesh=(4, 4)), plan="tp")
    tex = tapi.compile_cluster(tprog, cluster=tapi.ChipCluster(mesh=(4, 4)), plan="tp")
    assert tex.plan == "replicated"
    assert any(n.startswith(tmc.NOTE_CHIP_REPL) for n in tex.notes)
    assert any(n.startswith(tmc.NOTE_CHIP_K_INDIVISIBLE) for n in tex.notes)
    ref = tapi.compile(tprog, "pimsab")(*_t((a, b)))
    got = tex(*_t((a, b)))
    assert torch.equal(got, ref)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jex(a, b)))
    assert_reports_equal(tex.report, jex.report)


def test_chips_one_passthrough():
    _, tprog, args = _workload("matmul_chain")
    ex = tapi.compile_cluster(tprog, chips=1)
    assert isinstance(ex, tapi.Executor) and ex.backend == "pimsab"
    np.testing.assert_array_equal(ex(*_t(args)).numpy(), _one_chip("matmul_chain"))
    ex2 = tapi.compile(tprog, "pimsab", chips=1)
    assert ex2 is ex
    assert tapi.compile_cluster(tprog, cluster=tapi.ChipCluster(mesh=(1, 1))) is ex


def test_compile_chips_kwarg_routes_to_cluster():
    jprog, tprog, args = _workload("matmul_chain")
    ex = tapi.compile(tprog, "pimsab", chips=2)
    assert isinstance(ex, tapi.ClusterExecutor) and ex.cluster.chips == 2
    jex = japi.compile(jprog, "pimsab", chips=2)
    assert_cluster_equal(jex, ex, np.asarray(jex(*args)), ex(*_t(args)), "matmul_chain")
    # the scope's backend routes as the explicit argument does
    with tapi.use_backend("pimsab"):
        assert tapi.compile(tprog, chips=2) is ex
    cl = tapi.ChipCluster(mesh=(2, 2))
    assert tapi.compile(tprog, "pimsab", cluster=cl, plan="tp") is tapi.compile_cluster(tprog, cluster=cl, plan="tp")


def test_compile_chips_rejects_states_and_the_device_path():
    jprog, tprog, _ = _workload("matmul_chain")
    with pytest.raises(NotImplementedError, match="pimsab") as te:
        tapi.compile(tprog, chips=2)
    with pytest.raises(NotImplementedError, match="pimsab") as je:
        japi.compile(jprog, "xla", chips=2)
    assert "chips/cluster sharding is a pimsab-backend concept" in str(te.value) and \
        str(je.value).startswith("chips/cluster sharding is a pimsab-backend concept")
    with pytest.raises(NotImplementedError, match="pimsab"):
        tapi.compile(tprog, cluster=tapi.ChipCluster(mesh=(1, 2)))
    st, jst = tapi.ResidentState("mc_state", (8, 16), 3), japi.ResidentState("mc_state", (8, 16), 3)
    with pytest.raises(NotImplementedError, match="ResidentState") as te:
        tapi.compile(tprog, "pimsab", chips=2, states={1: st})
    with pytest.raises(NotImplementedError, match="ResidentState") as je:
        japi.compile(jprog, "pimsab", chips=2, states={1: jst})
    assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# the decode layer: the scaling suite's transformer workload
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chips", [2, 4, 8])
def test_decode_layer_sharded_bit_exact(chips):
    jex, tex, jout, tout = _both("decode_layer", chips=chips)
    assert tex.plan == "tp"  # the gemm reduction dims all divide `chips`
    assert_cluster_equal(jex, tex, jout, tout, "decode_layer")


def test_decode_layer_strong_scaling_monotone():
    jprog, tprog, _ = _decode_layer()
    base = tapi.cluster_timing_report(tprog, chips=1)
    assert base.plan == "single"
    assert_reports_equal(base, japi.cluster_timing_report(jprog, chips=1))
    prev = base.total_cycles
    for chips in (2, 4, 8):
        rep = tapi.cluster_timing_report(tprog, chips=chips)
        assert_reports_equal(rep, japi.cluster_timing_report(jprog, chips=chips))
        assert rep.total_cycles <= base.total_cycles
        assert rep.total_cycles <= prev + 1e-9
        prev = rep.total_cycles


# ---------------------------------------------------------------------------
# timeline invariants (per chip) and the overlap sentinel
# ---------------------------------------------------------------------------


def _check_per_chip(rep):
    assert len(rep.per_chip) == rep.chips
    for p in rep.per_chip:
        busy = max(p["busy"].values()) if p["busy"] else 0.0
        assert busy <= p["makespan"] + 1e-9
        assert p["makespan"] <= p["serialized_cycles"] + 1e-9
    assert rep.total_cycles == pytest.approx(max(p["makespan"] for p in rep.per_chip))


@pytest.mark.parametrize("chips", [2, 4, 8])
def test_cluster_timeline_invariants(chips):
    jprog, tprog, _ = _decode_layer()
    rep = tapi.cluster_timing_report(tprog, chips=chips)
    _check_per_chip(rep)
    assert rep.total_cycles <= rep.serial_cycles + 1e-9
    if rep.plan == "tp":
        assert rep.link_bits > 0
        assert rep.energy_pj.get("link", 0.0) > 0.0
    assert_reports_equal(rep, japi.cluster_timing_report(jprog, chips=chips))


def test_decode_layer_overlap_is_real():
    rep = tapi.cluster_timing_report(_decode_layer()[1], chips=4)
    assert rep.plan == "tp"
    assert rep.overlapped_cycles > 0
    assert rep.total_cycles < rep.serial_cycles


def test_weak_scaling_flat():
    jprog, tprog, _ = _workload("matmul_chain")
    base = tapi.cluster_timing_report(tprog, chips=1).total_cycles
    for chips in (2, 4, 8):
        rep = tapi.weak_scaling_report(tprog, chips=chips)
        assert rep.plan == "dp"
        assert rep.total_cycles == pytest.approx(base)
        assert rep.link_bits == 0
        _check_per_chip(rep)
        assert_reports_equal(rep, japi.weak_scaling_report(jprog, chips=chips))


def test_report_json_roundtrip():
    rep = tapi.cluster_timing_report(_workload("matmul_chain")[1], chips=2)
    d = json.loads(json.dumps(rep.to_json()))
    assert d["chips"] == 2
    assert d["total_cycles"] == pytest.approx(rep.total_cycles)
    assert len(d["per_chip"]) == 2
    assert d["speedup"] == rep.speedup


# ---------------------------------------------------------------------------
# the golden inter-chip timeline and the per-chip streams' verifier
# ---------------------------------------------------------------------------


def _golden_timeline_json(payload_bits):
    """``scripts/make_golden_interchip.py``'s ``timeline_json`` over the
    port's ``core``: one butterfly allreduce on a 2×2 ChipCluster."""
    cluster = ChipCluster(mesh=(2, 2))
    cfg = cluster.timing_cfg(PIMSAB)
    C = cluster.chips
    port = cluster.allreduce_port_bits(payload_bits)
    shared = {}
    sims = [Simulator(cfg, shared_tokens=shared) for _ in range(C)]
    send_toks = tuple(f"x:ar0:c{c}" for c in range(C))
    for c, sim in enumerate(sims):
        sim.step(tisa.Mac(dst=64, prec_dst=24, src1=0, prec1=8, src2=32, prec2=8, phase="mm"))
        sim.step(tisa.ChipSend(chip=c, peer=-1, bits=port, rounds=1, phase=send_toks[c], tag="ar0"))
        sim.step(tisa.ChipRecv(chip=c, peer=-1, bits=port, rounds=cluster.allreduce_rounds(), sync=True,
                               phase="ar0.done", after=send_toks, tag="ar0"))
    return {
        "mesh": list(cluster.mesh),
        "payload_bits": payload_bits,
        "port_bits": port,
        "allreduce_rounds": cluster.allreduce_rounds(),
        "allreduce_cycles": cluster.allreduce_cycles(payload_bits),
        "link_bw_bits": cluster.link.bw_bits,
        "link_latency_cycles": cluster.link.latency_cycles,
        "per_chip": [
            {
                "chip": c,
                "makespan": sim.res.makespan,
                "serialized_cycles": sim.res.serialized_cycles,
                "cycles": dict(sorted(sim.res.cycles.items())),
                "busy": dict(sorted(sim.res.busy.items())),
                "link_energy_pj": sim.res.energy.pj.get("link", 0.0),
            }
            for c, sim in enumerate(sims)
        ],
    }


def test_golden_interchip_allreduce_timeline():
    golden = json.loads((REPO / "tests" / "golden" / "interchip_allreduce_timeline.json").read_text())
    now = _golden_timeline_json(golden["payload_bits"])
    assert json.loads(json.dumps(now)) == golden
    for p in now["per_chip"]:
        busy = max(p["busy"].values())
        assert busy <= p["makespan"] <= p["serialized_cycles"]


def _stream_rows(streams):
    return [[(type(i).__name__, repr(i).split("(", 1)[1]) for i in s] for s in streams]


def test_cluster_chip_streams_pass_the_verifier_and_equal_jax():
    """``scripts/check_isa.py``'s multichip gate on the port (RESNET18 on 2
    chips): every chip's scheduled stream carries the link phases and passes
    the static verifier; the decode layer's 4-chip streams equal JAX's."""
    cfg = tres.RESNET18
    prog = tapi.trace(lambda p, v: tres.forward(cfg, p, v), name="check_isa_resnet18_mc").trace(
        tres.init_params(cfg, seed=0, device="cpu"), tres.make_input(cfg, batch=1, seed=1, device="cpu"))
    streams = tmc.cluster_chip_streams(prog, chips=2)
    tcfg = tmc.resolve_cluster(2, None).timing_cfg(tpb.TIMING_CFG)
    assert len(streams) == 2
    for c, stream in enumerate(streams):
        assert any(isinstance(i, (tisa.ChipSend, tisa.ChipRecv)) for i in stream)
        rep = verify_stream(stream, tcfg, name=f"resnet18_2chip_c{c}")
        assert rep.ok and not rep.errors, rep.to_json()
    jprog, tprog, _ = _decode_layer()
    got, want = tmc.cluster_chip_streams(tprog, chips=4), jmc.cluster_chip_streams(jprog, chips=4)
    assert _stream_rows(got) == _stream_rows(want)


# ---------------------------------------------------------------------------
# the executor's edges: cache, devices, refusals
# ---------------------------------------------------------------------------


def test_cluster_executor_caching():
    _, tprog, _ = _workload("matmul_chain")
    ex0 = tapi.compile_cluster(tprog, chips=2)
    info0 = tapi.compile_cache_info()
    ex = tapi.compile_cluster(tprog, chips=2)
    info1 = tapi.compile_cache_info()
    assert ex is ex0 and isinstance(ex, tapi.ClusterExecutor)
    assert info1.hits > info0.hits and info1.misses == info0.misses


def test_cluster_executor_refuses_a_capture_and_operands_without_values(monkeypatch):
    _, tprog, args = _workload("matmul_chain")
    ex = tapi.compile_cluster(tprog, chips=2)
    monkeypatch.setattr(tprogram._CudaGraph, "capturing", staticmethod(lambda: True))
    with pytest.raises(tapi.PimsabTracerError, match="capture"):
        ex(*_t(args))
    monkeypatch.undo()
    with pytest.raises(tapi.PimsabTracerError, match="hold values"):
        ex(*(t.to("meta") for t in _t(args)))
    with pytest.raises(TypeError, match="argument structure"):
        ex(*_t(args[:2]))


def test_cluster_executor_takes_numpy_and_returns_slot_outputs_as_given():
    def f(api):
        def g(x, w):
            return api.int_matmul(x, w, x_bits=4, w_bits=4), x
        return g

    rng = np.random.default_rng(21)
    x, w = rng.integers(-4, 5, (2, 16), dtype=np.int8), rng.integers(-4, 5, (16, 4), dtype=np.int8)
    tprog = tapi.trace(f(tapi), name="mc_two_out").trace(*_t((x, w)))
    jprog = japi.trace(f(japi), name="mc_two_out").trace(x, w)
    ex, jex = tapi.compile(tprog, "pimsab", chips=2, plan="tp"), japi.compile(jprog, "pimsab", chips=2, plan="tp")
    assert ex.plan == jex.plan
    tx, tw = _t((x, w))
    out, slot = ex(tx, tw)
    assert slot is tx and out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(jex(x, w)[0]))
    on_host, _ = ex(x, w)  # numpy operands: the result comes back on the CPU
    assert isinstance(on_host, torch.Tensor) and torch.equal(on_host, out)


def test_wrap_int32_and_slice_leaf_equal_jax():
    s = np.array([2**31, -2**31 - 1, 2**33 + 5, -7, 0], np.int64)
    np.testing.assert_array_equal(tmc._wrap_int32(s), jmc._wrap_int32(s))
    assert tmc._wrap_int32(s).dtype == np.int32
    v = np.arange(2 * 8 * 3).reshape(2, 8, 3)
    for c in range(4):
        np.testing.assert_array_equal(tmc._slice_leaf(v, 1, 4, c), jmc._slice_leaf(v, 1, 4, c))


@pytest.mark.parametrize("chips,mesh", [(1, (1, 1)), (2, (1, 2)), (3, (1, 3)), (4, (2, 2)), (6, (2, 3)),
                                        (8, (2, 4))])
def test_resolve_cluster_mesh_ladder_equals_jax(chips, mesh):
    assert tmc.resolve_cluster(chips).mesh == mesh == jmc.resolve_cluster(chips).mesh
    with pytest.raises(ValueError, match="chips must be >= 1"):
        tmc.resolve_cluster(-1)
