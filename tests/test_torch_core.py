"""The port's copy of the PIMSAB simulator and compiler (``repro_torch.core``)
against the JAX package's ``repro.core``, which it copies file for file.

The copy stands alone (the port may import nothing of the JAX package), so
these tests hold it to the original: every file equal line for line once the
package names are normalized; the golden files under ``tests/golden/``
reproduced by the copy (the Fig-11 GEMM breakdown, the inter-chip allreduce
timeline, the bad-program corpus refused with its diagnostics); the batched
functional simulator equal to the per-bit reference on random verified
streams; and one stream through both packages' simulators leaving equal
CRAM state and an equal ``SimResult``.
"""
import json
import re
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import isa as jisa  # noqa: E402
from repro.core.machine import PimsabConfig as JPimsabConfig  # noqa: E402
from repro.core.simulator import Simulator as JSimulator  # noqa: E402
from repro_torch.core import isa  # noqa: E402
from repro_torch.core.compiler import compile_workload  # noqa: E402
from repro_torch.core.compiler.allocation import Allocation  # noqa: E402
from repro_torch.core.compiler.tensor_dsl import Loop, Ref, Workload  # noqa: E402
from repro_torch.core.compiler.verify import VerifierError, verify_stream  # noqa: E402
from repro_torch.core.machine import PIMSAB, PimsabConfig  # noqa: E402
from repro_torch.core.noc import ChipCluster  # noqa: E402
from repro_torch.core.simulator import Simulator  # noqa: E402
from tests.test_functional_fuzz import CFG as FUZZ_CFG  # noqa: E402
from tests.test_functional_fuzz import _StreamGen  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SRC_CORE = REPO / "src" / "repro" / "core"
PORT_CORE = REPO / "src" / "repro_torch" / "core"
GOLDEN = Path(__file__).parent / "golden"
CORE_FILES = sorted(str(p.relative_to(SRC_CORE)) for p in SRC_CORE.rglob("*.py"))
PACKAGE_NAME = re.compile(r"\brepro_torch\.(core|kernels)\b")


# ---------------------------------------------------------------------------
# the copy
# ---------------------------------------------------------------------------


def test_the_copy_has_every_file_of_the_source():
    assert len(CORE_FILES) == 17
    assert sorted(str(p.relative_to(PORT_CORE)) for p in PORT_CORE.rglob("*.py")) == CORE_FILES


@pytest.mark.parametrize("rel", CORE_FILES)
def test_the_copy_differs_only_in_lines_that_name_the_package(rel):
    src = (SRC_CORE / rel).read_text().splitlines()
    port = (PORT_CORE / rel).read_text().splitlines()
    assert len(port) == len(src), rel
    for i, (a, b) in enumerate(zip(src, port), start=1):
        if a != b:
            assert "repro_torch." in b, f"{rel}:{i} differs without naming the package"
            assert PACKAGE_NAME.sub(r"repro.\1", b) == a, f"{rel}:{i}"


# ---------------------------------------------------------------------------
# the golden files, reproduced by the copy
# ---------------------------------------------------------------------------


def _fig11_gemm():
    """``benchmarks.workloads.gemm(m=4096, n=32, k=512, prec=8, acc=32)``, the
    golden GEMM of ``tests/test_sim_differential.py``, on the copy's DSL."""
    return Workload(
        name="gemm",
        loops=(Loop("x", 4096, "data"), Loop("y", 32, "data"), Loop("k", 512, "reduce")),
        out=Ref("c", ("x", "y"), prec=32),
        ins=(Ref("a", ("x", "k"), 8), Ref("b", ("k", "y"), 8)),
        op="mac",
        acc_prec=32,
    )


def test_the_restated_golden_gemm_is_the_benchmark_workload():
    from benchmarks import workloads

    want = workloads.gemm(m=4096, n=32, k=512, prec=8, acc=32)
    assert repr(_fig11_gemm()) == repr(want)


def test_golden_gemm_fig11_breakdown_reproduced_by_the_copy():
    golden = json.loads((GOLDEN / "gemm_fig11_breakdown.json").read_text())
    cp = compile_workload(_fig11_gemm(), PIMSAB)
    res = Simulator(PIMSAB).run(cp.program)
    assert res.instrs == golden["instrs"]
    assert res.total_cycles == pytest.approx(golden["total_cycles"], rel=1e-9)
    assert res.serialized_cycles == pytest.approx(golden["serialized_cycles"], rel=1e-9)
    assert res.overlapped_cycles == pytest.approx(golden["overlapped_cycles"], rel=1e-9)
    for cat, cycles in golden["cycles"].items():
        assert res.cycles[cat] == pytest.approx(cycles, rel=1e-9), cat
    for cat, frac in golden["breakdown"].items():
        assert res.breakdown()[cat] == pytest.approx(frac, abs=1e-5), cat
    for cat, cycles in golden["critical_path"].items():
        assert res.critical_path[cat] == pytest.approx(cycles, rel=1e-9), cat
    m = cp.mapping
    assert (m.tiles_used, m.reduce_split, m.serial_iters, m.out_prec, m.double_buffered) == tuple(
        golden["mapping"][k]
        for k in ("tiles_used", "reduce_split", "serial_iters", "out_prec", "double_buffered"))


PAYLOAD_BITS = 64 * 1024  # scripts/make_golden_interchip.py's payload


def _interchip_timeline():
    """``scripts/make_golden_interchip.py``'s ``timeline_json``, restated on
    the copy: one butterfly allreduce on a 2×2 ChipCluster."""
    cluster = ChipCluster(mesh=(2, 2))
    cfg = cluster.timing_cfg(PIMSAB)
    chips = cluster.chips
    port = cluster.allreduce_port_bits(PAYLOAD_BITS)
    shared = {}
    sims = [Simulator(cfg, shared_tokens=shared) for _ in range(chips)]
    send_toks = tuple(f"x:ar0:c{c}" for c in range(chips))
    for c, sim in enumerate(sims):
        sim.step(isa.Mac(dst=64, prec_dst=24, src1=0, prec1=8, src2=32, prec2=8, phase="mm"))
        sim.step(isa.ChipSend(chip=c, peer=-1, bits=port, rounds=1, phase=send_toks[c], tag="ar0"))
        sim.step(isa.ChipRecv(chip=c, peer=-1, bits=port, rounds=cluster.allreduce_rounds(), sync=True,
                              phase="ar0.done", after=send_toks, tag="ar0"))
    return {
        "mesh": list(cluster.mesh),
        "payload_bits": PAYLOAD_BITS,
        "port_bits": port,
        "allreduce_rounds": cluster.allreduce_rounds(),
        "allreduce_cycles": cluster.allreduce_cycles(PAYLOAD_BITS),
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


def test_golden_interchip_allreduce_timeline_reproduced_by_the_copy():
    from scripts.make_golden_interchip import timeline_json

    golden = json.loads((GOLDEN / "interchip_allreduce_timeline.json").read_text())
    now = _interchip_timeline()
    assert now == golden
    assert now == timeline_json()  # the restatement is the script's
    for p in now["per_chip"]:
        assert max(p["busy"].values()) <= p["makespan"] <= p["serialized_cycles"]


CORPUS = sorted((GOLDEN / "bad_programs").glob("*.json"))


def _load_case(path):
    case = json.loads(path.read_text())
    cfg = PimsabConfig(**case["cfg"])
    prog = [isa.instr_from_json(d) for d in case["program"]]
    alloc = None
    if "allocation" in case:
        alloc = Allocation(ranges={k: [tuple(r) for r in v] for k, v in case["allocation"].items()},
                           capacity=cfg.cram_rows)
    return case, cfg, prog, alloc


def test_the_bad_program_corpus_is_there():
    assert {p.stem for p in CORPUS} >= {"dropped_after_prefetch", "overlapping_alt_buffers",
                                         "undersized_accumulator", "rf_read_before_load"}


@pytest.mark.parametrize("path", CORPUS, ids=lambda p: p.stem)
def test_bad_program_refused_by_the_copy_with_its_diagnostic(path):
    case, cfg, prog, alloc = _load_case(path)
    rep = verify_stream(prog, cfg, name=case["name"], allocation=alloc, out_prec=case.get("out_prec"))
    assert not rep.ok, f"{case['name']} must fail static verification"
    codes = {d.code for d in rep.errors}
    for want in case["expect"]:
        assert want in codes, f"{case['name']}: want {want}, got {sorted(codes)}"
    for d in rep.errors:
        if d.code.startswith("E-RACE") or d.code in ("E-UNINIT-READ", "E-PREC-OVERFLOW"):
            assert d.instr is not None and d.wordlines
    with pytest.raises(VerifierError) as ei:
        rep.raise_on_error()
    assert case["expect"][0] in str(ei.value)
    for ins in prog:
        assert isa.instr_from_json(isa.instr_to_json(ins)) == ins


# ---------------------------------------------------------------------------
# random verified streams: batched vs per-bit, and JAX's core vs the copy
# ---------------------------------------------------------------------------

SEED_ROWS = 96  # tests/test_functional_fuzz.py's random seed window
CFG = PimsabConfig(mesh_cols=FUZZ_CFG.mesh_cols, mesh_rows=FUZZ_CFG.mesh_rows,
                   crams_per_tile=FUZZ_CFG.crams_per_tile)
FUZZ_CASES = [(0, 30), (1, 50), (7, 70), (123456, 50), (2**31 - 5, 70)]


def _stream(seed, n_ops):
    """A random verified stream of ``tests/test_functional_fuzz.py``'s
    generator, in the JAX package's ISA and (through its JSON form) in the
    copy's, and the random CRAM image it starts from."""
    rng = np.random.default_rng(seed)
    jprog = _StreamGen(rng).build(n_ops)
    prog = [isa.instr_from_json(jisa.instr_to_json(i)) for i in jprog]
    keys = [(t, c) for t in range(CFG.num_tiles) for c in range(CFG.crams_per_tile)]
    bits = rng.integers(0, 2, (len(keys), SEED_ROWS, CFG.cram_cols)).astype(np.uint8)
    carry = rng.integers(0, 2, (len(keys), CFG.cram_cols)).astype(np.uint8)
    return jprog, prog, keys, bits, carry


def _run(sim, prog, keys, bits, carry):
    for t, c in keys:
        sim.cram(t, c)
    sim.step(prog[0])  # the defining preamble, then the random image
    for i, (t, c) in enumerate(keys):
        cram = sim.cram(t, c)
        cram.bits[:SEED_ROWS] = bits[i]
        cram.carry[:] = carry[i]
    for ins in prog[1:]:
        sim.step(ins)
    return sim


def _assert_same_state(a, b, keys):
    for t, c in keys:
        ca, cb = a.cram(t, c), b.cram(t, c)
        assert np.array_equal(ca.bits, cb.bits), f"bit planes diverge on cram ({t},{c})"
        assert np.array_equal(ca.carry, cb.carry), f"carry latch diverges on cram ({t},{c})"
        assert np.array_equal(ca.mask, cb.mask), f"mask latch diverges on cram ({t},{c})"
    assert a.rf == b.rf
    ra, rb = a.res, b.res
    assert ra.instrs == rb.instrs and ra.cycles == rb.cycles and ra.energy.pj == rb.energy.pj
    assert ra.makespan == rb.makespan and ra.serialized_cycles == rb.serialized_cycles
    assert ra.busy == rb.busy and ra.critical_path == rb.critical_path


@pytest.mark.parametrize("seed, n_ops", FUZZ_CASES)
def test_fuzz_batched_vs_exact_bits_on_the_copy(seed, n_ops):
    _, prog, keys, bits, carry = _stream(seed, n_ops)
    rep = verify_stream(prog, CFG, name=f"fuzz_{seed}")
    assert not [d for d in rep.diagnostics if d.severity == "error"]
    fast = _run(Simulator(CFG, functional=True), prog, keys, bits, carry)
    exact = _run(Simulator(CFG, functional=True, exact_bits=True), prog, keys, bits, carry)
    _assert_same_state(fast, exact, keys)
    for sim in (fast, exact):
        busy = max(sim.res.busy.values()) if sim.res.busy else 0.0
        assert busy <= sim.res.makespan + 1e-9 <= sim.res.serialized_cycles + 2e-9


@pytest.mark.parametrize("seed, n_ops", FUZZ_CASES[:3])
def test_one_stream_leaves_equal_state_in_both_packages(seed, n_ops):
    jprog, prog, keys, bits, carry = _stream(seed, n_ops)
    jcfg = JPimsabConfig(mesh_cols=CFG.mesh_cols, mesh_rows=CFG.mesh_rows,
                         crams_per_tile=CFG.crams_per_tile)
    theirs = _run(JSimulator(jcfg, functional=True), jprog, keys, bits, carry)
    ours = _run(Simulator(CFG, functional=True), prog, keys, bits, carry)
    _assert_same_state(ours, theirs, keys)
    assert ours.res.total_cycles == theirs.res.total_cycles
    assert ours.res.breakdown() == theirs.res.breakdown()


def test_a_compiled_program_runs_the_same_in_both_packages():
    """A compiler-emitted stream (the golden GEMM's, at full chip scale) on
    the timing model of both packages: equal results field by field."""
    from repro.core.compiler.codegen import compile_workload as jcompile
    from repro.core.machine import PIMSAB as JPIMSAB

    from benchmarks import workloads

    jcp = jcompile(workloads.gemm(m=4096, n=32, k=512, prec=8, acc=32), JPIMSAB)
    cp = compile_workload(_fig11_gemm(), PIMSAB)
    assert [isa.instr_to_json(i) for i in cp.program] == [jisa.instr_to_json(i) for i in jcp.program]
    assert cp.mapping.to_json() == jcp.mapping.to_json()
    ours, theirs = Simulator(PIMSAB).run(cp.program), JSimulator(JPIMSAB).run(jcp.program)
    assert (ours.instrs, ours.cycles, ours.energy.pj, ours.makespan, ours.serialized_cycles,
            ours.critical_path, ours.utilization()) == (
        theirs.instrs, theirs.cycles, theirs.energy.pj, theirs.makespan, theirs.serialized_cycles,
        theirs.critical_path, theirs.utilization())
