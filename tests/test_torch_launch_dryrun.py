"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's (``repro.launch.dryrun``) and against live runs:

* ``_model_flops_per_device`` equal to JAX's for every arch × shape × mesh;
* every reduced config's cells (train, prefill, decode and the long-context
  decode) on fake meshes (1, 1), (2, 2) and (1, 4): status, skip reason,
  sharding decisions and analytic memory equal to what JAX's ``lower_cell``
  records of the same cells (its rules noting while the step traces);
* ``argument_bytes_per_device`` equal to ``memory_analysis()`` of JAX's
  compiled steps on a forced-device 2 × 2 mesh;
* the collective records of the fake group's rank equal to each rank's of
  a live gloo run at world 4 (``tests/_torch_dist_worker.py``), for a dense
  and an MoE config;
* ``scan_correction``'s ``outside + groups · per_group`` equal to the whole
  count; a measured peak; the CLI and a saved record.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 devices when imported, so
the JAX side runs in a process of its own (``tests/_jax_dryrun_ref.py``),
started before the first test and read when a test needs it; the gloo ranks
likewise (``tests/_torch_dist_ref.py``)."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from _torch_dist_ref import start_ranks  # noqa: E402
from repro_torch.configs import SHAPES, cell_supported, get_config, list_archs, reduced_config  # noqa: E402
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.dist import collectives as tcoll  # noqa: E402
from repro_torch.dist.sharding import MeshRules  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.hlo_analysis import collective_stats  # noqa: E402
from repro_torch.launch.mesh import make_dryrun_mesh  # noqa: E402
from repro_torch.models.runtime import RunFlags  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TESTS = REPO / "tests"
ARCHS = list_archs()
# the production cells' names (cell_supported reads them) at a reduced config's size
CELLS = (("train_4k", "train", 16, 4), ("prefill_32k", "prefill", 16, 4), ("decode_32k", "decode", 16, 4),
         ("long_500k", "decode", 16, 1))
MESHES = ((1, 1), (2, 2), (1, 4))
SSK = {"seq_shard_kv": True, "quant_kv": True}


def _cases():
    out = []
    for arch in ARCHS:
        for c in CELLS:
            for mesh in MESHES:
                out.append({"key": f"{arch}/{c[0]}/{mesh[0]}x{mesh[1]}", "arch": arch, "cell": c, "flags": {},
                            "mesh": mesh})
        out.append({"key": f"{arch}/decode_32k/seq_shard_kv+quant_kv/1x4", "arch": arch, "cell": CELLS[2],
                    "flags": SSK, "mesh": (1, 4)})
    return out


CASES = _cases()
MEMORY_ARCH = "qwen2-0.5b"
# the gloo comparison: a dense and an MoE config, each step kind
GLOO_CASES = [{"name": "dense", "arch": "qwen2-0.5b", "flags": {}, "cells": [list(c) for c in CELLS[:3]]},
              {"name": "moe", "arch": "dbrx-132b", "flags": {}, "cells": [list(c) for c in CELLS[:3]]}]
GLOO_MESHES = ((2, 2), (1, 4))


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """The JAX side and the gloo ranks, started before the first test."""
    tmp = tmp_path_factory.mktemp("dryrun")
    spec = tmp / "jax_spec.json"
    spec.write_text(json.dumps({"devices": 4, "cells": CASES, "memory_arch": MEMORY_ARCH, "memory_mesh": [2, 2],
                                "memory_cells": CELLS[:3]}))
    out = tmp / "jax_out.json"
    proc = subprocess.Popen([sys.executable, str(TESTS / "_jax_dryrun_ref.py"), str(spec), str(out)], cwd=str(REPO),
                            env=dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="2"),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ranks = start_ranks("dryrun_stats", 4, tmp, {"meshes": [list(m) for m in GLOO_MESHES], "cases": GLOO_CASES},
                        timeout=300)
    state = {"proc": proc, "out": out, "ranks": ranks}
    yield state
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def jax_ref(started):
    proc = started["proc"]
    try:
        stdout, stderr = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise AssertionError("the JAX side did not finish within 600 s")
    assert proc.returncode == 0, stderr[-4000:]
    return json.loads(started["out"].read_text())


@pytest.fixture(scope="module")
def gloo_records(started):
    return started["ranks"].results()


# ---------------------------------------------------------------------------
# the port alone, while the JAX side and the gloo ranks run
# ---------------------------------------------------------------------------


def test_lower_cell_skips_a_full_attention_long_context_cell_as_jax_does():
    rec = dryrun.lower_cell("qwen2-0.5b", "long_500k", False, save=False, verbose=False)
    assert rec["status"] == "skipped" and rec["reason"] == cell_supported(get_config("qwen2-0.5b"),
                                                                          dryrun.SHAPES_BY_NAME["long_500k"])[1]
    assert rec["reason"].startswith("skipped(full-attention)")


@pytest.mark.parametrize("arch,kind", [("qwen2-0.5b", "prefill"), ("dbrx-132b", "train"),
                                       ("recurrentgemma-2b", "train"), ("whisper-medium", "decode")])
def test_scan_correction_fields_hold_the_whole_count(arch, kind):
    """A 3-group config: ``outside + 3 · per_group`` is the whole count (the
    port runs every group; JAX's scan body is costed once)."""
    base = reduced_config(get_config(arch))
    cfg = dataclasses.replace(base, n_layers=3 * len(base.block_pattern),
                              n_enc_layers=3 if base.n_enc_layers else 0)
    cell = ShapeCell(*next(c for c in CELLS if c[1] == kind))
    with make_dryrun_mesh(shape=(2, 2)) as mesh, torch.no_grad():
        r = dryrun.run_cell(cfg, cell, MeshRules.from_mesh(mesh), RunFlags(), correction=True, memory=False)
    sc = r["cost"]["scan_correction"]
    assert sc["groups"] == 3 and sc["per_group_flops"] > 0
    assert sc["outside_plus_groups_flops"] == sc["flops"] == r["cost"]["flops"] == r["roofline"]["flops"]


def test_record_holds_a_measured_peak_and_h100_terms():
    cfg = reduced_config(get_config("recurrentgemma-2b"))
    cell = ShapeCell(*CELLS[0])
    with make_dryrun_mesh(shape=(2, 2), rank=1) as mesh, torch.no_grad():
        r = dryrun.run_cell(cfg, cell, MeshRules.from_mesh(mesh), RunFlags(), correction=False)
    mem = r["memory"]
    assert r["rank"] == 1 and r["n_devices"] == 4 and r["uneven_shards"] == []
    assert mem["peak_bytes_per_device"] >= mem["argument_bytes_per_device"] > 0
    assert mem["peak_from"].startswith("MemTracker")
    assert r["launches"] == {"rglru_scan": 4, "rglru_scan_bwd": 2}  # 2 RG-LRU layers, remat recompute
    assert r["rates"]["name"] == "NVIDIA H100 80GB HBM3"
    rl = r["roofline"]
    assert rl["compute_s"] == r["cost"]["flops"] / 989e12 and rl["memory_s"] == r["cost"]["bytes_accessed"] / 3.35e12
    assert r["collectives"]["counts"]["all-reduce"] > 0 and rl["collective_s"] > 0


def test_lower_cell_saves_its_record_under_dryrun_torch(tmp_path, monkeypatch):
    assert dryrun.RESULTS_DIR.parts[-2:] == ("experiments", "dryrun_torch")
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path / "dryrun_torch")
    rec = dryrun.lower_cell("recurrentgemma-2b", "long_500k", False, verbose=False, correction=False)
    assert rec["status"] == "ok", rec.get("traceback")
    saved = json.loads((tmp_path / "dryrun_torch" / "recurrentgemma-2b__long_500k__pod16x16.json").read_text())
    assert saved["mesh"] == "pod16x16" and saved["n_devices"] == 256 and saved["rank"] == 0
    assert saved["launches"] == {"bitslice_matmul": 200}
    assert set(saved["roofline"]) >= {"compute_s", "memory_s", "collective_s", "dominant"}
    assert not torch.distributed.is_initialized()


def test_cli_exits_zero_on_skipped_and_run_cells():
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen2-0.5b", "--shape",
                        "long_500k", "--mesh", "both", "--no-save"], capture_output=True, text=True, timeout=300,
                       cwd=str(REPO), env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("[pod")]
    assert len(lines) == 2 and all("skipped" in ln for ln in lines), r.stdout


def test_cli_runs_several_cells_in_a_pool_of_processes():
    """Two production cells, each in a process of the CLI's pool (one a
    core), each an ``ok`` record."""
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen2-0.5b", "--shape",
                        "decode_32k", "--mesh", "both", "--no-save", "--no-correction"], capture_output=True, text=True,
                       timeout=300, cwd=str(REPO), env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert r.returncode == 0, r.stderr[-2000:]
    lines = sorted(ln for ln in r.stdout.splitlines() if ln.startswith("[pod"))
    assert [ln.split()[0] for ln in lines] == ["[pod16x16]", "[pod2x16x16]"], r.stdout
    assert all(ln.split()[1:4] == ["qwen2-0.5b", "decode_32k", "ok"] for ln in lines), r.stdout
    want = min(2, len(os.sched_getaffinity(0)))
    assert "dry run: 2 records in" in r.stdout and f"({want} at once)" in r.stdout, r.stdout


# ---------------------------------------------------------------------------
# against JAX
# ---------------------------------------------------------------------------


def test_model_flops_per_device_equal_jax(jax_ref):
    want = jax_ref["model_flops"]
    assert len(want) == len(ARCHS) * len(SHAPES) * 2
    for arch in ARCHS:
        cfg = get_config(arch)
        for cell in SHAPES:
            for n in (256, 512):
                assert dryrun._model_flops_per_device(cfg, cell, n) == want[f"{arch}/{cell.name}/{n}"]


@pytest.mark.parametrize("case", CASES, ids=[c["key"] for c in CASES])
def test_reduced_cell_equals_jax(jax_ref, case):
    """Status, skip reason, sharding decisions and analytic memory of the
    cell at the fake mesh equal to JAX's at its forced-device mesh."""
    cfg, cell, flags = reduced_config(get_config(case["arch"])), ShapeCell(*case["cell"]), RunFlags(**case["flags"])
    want = jax_ref["cells"][case["key"]]
    ok, why = cell_supported(cfg, cell)
    if not ok:
        assert want == {"status": "skipped", "reason": why}
        return
    with make_dryrun_mesh(shape=tuple(case["mesh"])) as mesh, torch.no_grad():
        r = dryrun.run_cell(cfg, cell, MeshRules.from_mesh(mesh), flags, correction=False, memory=False)
    analytic = dict(r["memory"]["analytic"])
    assert analytic.pop("device_bytes") == 80 * 10**9
    assert analytic.pop("fits_device") == (analytic["analytic_peak_per_device"] < 80 * 10**9)
    assert want["status"] == "ok"
    assert r["sharding_decisions"] == want["sharding_decisions"]
    assert analytic == want["analytic"]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_argument_bytes_equal_jax_memory_analysis(jax_ref, kind):
    cfg, cell = reduced_config(get_config(MEMORY_ARCH)), ShapeCell(*next(c for c in CELLS if c[1] == kind))
    with make_dryrun_mesh(shape=(2, 2)) as mesh, torch.no_grad():
        r = dryrun.run_cell(cfg, cell, MeshRules.from_mesh(mesh), RunFlags(), correction=False, memory=False)
    assert r["memory"]["argument_bytes_per_device"] == jax_ref["memory"][kind]["argument"]


# ---------------------------------------------------------------------------
# against a live gloo run at world 4
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", GLOO_MESHES, ids=[f"{m[0]}x{m[1]}" for m in GLOO_MESHES])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("case", GLOO_CASES, ids=[c["name"] for c in GLOO_CASES])
def test_fake_group_collective_stats_equal_a_live_gloo_run(gloo_records, case, kind, mesh):
    """Each rank of the fake mesh records what the same rank of the live
    world-4 gloo run made: the same calls, ops, operand bytes and group
    sizes, so the same ``collective_stats``."""
    cfg = reduced_config(get_config(case["arch"]))
    cell = ShapeCell(*next(c for c in case["cells"] if c[1] == kind))
    key = f"{case['name']}/{kind}/{mesh[0]}x{mesh[1]}"
    for rank in range(4):
        with make_dryrun_mesh(shape=mesh, rank=rank) as m, torch.no_grad():
            step, args, *_ = dryrun._build_step_args(cfg, cell, MeshRules.from_mesh(m), RunFlags(**case["flags"]))
            got = dryrun.count_step(step, args).records
        live = [tcoll.CollectiveRecord(*r) for r in gloo_records[rank][key]]
        assert live and got == live, (rank, got, live)
        fake, real = collective_stats(got), collective_stats(live)
        assert (fake.counts, fake.operand_bytes, fake.wire_bytes) == (real.counts, real.operand_bytes,
                                                                      real.wire_bytes)
