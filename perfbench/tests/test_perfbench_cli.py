"""The command refuses to run without a card and outside a checkout, and
nothing the harness loads is JAX or the JAX package."""
import json
import shutil
import subprocess
import sys
import types

import pytest
import torch

import pbsetup

RUN = [sys.executable, "perfbench/run.py", "--workload", "resnet18.b32", "--seed", "1", "--seconds", "1"]


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    p = subprocess.run(RUN + ["--trace", "0"], cwd=pbsetup.ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == "" and "CUDA device" in p.stderr


def test_refuses_with_only_the_benchmarks_files(tmp_path):
    shutil.copy(pbsetup.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(pbsetup.ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(RUN + ["--trace", "0"], cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    sys.path.insert(0, str(pbsetup.ROOT / "perfbench"))
    try:
        import run
    finally:
        sys.path.remove(str(pbsetup.ROOT / "perfbench"))
    before = set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro_torch.kernels", types.ModuleType("repro_torch.kernels"))
    monkeypatch.setitem(sys.modules, "reprox", types.ModuleType("reprox"))
    assert set(run.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "repro.models", types.ModuleType("repro.models"))
    assert set(run.forbidden_modules()) == before | {"jax", "repro"}


DRIVE = """
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
import torch
from perfbench.bench import harness
sys.path.insert(0, {tests!r})
import pbsetup
cells = [("resnet18.b32", pbsetup.tiny_resnet(), pbsetup.tiny_images(), {{"logits_mismatched": 0}}),
         ("minicpm-2b.prefill-512", pbsetup.tiny_transformer(), pbsetup.tiny_prompts(), {{"served_gap_max": 1.0, "logit_err_max": 1.0}})]
for name, cfg, tr, lim in cells:
    for trace in (False, True):
        r = harness.run_cell(name, 5, 0.2, trace, torch.device("cpu"), t0=time.perf_counter(), config=cfg,
                             traffic=tr, limits=lim, log=lambda m: None)
        assert r["correct"], r
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_no_jax_and_no_jax_package():
    code = DRIVE.format(root=str(pbsetup.ROOT), src=str(pbsetup.ROOT / "src"),
                        tests=str(pbsetup.ROOT / "perfbench" / "tests"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top and "perfbench" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}
