"""The port's examples (``examples/torch_*.py``) run on the CPU when asked
(``--device cpu``), each in a process of its own, as
``test_torch_elastic_restart_example_on_the_cpu`` runs the restart drill.
``torch_pim_gemm.py`` prints the distribution, simulated time and energy
that ``examples/pim_gemm.py`` prints, computed here by the JAX package's
simulator and the repository's ``benchmarks`` helpers it calls."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]


def _run(name, *args):
    r = subprocess.run([sys.executable, str(REPO / "examples" / name), "--device", "cpu", *args],
                       capture_output=True, text=True, timeout=600, cwd=str(REPO),
                       env=dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="2"))
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def test_torch_quickstart_example_on_the_cpu():
    """Train, checkpoint half-way, resume, a falling loss, then serve."""
    out = _run("torch_quickstart.py", "--steps", "16")
    assert "resumed from 8" in out and out.rstrip().endswith("quickstart: OK")
    assert sum(ln.startswith("request ") for ln in out.splitlines()) == 4


def test_torch_serve_lm_example_on_the_cpu():
    out = _run("torch_serve_lm.py")
    lines = [ln for ln in out.splitlines() if "tokens in" in ln]
    assert [ln.split()[0] for ln in lines] == ["qwen2-0.5b", "recurrentgemma-2b", "xlstm-1.3b"]
    assert all(ln.split()[1] == "24" for ln in lines)


def _jax_pim_gemm_lines():
    """The lines ``examples/pim_gemm.py`` prints before its kernel section."""
    from benchmarks.pimsab_run import run_workload
    from benchmarks.workloads import gemm
    from repro.core.compiler import distribute
    from repro.core.machine import PIMSAB

    w = gemm(m=4096, n=32, k=512, prec=8, acc=32)
    lines = ["=== parallelism distribution (§V-B) ==="]
    m = distribute(w, PIMSAB)
    lines += [f"  {k}: {v}" for k, v in m.to_json().items() if k != "allocation"]
    lines.append(f"  allocation: {m.allocation.to_json()}")
    r = run_workload(w)
    lines += ["", "=== simulate on the 120-tile machine ===",
              f"  time {r['time_s']*1e6:.1f} us | energy {r['energy_j']*1e3:.3f} mJ",
              f"  cycle breakdown: { {k: round(v,3) for k,v in r['cycle_breakdown'].items()} }"]
    return lines, r


def test_torch_pim_gemm_example_equals_the_jax_example():
    out = _run("torch_pim_gemm.py").splitlines()
    want, r = _jax_pim_gemm_lines()
    assert out[:len(want)] == want
    sys.path.insert(0, str(REPO / "examples"))
    try:
        import torch_pim_gemm
    finally:
        sys.path.remove(str(REPO / "examples"))
    got = torch_pim_gemm.run_workload(torch_pim_gemm.gemm(m=4096, n=32, k=512, prec=8, acc=32))
    assert (got["time_s"], got["cycles"], got["energy_j"], got["cycle_breakdown"]) == \
        (r["time_s"], r["cycles"], r["energy_j"], r["cycle_breakdown"])
    assert "  bit-sliced GEMM == wide-int oracle: True" in out and "  int4 path exact: True" in out
