"""The ``scaling`` section of ``BENCH_kernels.json`` reproduced by the port.

``benchmarks/kernels_bench.py``'s ``scaling()`` recipe on
``repro_torch.kernels.multichip``: the paper-shaped RESNET18 (timing only,
untuned, ``init_params(seed=0)``, ``make_input(batch=1, seed=1)``) and the
transformer decode layer, each planned on 1, 2, 4 and 8 chips by
``cluster_timing_report`` (strong scaling) and ``weak_scaling_report``
(weak).  Every row equals the pinned one exactly — mesh, plan, the three
cycle totals, the overlap, the link bits, the speedup, the note codes and the
weak rows' throughput — with no tolerance: these are integer-valued cycle
counts of the same numpy model.  The JAX package is not run here
(``tests/test_torch_multichip.py`` holds the reports equal to its own).
"""
import functools
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import api as tapi  # noqa: E402
from repro_torch.models import resnet as tres  # noqa: E402
from repro_torch.serve import pimsab_step as tstep  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SCALING = json.loads((REPO / "BENCH_kernels.json").read_text())["scaling"]
SCALING_CHIPS = (1, 2, 4, 8)  # benchmarks/kernels_bench.py's


@functools.lru_cache(maxsize=None)
def _program(workload):
    if workload == "decode_layer":
        return tstep.decode_layer_program()
    cfg = tres.RESNET18
    return tapi.trace(lambda p, v: tres.forward(cfg, p, v), name="resnet18_scaling").trace(
        tres.init_params(cfg, seed=0, device="cpu"), tres.make_input(cfg, batch=1, seed=1, device="cpu"))


@functools.lru_cache(maxsize=None)
def _base(workload):
    return tapi.cluster_timing_report(_program(workload), chips=1).total_cycles


def scaling_rows(workload, chips):
    """``benchmarks/kernels_bench.py``'s ``_scaling_rows`` at one chip
    count: the strong row, and the weak row above one chip."""
    prog, base = _program(workload), _base(workload)
    rep = tapi.cluster_timing_report(prog, chips=chips)
    strong = {
        "chips": chips,
        "mesh": list(rep.mesh),
        "plan": rep.plan,
        "total_cycles": rep.total_cycles,
        "serial_cycles": rep.serial_cycles,
        "serialized_cycles": rep.serialized_cycles,
        "overlapped_cycles": rep.overlapped_cycles,
        "link_bits": rep.link_bits,
        "speedup": round(base / rep.total_cycles, 3),
        "notes": sorted({n.split(":", 1)[0] for n in rep.notes}),
    }
    weak = None
    if chips > 1:
        wrep = tapi.weak_scaling_report(prog, chips=chips)
        weak = {
            "chips": chips,
            "total_cycles": wrep.total_cycles,
            "throughput_x": round(chips * base / wrep.total_cycles, 3),
        }
    return strong, weak


PINNED_TOTALS = {"resnet18": (132930.0, 103955.0, 104074.0, 94250.0),
                 "decode_layer": (12027.0, 11733.0, 11701.0, 11597.0)}


@pytest.mark.parametrize("chips", SCALING_CHIPS)
@pytest.mark.parametrize("index,workload", [(0, "resnet18"), (1, "decode_layer")])
def test_scaling_rows_equal_bench_kernels(index, workload, chips):
    assert SCALING["chips"] == list(SCALING_CHIPS)
    pinned = SCALING["workloads"][index]
    assert pinned["workload"] == workload
    i = SCALING_CHIPS.index(chips)
    strong, weak = json.loads(json.dumps(scaling_rows(workload, chips)))
    assert strong == pinned["strong"][i]
    assert weak == (pinned["weak"][i - 1] if i else None)
    assert strong["total_cycles"] == PINNED_TOTALS[workload][i]
    # kernels_bench.check_scaling's invariants: never worse than one chip,
    # never above the serialized schedule
    assert strong["total_cycles"] <= PINNED_TOTALS[workload][0]
    assert strong["total_cycles"] <= strong["serial_cycles"]
