"""The faithful-PIMSAB pipeline end to end on the PyTorch port: express a
GEMM in the tensor DSL, let the compiler distribute it over the 120-tile
machine, inspect the bit-serial-aware optimizations, and simulate
cycles/energy (the port's copy of the simulator, ``repro_torch.core``) —
then run the same math through the bit-sliced GEMM kernel and check they
agree on the answer the hardware would produce.  The port's counterpart of
``examples/pim_gemm.py``, on the card by default:

    PYTHONPATH=src python examples/torch_pim_gemm.py                # on the card
    PYTHONPATH=src python examples/torch_pim_gemm.py --device cpu

``gemm`` and ``run_workload`` are the repository's ``benchmarks/workloads.py``
and ``benchmarks/pimsab_run.py`` rebuilt on ``repro_torch.core``.
"""
import argparse
from typing import Dict

import numpy as np
import torch

from repro_torch.core.compiler import compile_workload, distribute
from repro_torch.core.compiler.tensor_dsl import Loop, Ref, Workload
from repro_torch.core.machine import PIMSAB, PimsabConfig
from repro_torch.core.simulator import Simulator
from repro_torch.kernels import api
from repro_torch.kernels import ref as kref
from repro_torch.kernels.api import PrecisionSpec, SlicedTensor, matmul

# PIMSAB's static power (benchmarks/pimsab_run.py: the A100's leakage at the
# same 22nm-scaled area), W
PIMSAB_STATIC_W = 60.0


def gemm(m: int = 61_440, n: int = 32, k: int = 2048, prec: int = 4, acc: int = 16) -> Workload:
    return Workload(
        name="gemm",
        loops=(Loop("x", m, "data"), Loop("y", n, "data"), Loop("k", k, "reduce")),
        out=Ref("c", ("x", "y"), prec=acc),
        ins=(Ref("a", ("x", "k"), prec), Ref("b", ("k", "y"), prec)),
        op="mac",
        acc_prec=acc,
    )


def run_workload(w: Workload, cfg: PimsabConfig = PIMSAB) -> Dict:
    """Compile ``w``, simulate it on ``cfg``, add the static energy: time,
    cycles and energy as ``benchmarks/pimsab_run.py`` reports them."""
    cp = compile_workload(w, cfg)
    res = Simulator(cfg).run(cp.program)
    res.energy.pj["static"] = res.seconds(cfg) * PIMSAB_STATIC_W * (cfg.num_tiles / 120) * 1e12
    return {
        "name": w.name,
        "time_s": res.seconds(cfg),
        "cycles": res.total_cycles,
        "cycle_breakdown": res.breakdown(),
        "energy_j": res.energy.total_j,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    dev = api.resolve_device(args.device)
    w = gemm(m=4096, n=32, k=512, prec=8, acc=32)

    print("=== parallelism distribution (§V-B) ===")
    m = distribute(w, PIMSAB)
    for k, v in m.to_json().items():
        if k != "allocation":
            print(f"  {k}: {v}")
    print("  allocation:", m.allocation.to_json())

    print("\n=== simulate on the 120-tile machine ===")
    r = run_workload(w)
    print(f"  time {r['time_s']*1e6:.1f} us | energy {r['energy_j']*1e3:.3f} mJ")
    print(f"  cycle breakdown: { {k: round(v,3) for k,v in r['cycle_breakdown'].items()} }")

    print(f"\n=== same math, the bit-sliced GEMM on {dev.type} ===")
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(-128, 128, (256, 512)).astype(np.int32))
    b = torch.from_numpy(rng.integers(-128, 128, (512, 256)).astype(np.int32))
    api.reset_launch_counts()
    got = matmul(SlicedTensor.from_int(a.to(dev), 8), SlicedTensor.from_int(b.to(dev), 8)).cpu()
    want = kref.int_matmul_wide_ref(a, b, 8, 8)
    print(f"  bit-sliced GEMM == wide-int oracle: {bool(torch.equal(got, want))}")

    # adaptive precision: int4 operands need one plane pair and half the work
    spec4 = PrecisionSpec.int4
    a4 = torch.from_numpy(rng.integers(-8, 8, (256, 512)).astype(np.int32))
    b4 = torch.from_numpy(rng.integers(-8, 8, (512, 256)).astype(np.int32))
    got4 = matmul(SlicedTensor.from_int(a4.to(dev), spec4.act_bits),
                  SlicedTensor.from_int(b4.to(dev), spec4.weight_bits)).cpu()
    print(f"  int4 path exact: {bool(torch.equal(got4, kref.int_matmul_wide_ref(a4, b4, 4, 4)))}")
    print(f"  kernel launches: {api.launch_counts() or 'none (the plain version on the CPU)'}")


if __name__ == "__main__":
    main()
