#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (Hopper, ``sm_90a``).

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, any failure of which exits non-zero:

1. build every CUDA source of ``src/repro_torch/kernels/csrc`` (in parallel,
   into ``build/repro_torch/``) and print the build time;
2. hold each ResNet kernel against its plain PyTorch version: at the inputs
   the RESNET18 forward gives it (batch 32, captured from one forward on the
   card), and at edge cases (ragged tiles, int32 wrap, negative pool sums,
   float32).  The plain versions run on a CPU copy, since PyTorch has no
   int32 matrix product on CUDA.  Integers must match bit for bit;
3. the main paths, each driven through the entry points a user calls, with
   every launch counter reset just before it and read just after:

   a. RESNET18 at full width, batch 32, random weights from seed 0, eager:
      logits bit-equal to the plain CPU forward, launches equal to what
      ``layer_names`` implies (GEMM 21, relu 17, add 8, pool-sum 1);
   b. the same network through the Program API (``api.trace`` → ``Program``
      → cached ``Executor``): logits bit-equal to (a), the same launches, a
      compile-cache hit on the second call;
   c. the paper's bit-sliced GEMM at its Table III shape (x 61440 × 2048,
      w 2048 × 32) through ``api.quantized_matmul`` under the ``int4``,
      ``int8``, ``int16`` and ``w8a16`` presets, and through
      ``SlicedTensor.from_int`` → ``api.matmul`` with an all-zero activation
      slice whose pairs must never be launched;
   d. ``quant_linear_relu`` (a traced matmul → relu Program) at Qwen2-0.5B's
      MLP width, 4096 tokens × 896 → 4864, under ``w8a16``.

   Each of (c) and (d) runs again on CPU copies of its inputs (the plain
   versions); the bit-sliced kernel's output must equal its plain version's
   on the same slices, and the path's output the CPU path's, bit for bit;
4. time each kernel at those inputs (CUDA events around a CUDA-graph replay
   of 20 calls, after warm-up; eager back-to-back calls too) beside its
   bound, its plain version and, where one PyTorch call computes the same
   function, that call (``torch._int_mm`` for a single-pair bit-sliced
   GEMM); time 50 eager forwards one by one (median and p80), and the
   eager forward, the traced call (re-trace included) and a held
   ``Executor`` replay from an idle card (host clock);
5. profile three forwards and one call of each bit-sliced path
   (torch.profiler): device time by kernel name and the device's idle share.

It prints the card's name and power limit, a ``{"kernels": [...]}`` line,
and as its last line ``{"ok": true, "device": {...}}``.  Per-call details go
to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

BATCH = 32
SEED = 0
# Peak rates of one H100 SXM (NVIDIA data sheet, 700 W): HBM3 bytes/s,
# float32 FLOP/s outside the tensor cores.  int32 multiply-adds run on IMAD at
# 64 per clock per SM; that rate is computed from the card's own clock.
MEM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core rate; a multiply-add is 2 ops
IMAD_PER_CLOCK_PER_SM = 64
FLOAT_ATOL = FLOAT_RTOL = 1e-4  # the JAX package's float kernel tolerance
# forwards timed one by one: the p80 then has 10 samples beyond it
FORWARD_SAMPLES = 50
# latency samples of the Program API and of each bit-sliced path
LATENCY_SAMPLES = 20

# The paper's Table III GEMM (benchmarks/workloads.py:gemm, fig09_gpu.py).
TABLE3 = (61440, 2048, 32)  # (M, K, N)
GEMM_PRESETS = ("int4", "int8", "int16", "w8a16")
# quant_linear_relu: 4096 tokens through Qwen2-0.5B's MLP up-projection
# (src/repro/configs/qwen2_0_5b.py: d_model 896 → d_ff 4864).
QLR = (4096, 896, 4864)

BITSLICE_SOURCE = "src/repro_torch/kernels/csrc/bitslice_gemm.cu"
BITSLICE_REPLACES = "src/repro/kernels/bitslice_matmul.py:29"

SOURCES = {
    "gemm": "src/repro_torch/kernels/csrc/int_gemm.cu",
    "pool_sum": "src/repro_torch/kernels/csrc/pool_reduce.cu",
    "pool_max": "src/repro_torch/kernels/csrc/pool_reduce.cu",
    "ewise_add": "src/repro_torch/kernels/csrc/ewise.cu",
    "relu": "src/repro_torch/kernels/csrc/ewise.cu",
}
REPLACES = {
    "gemm": "src/repro/kernels/conv.py:49",
    "pool_sum": "src/repro/kernels/conv.py:88",
    "pool_max": "src/repro/kernels/conv.py:84",
    "ewise_add": "src/repro/kernels/ewise.py:25",
    "relu": "src/repro/kernels/ewise.py:29",
}
# registry kernel → the CUDA kernel it launches
LAUNCHED_BY = {
    "conv2d": "gemm", "int_matmul": "gemm", "relu": "relu", "ewise_add": "ewise_add",
    "global_avgpool": "pool_sum", "avgpool2d": "pool_sum", "maxpool2d": "pool_max",
}


def nvidia_smi(query: str, fmt: str = "csv,noheader") -> str:
    r = subprocess.run(["nvidia-smi", "-i", "0", f"--query-gpu={query}", f"--format={fmt}"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip()


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.failures = []
        self.cases = []

    def check(self, kernel, case, got, want, exact):
        """Compare a kernel's output (on the card) with its plain version's
        (on the CPU); record the case, and a failure on disagreement."""
        torch = self.torch
        got = got.cpu()
        ok = got.shape == want.shape and got.dtype == want.dtype
        err = None
        if ok:
            diff = (got.double() - want.double()).abs()
            err = float(diff.max()) if diff.numel() else 0.0
            if exact:
                ok = torch.equal(got, want)
            else:
                ok = bool((diff <= FLOAT_ATOL + FLOAT_RTOL * want.double().abs()).all())
        self.cases.append({"kernel": kernel, "case": case, "ok": ok, "max_abs_err": err,
                           "exact": exact, "shape": list(got.shape), "dtype": str(got.dtype)})
        if not ok:
            self.failures.append(f"{kernel} [{case}]: disagrees with its plain version "
                                 f"(max_abs_err={err}, shape {tuple(got.shape)}/{tuple(want.shape)})")
        return err


def cuda_ms(torch, fn, reps=20, warmup=3):
    """Mean time of ``fn`` in ms over ``reps`` back-to-back eager calls (CUDA
    events): the device time plus whatever launch gaps the host leaves."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps=20, warmup=3):
    """Mean device time of ``fn`` in ms: ``reps`` calls captured in one CUDA
    graph and replayed (CUDA events around the replay), so host launch cost
    does not enter."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def forward_samples(torch, fn, n, warmup=3):
    """Sorted times in ms of ``n`` calls of ``fn``, each between its own pair
    of CUDA events, issued back to back as a caller would."""
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(n)]
    torch.cuda.synchronize()
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sorted(start.elapsed_time(end) for start, end in events)


def sync_samples(torch, fn, n, warmup=2):
    """Sorted host-clock times in ms of ``n`` calls of ``fn``, each from an
    idle card (synchronized) to the end of its device work: the latency a
    caller sees, host work such as tracing and launching included."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return sorted(out)


def median(xs):
    return xs[len(xs) // 2]


def bitslice_work(x, w, slice_bits, pairs):
    """(bytes, operations) one bit-sliced GEMM needs: each slice that a
    computed pair reads, read once, and the int32 output written once; two
    int8 operations (multiply, add) per product of each computed pair.  A
    pair whose shift is 32 or more adds 0 mod 2**32 and is not computed."""
    (_, m, k), (_, _, n) = x.shape, w.shape
    live = [(s, t) for s, t in pairs if slice_bits * (s + t) < 32]
    nbytes = len({s for s, _ in live}) * m * k + len({t for _, t in live}) * k * n + 4 * m * n
    return nbytes, 2 * m * k * n * len(live)


def run_bitslice_path(torch, api, bm, smoke, path, run, expected, skipped=()):
    """Drive one bit-sliced path: ``run("cuda")`` with the launch counters
    reset just before and read just after, then ``run("cpu")`` (the plain
    versions).  Holds the kernel's output against its plain version's on the
    same slices, the path's output against the CPU path's, the launch counts
    against ``expected`` and the skipped pairs against the executed ones."""
    card, cpu = [], []
    sink = [card]
    orig = bm._bitslice_gemm

    def rec(x, w, slice_bits, pairs):
        t = time.perf_counter()
        out = orig(x, w, slice_bits, pairs)
        sink[0].append(((x, w, slice_bits, pairs), out, time.perf_counter() - t))
        return out

    bm._bitslice_gemm = rec
    try:
        api.reset_launch_counts()
        got = run("cuda")
        torch.cuda.synchronize()
        counts = {k: v for k, v in api.launch_counts().items() if v}
        executed, launched = api.last_executed_pairs(), bm.launched_pairs()
        sink[0] = cpu
        want = run("cpu")
    finally:
        bm._bitslice_gemm = orig
    if counts != expected:
        smoke.failures.append(f"{path}: launch counts {counts} != expected {expected}")
    if len(card) != 1 or len(cpu) != 1:
        smoke.failures.append(f"{path}: {len(card)} card and {len(cpu)} CPU bit-sliced GEMM calls, not 1 and 1")
        return None
    (args, out, _), (cargs, plain, plain_s) = card[0], cpu[0]
    if not (torch.equal(args[0].cpu(), cargs[0]) and torch.equal(args[1].cpu(), cargs[1])
            and args[2:] == cargs[2:]):
        smoke.failures.append(f"{path}: the card and CPU paths gave the kernel different slices")
        t = time.perf_counter()
        plain = bm._bitslice_plain(args[0].cpu(), args[1].cpu(), *args[2:])
        plain_s = time.perf_counter() - t
    # the kernel against its plain version on the same slices
    err = smoke.check("bitslice_matmul", f"{path} kernel vs plain {tuple(args[0].shape)}x{tuple(args[1].shape)}",
                      out, plain, exact=True)
    smoke.check(path, "output vs the CPU path", got, want, exact=True)
    active = set(api.active_pairs(args[0].shape[0], args[1].shape[0], skipped))
    if set(skipped) & (set(executed) | set(launched)) or not set(executed) == set(launched) == active:
        smoke.failures.append(f"{path}: executed {executed}, launched {launched}, skipped {skipped}")
    return {"path": path, "run": run, "launches": counts, "args": args, "out": out,
            "plain_ms": plain_s * 1e3,
            "max_abs_err": err, "executed": [list(p) for p in executed],
            "launched": [list(p) for p in launched], "skipped": [list(p) for p in skipped]}


def device_profile(torch, fn, iters=3):
    """Device time by kernel name over ``iters`` calls of ``fn`` (torch
    profiler), and the window's wall time on CUDA events: returns
    ``(wall_ms, {name: (calls, device_ms)})``; the dict is empty when the
    profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            calls, ms = by_name.get(ev.name, (0, 0.0))
            by_name[ev.name] = (calls + 1, ms + ev.time_range.elapsed_us() / 1e3)
    return start.elapsed_time(end), by_name


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test needs a GPU", file=sys.stderr)
        return 2

    from repro_torch.kernels import _build, api, conv, ewise, ref
    from repro_torch.kernels import bitslice_matmul as bm
    from repro_torch.models import common, resnet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smoke = Smoke(torch)
    gpu = nvidia_smi("name,power.limit")
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_hz = float(nvidia_smi("clocks.max.sm", "csv,noheader,nounits")) * 1e6
    imad_per_s = sm_count * IMAD_PER_CLOCK_PER_SM * clock_hz
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {sm_count} SMs, "
          f"max SM clock {clock_hz / 1e6:.0f} MHz")

    # ---------------- phase 1: build ----------------
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"phase 1 build: {time.perf_counter() - t0:.1f} s wall for {sorted(built) or 'nothing (cached)'}")
    for src, info in sorted(built.items()):
        regs = [ln.strip() for ln in str(info["log"]).splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"  {src}.cu: {info['seconds']:.1f} s; " + " | ".join(regs[:8]))

    # ---------------- phase 2: kernels against their plain versions ----------------
    cfg = resnet.RESNET18
    params_cpu = resnet.init_params(cfg, SEED, device="cpu")
    x_cpu = resnet.make_input(cfg, BATCH, seed=SEED + 1, device="cpu")
    model = resnet.ResNet(cfg, params_cpu, device=dev)
    x = x_cpu.to(dev)

    # capture the inputs each kernel wrapper gets on the main path
    calls = {k: [] for k in SOURCES}
    orig = (conv._gemm, conv._pool_rows, ewise._ewise)

    def rec_gemm(a, b):
        calls["gemm"].append((a.contiguous(), b.contiguous()))
        return orig[0](a, b)

    def rec_pool(p, op):
        calls[f"pool_{op}"].append((p.contiguous(),))
        return orig[1](p, op)

    def rec_ewise(op, a, b=None):
        calls["ewise_add" if op == "add" else "relu"].append(
            tuple(t.contiguous() for t in ((a,) if b is None else (a, b))))
        return orig[2](op, a, b)

    conv._gemm, conv._pool_rows, ewise._ewise = rec_gemm, rec_pool, rec_ewise
    try:
        with torch.no_grad():
            model(x)
    finally:
        conv._gemm, conv._pool_rows, ewise._ewise = orig
    torch.cuda.synchronize()

    run = {
        "gemm": lambda a, b: conv._gemm(a, b),
        "pool_sum": lambda p: conv._pool_rows(p, "sum"),
        "pool_max": lambda p: conv._pool_rows(p, "max"),
        "ewise_add": lambda a, b: ewise._ewise("add", a, b),
        "relu": lambda a: ewise._ewise("relu", a),
    }
    plain = {
        "gemm": conv._gemm_plain,
        "pool_sum": lambda p: conv._pool_rows_plain(p, "sum"),
        "pool_max": lambda p: conv._pool_rows_plain(p, "max"),
        "ewise_add": lambda a, b: ewise._ewise_plain("add", a, b),
        "relu": lambda a: ewise._ewise_plain("relu", a),
    }

    main_err = {k: 0.0 for k in SOURCES}
    gemm_plain_cpu_ms = 0.0
    for kernel, arglist in calls.items():
        for i, args in enumerate(arglist):
            got = run[kernel](*args)
            torch.cuda.synchronize()
            cpu_args = [a.cpu() for a in args]
            t = time.perf_counter()
            want = plain[kernel](*cpu_args)
            if kernel == "gemm":
                gemm_plain_cpu_ms += (time.perf_counter() - t) * 1e3
            err = smoke.check(kernel, f"resnet18 b{BATCH} call {i} {[tuple(a.shape) for a in args]}",
                              got, want, exact=True)
            main_err[kernel] = max(main_err[kernel], err or 0.0)

    g = torch.Generator().manual_seed(SEED)

    def ints(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32)

    def floats(shape):
        return torch.randn(shape, generator=g, dtype=torch.float32)

    big = 2**30
    edge_cases = [
        ("gemm", "ragged M=1000 K=27 N=1000", (ints((1000, 27), -8, 8), ints((27, 1000), -4, 4)), True),
        ("gemm", "ragged M=77 K=4608 N=130", (ints((77, 4608), -1000, 1000), ints((4608, 130), -4, 4)), True),
        ("gemm", "int32 wrap K=576", (ints((130, 576), -big, big), ints((576, 70), -big, big)), True),
        ("gemm", "float32 M=300 K=200 N=130", (floats((300, 200)), floats((200, 130))), False),
        ("gemm", "float32 ragged M=129 K=27 N=1000", (floats((129, 27)), floats((27, 1000))), False),
        ("pool_sum", "negative sums K=16", (ints((1000, 16), -50, 10),), True),
        ("pool_sum", "int32 wrap K=49", (ints((777, 49), -2**31, 2**31 - 1),), True),
        ("pool_sum", "ragged K=100", (ints((300, 100), -1000, 1000),), True),
        ("pool_sum", "float32 K=16", (floats((1000, 16)),), False),
        ("pool_max", "int32 K=4", (ints((1000, 4), -2**31, 2**31 - 1),), True),
        ("pool_max", "int32 K=9", (ints((999, 9), -100, 100),), True),
        ("pool_max", "float32 K=4", (floats((1000, 4)),), True),
        ("ewise_add", "int32 wrap n=1000003", (ints((1000003,), -2**31, 2**31 - 1),
                                                ints((1000003,), -2**31, 2**31 - 1)), True),
        ("ewise_add", "float32 n=4097", (floats((4097,)), floats((4097,))), True),
        ("relu", "int32 n=1000003", (ints((1000003,), -2**31, 2**31 - 1),), True),
        ("relu", "float32 n=4097", (floats((4097,)),), True),
    ]
    for kernel, case, cpu_args, exact in edge_cases:
        got = run[kernel](*[a.to(dev) for a in cpu_args])
        torch.cuda.synchronize()
        smoke.check(kernel, case, got, plain[kernel](*cpu_args), exact)

    # whole-network checks at a small input: TINY (stem max pool) in int32,
    # and a float32 conv through the registry
    tiny = resnet.TINY
    tp = resnet.init_params(tiny, SEED, device="cpu")
    tx = resnet.make_input(tiny, 4, seed=SEED + 1, device="cpu")
    tiny_gpu = resnet.ResNet(tiny, tp, device=dev)(tx.to(dev))
    smoke.check("resnet", "TINY batch 4 logits", tiny_gpu, resnet.forward(tiny, tp, tx), True)
    fx, fw = floats((2, 5, 12, 12)), floats((7, 5, 3, 3))
    smoke.check("conv2d", "float32 stride 2 pad 1",
                api.conv2d(fx.to(dev), fw.to(dev), stride=2, padding=1),
                api.conv2d(fx, fw, stride=2, padding=1), False)
    torch.cuda.synchronize()
    n_ok = sum(c["ok"] for c in smoke.cases)
    print(f"phase 2 kernels vs plain: {n_ok}/{len(smoke.cases)} cases agree")

    # ---------------- phase 3a: the main path, RESNET18 eager ----------------
    expected = {}
    for name in resnet.layer_names(cfg):
        expected[LAUNCHED_BY[name]] = expected.get(LAUNCHED_BY[name], 0) + 1
    api.reset_launch_counts()
    t = time.perf_counter()
    with torch.no_grad():
        logits = model(x)
    torch.cuda.synchronize()
    first_forward_s = time.perf_counter() - t
    counts = api.launch_counts()
    launches = {k: counts.get(k, 0) for k in SOURCES}
    t = time.perf_counter()
    want = resnet.forward(cfg, params_cpu, x_cpu)
    cpu_forward_s = time.perf_counter() - t
    if logits.shape != (BATCH, cfg.num_classes) or logits.dtype != torch.int32:
        smoke.failures.append(f"logits have shape {tuple(logits.shape)} {logits.dtype}")
    smoke.check("resnet", f"RESNET18 batch {BATCH} logits", logits, want, True)
    if {k: v for k, v in counts.items() if v} != expected:
        smoke.failures.append(f"launch counts {counts} != expected {expected}")
    print(f"phase 3 RESNET18 b{BATCH}: logits {tuple(logits.shape)} |max| "
          f"{int(logits.abs().max())}, bit-equal to CPU: {torch.equal(logits.cpu(), want)}; "
          f"launches {launches} (expected {expected}); first forward {first_forward_s:.3f} s, "
          f"CPU plain forward {cpu_forward_s:.2f} s")
    path_launches = {"resnet18_eager": {k: v for k, v in counts.items() if v}}

    # ---------------- phase 3b: RESNET18 through the Program API ----------------
    traced = api.trace(lambda p, v: resnet.forward(cfg, p, v), name="resnet18")
    params = model.params()
    api.reset_launch_counts()
    t = time.perf_counter()
    with torch.no_grad():
        logits_traced = traced(params, x)
    torch.cuda.synchronize()
    first_traced_s = time.perf_counter() - t
    counts = {k: v for k, v in api.launch_counts().items() if v}
    path_launches["resnet18_traced"] = counts
    smoke.check("program", f"traced RESNET18 batch {BATCH} logits vs eager", logits_traced,
                logits.cpu(), True)
    if counts != expected:
        smoke.failures.append(f"traced RESNET18: launch counts {counts} != expected {expected}")
    info0 = api.compile_cache_info()
    traced(params, x)
    ex = api.compile(traced.program_for(params, x))
    info1 = api.compile_cache_info()
    if (info1.hits, info1.misses) != (info0.hits + 2, info0.misses):
        smoke.failures.append(f"traced RESNET18: compile cache {info0} → {info1}, expected two hits")
    smoke.check("program", "held Executor replay vs eager", ex(params, x), logits.cpu(), True)
    print(f"phase 3b traced RESNET18 b{BATCH}: {len(ex.program.ops)} ops, logits bit-equal to "
          f"eager: {torch.equal(logits_traced, logits)}; launches {counts}; first call "
          f"{first_traced_s:.3f} s; compile cache {info1.hits} hits / {info1.misses} misses")

    # ---------------- phase 3c: the bit-sliced GEMM at Table III ----------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    m, k, n = TABLE3
    gx = torch.randn((m, k), generator=gen, device=dev)
    gw = torch.randn((k, n), generator=gen, device=dev) * 0.1
    host = {"cuda": {"x": gx}, "cpu": {"x": gx.cpu()}}
    bitslice_paths = []
    for preset in GEMM_PRESETS:
        spec = getattr(api.PrecisionSpec, preset)
        w_st = api.SlicedTensor.quantize(gw, spec, weight=True)
        wq, ws = w_st.to_int(), w_st.scale.reshape(-1)
        for d, wqd, wsd in (("cuda", wq, ws), ("cpu", wq.cpu(), ws.cpu())):
            host[d][preset] = (wqd, wsd)
        r = run_bitslice_path(
            torch, api, bm, smoke, f"gemm_{preset}",
            lambda d, preset=preset, spec=spec: api.quantized_matmul(host[d]["x"], *host[d][preset], spec),
            {"bitslice_matmul": 1})
        if r:
            bitslice_paths.append(r)
    # zero-skip: int16 operands whose activations fit one slice, so the high
    # activation slice is all zero and both pairs that read it are skipped
    zx = torch.randint(-100, 100, (m, k), generator=gen, device=dev, dtype=torch.int32)
    zw = torch.randint(-30000, 30000, (k, n), generator=gen, device=dev, dtype=torch.int32)
    zero = {"cuda": (zx, zw), "cpu": (zx.cpu(), zw.cpu())}
    r = run_bitslice_path(
        torch, api, bm, smoke, "gemm_zero_skip",
        lambda d: api.matmul(api.SlicedTensor.from_int(zero[d][0], 16),
                             api.SlicedTensor.from_int(zero[d][1], 16)),
        {"bitslice_matmul": 1}, skipped=((1, 0), (1, 1)))
    if r:
        bitslice_paths.append(r)

    # ---------------- phase 3d: quant_linear_relu at Qwen2-0.5B's MLP width ----------------
    mq, kq, nq = QLR
    qx = torch.randn((mq, kq), generator=gen, device=dev)
    qp = common.quantize_weight(torch.randn((kq, nq), generator=gen, device=dev) * 0.05, 8)
    qlr = {"cuda": (qp, qx), "cpu": ({k_: v.cpu() for k_, v in qp.items()}, qx.cpu())}
    r = run_bitslice_path(
        torch, api, bm, smoke, "quant_linear_relu",
        lambda d: common.quant_linear_relu(*qlr[d], api.PrecisionSpec.w8a16),
        {"bitslice_matmul": 1, "relu": 1})
    if r:
        bitslice_paths.append(r)
        # the relu kernel at the accumulator this path hands it
        smoke.check("relu", "quant_linear_relu accumulator", ewise._ewise("relu", r["out"]),
                    ewise._ewise_plain("relu", r["out"].cpu()), True)
    for r in bitslice_paths:
        path_launches[r["path"]] = r["launches"]
        print(f"phase 3c/d {r['path']}: launches {r['launches']}, executed pairs {r['executed']}, "
              f"launched {r['launched']}, skipped {r['skipped']}; kernel vs plain max_abs_err "
              f"{r['max_abs_err']}; plain {r['plain_ms']:.0f} ms on the CPU")
    torch.cuda.synchronize()

    # ---------------- phase 4: timing ----------------
    library = {
        "gemm": None,  # PyTorch has no int32 matrix product on CUDA
        "pool_sum": lambda p: torch.sum(p, dim=1, dtype=p.dtype),
        "pool_max": lambda p: torch.amax(p, dim=1),
        "ewise_add": torch.add,
        "relu": torch.relu,
    }

    def work(kernel, args):
        """(bytes moved, operations, operation rate) of one call: each input
        read once, each output written once; a multiply-add is one operation
        at the IMAD rate for int32, two float32 FLOPs for float32."""
        integer = args[0].dtype == torch.int32
        if kernel == "gemm":
            (m, k), n = args[0].shape, args[1].shape[1]
            return 4 * (m * k + k * n + m * n), m * k * n, imad_per_s if integer else FP32_FLOP_PER_S / 2
        rate = imad_per_s if integer else FP32_FLOP_PER_S
        if kernel.startswith("pool"):
            rows, k = args[0].shape
            return 4 * (rows * k + rows), rows * k, rate
        n = args[0].numel()
        return 4 * n * (len(args) + 1), n, rate

    # pool_max is not on RESNET18's path (no stem pool): time it at the
    # window matrix a 2×2 stem max pool of this network would get
    if not calls["pool_max"]:
        stem = torch.randint(-2**20, 2**20, (BATCH, cfg.stem_channels, cfg.input_hw, cfg.input_hw),
                             generator=g, dtype=torch.int32)
        calls["pool_max"].append((ref.pool_patches(stem, 2, 2).contiguous().to(dev),))

    rows = []
    details = []
    for kernel, arglist in calls.items():
        ms = eager_ms = plain_ms = bound_ms = lib_ms = 0.0
        bytes_s = ops_s = 0.0
        for args in arglist:
            k_ms = graph_ms(torch, lambda: run[kernel](*args))
            k_eager = cuda_ms(torch, lambda: run[kernel](*args))
            p_ms = None if kernel == "gemm" else graph_ms(torch, lambda: plain[kernel](*args))
            l_ms = None if library[kernel] is None else graph_ms(torch, lambda: library[kernel](*args))
            nbytes, ops, rate = work(kernel, args)
            b_bytes, b_ops = nbytes / MEM_BYTES_PER_S * 1e3, ops / rate * 1e3
            ms += k_ms
            eager_ms += k_eager
            plain_ms += p_ms or 0.0
            lib_ms += l_ms or 0.0
            bound_ms += max(b_bytes, b_ops)
            bytes_s += b_bytes
            ops_s += b_ops
            details.append({"kernel": kernel, "shapes": [list(a.shape) for a in args], "ms": k_ms,
                            "eager_ms": k_eager,
                            "plain_ms": p_ms, "library_ms": l_ms,
                            "bound_ms": max(b_bytes, b_ops), "bytes": nbytes, "ops": ops})
        if kernel == "gemm":
            plain_ms = gemm_plain_cpu_ms  # on the CPU: no int32 matmul on CUDA
        on_path = launches[kernel] > 0
        row = {
            "name": kernel, "route": "cuda", "source": SOURCES[kernel], "replaces": REPLACES[kernel],
            "launches": launches[kernel],
            "max_abs_err": max((c["max_abs_err"] or 0.0) for c in smoke.cases if c["kernel"] == kernel),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if ops_s > bytes_s else "bytes",
            "library_ms": None if library[kernel] is None else lib_ms,
            "calls_timed": len(arglist), "eager_ms": eager_ms,
            "plain_device": "cpu" if kernel == "gemm" else "cuda",
            "main_path_max_abs_err": main_err[kernel] if on_path else None,
        }
        rows.append(row)
        print(f"kernel {kernel}: {len(arglist)} calls, {ms / len(arglist):.4f} ms per call, "
              f"{ms:.4f} ms summed in graph replay "
              f"({eager_ms:.4f} ms eager; bound {bound_ms:.4f} ms "
              f"by {row['bound_by']}, roofline share {bound_ms / ms:.1%}), plain {plain_ms:.4f} ms on "
              f"{row['plain_device']}, library {row['library_ms']}, launches/forward {launches[kernel]}")

    fwd_samples = forward_samples(torch, lambda: model(x), FORWARD_SAMPLES)
    fwd_ms = fwd_samples[len(fwd_samples) // 2]
    fwd_p80 = fwd_samples[int(0.8 * len(fwd_samples)) - 1]
    kernel_ms = sum(r["ms"] for r in rows if r["launches"])
    print(f"RESNET18 b{BATCH} forward: median {fwd_ms:.3f} ms, p80 {fwd_p80:.3f} ms, "
          f"min {fwd_samples[0]:.3f}, max {fwd_samples[-1]:.3f} over {len(fwd_samples)} forwards "
          f"(CUDA events each); {BATCH / fwd_ms * 1e3:.1f} images/s at the median; "
          f"the ported kernels alone {kernel_ms:.3f} ms")
    for row in rows:
        row["launches_by_path"] = {p: c[row["name"]] for p, c in path_launches.items() if row["name"] in c}

    # the Program API beside the eager forward, each call from an idle card
    lat = {
        "eager_forward": sync_samples(torch, lambda: model(x), LATENCY_SAMPLES),
        "traced_call": sync_samples(torch, lambda: traced(params, x), LATENCY_SAMPLES),
        "executor_replay": sync_samples(torch, lambda: ex(params, x), LATENCY_SAMPLES),
    }
    retrace = []
    for _ in range(LATENCY_SAMPLES):
        t = time.perf_counter()
        traced.trace(params, x)
        retrace.append((time.perf_counter() - t) * 1e3)
    lat["retrace_host"] = sorted(retrace)
    back_to_back = {
        "eager_forward": forward_samples(torch, lambda: model(x), LATENCY_SAMPLES),
        "traced_call": forward_samples(torch, lambda: traced(params, x), LATENCY_SAMPLES),
        "executor_replay": forward_samples(torch, lambda: ex(params, x), LATENCY_SAMPLES),
    }
    program_timing = {
        "latency_ms_median": {k: median(v) for k, v in lat.items()},
        "back_to_back_ms_median": {k: median(v) for k, v in back_to_back.items()},
        "latency_ms_samples": lat, "back_to_back_ms_samples": back_to_back,
    }
    print(f"Program API RESNET18 b{BATCH} (median of {LATENCY_SAMPLES}, host clock from an idle "
          f"card): eager {median(lat['eager_forward']):.3f} ms, traced call "
          f"{median(lat['traced_call']):.3f} ms, held Executor {median(lat['executor_replay']):.3f} ms, "
          f"re-trace alone {median(retrace):.3f} ms host; back to back (CUDA events): "
          + ", ".join(f"{k} {median(v):.3f} ms" for k, v in back_to_back.items()))

    # the bit-sliced GEMM per path: kernel (graph replay and eager), its
    # bound, its plain version (CPU), torch._int_mm where one pair is all
    # there is, and the whole entry-point call from an idle card
    bitslice_rows = []
    for r in bitslice_paths:
        xs, ws, sb, pairs = r["args"]
        k_ms = graph_ms(torch, lambda: bm._bitslice_gemm(xs, ws, sb, pairs))
        k_eager = cuda_ms(torch, lambda: bm._bitslice_gemm(xs, ws, sb, pairs))
        lib_ms = lib_agrees = None
        if tuple(pairs) == ((0, 0),):
            lib_ms = graph_ms(torch, lambda: torch._int_mm(xs[0], ws[0]))
            lib_agrees = torch.equal(torch._int_mm(xs[0], ws[0]), r["out"])
        nbytes, ops = bitslice_work(xs, ws, sb, pairs)
        b_bytes, b_ops = nbytes / MEM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
        call_ms = sync_samples(torch, lambda: r["run"]("cuda"), LATENCY_SAMPLES // 2)
        row = {
            "name": f"bitslice_matmul[{r['path']}]", "route": "cuda", "source": BITSLICE_SOURCE,
            "replaces": BITSLICE_REPLACES, "launches": r["launches"]["bitslice_matmul"],
            "max_abs_err": r["max_abs_err"], "ms": k_ms, "plain_ms": r["plain_ms"],
            "bound_ms": max(b_bytes, b_ops), "bound_by": "operations" if b_ops > b_bytes else "bytes",
            "library_ms": lib_ms, "eager_ms": k_eager, "plain_device": "cpu",
            "library": "torch._int_mm" if lib_ms is not None else None,
            "library_agrees": lib_agrees, "launches_by_path": {r["path"]: r["launches"]["bitslice_matmul"]},
            "shapes": [list(xs.shape), list(ws.shape)], "slice_bits": sb,
            "pairs": [list(p) for p in pairs], "bytes": nbytes, "ops": ops,
            "path_call_ms_median": median(call_ms), "path_call_ms_samples": call_ms,
        }
        bitslice_rows.append(row)
        print(f"kernel {row['name']}: {k_ms:.4f} ms in graph replay ({k_eager:.4f} ms eager; bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']}, roofline share "
              f"{row['bound_ms'] / k_ms:.1%}), plain {r['plain_ms']:.1f} ms on the CPU, "
              f"torch._int_mm {lib_ms}; whole {r['path']} call {median(call_ms):.3f} ms")

    # ---------------- phase 5: where the forward's device time goes ----------------
    prof_iters = 3
    wall_ms, by_name = device_profile(torch, lambda: model(x), prof_iters)
    busy_ms = sum(ms for _, ms in by_name.values())
    profile_summary = {
        "wall_ms_per_forward": wall_ms / prof_iters,
        "device_busy_ms_per_forward": busy_ms / prof_iters if by_name else None,
        "idle_share": 1 - busy_ms / wall_ms if by_name else None,
        "kernels": sorted(([n, c / prof_iters, ms / prof_iters] for n, (c, ms) in by_name.items()),
                          key=lambda r: -r[2]),
    }
    if by_name:
        top = "; ".join(f"{n[:40]} x{c:g} {ms:.3f} ms" for n, c, ms in profile_summary["kernels"][:6])
        print(f"profile RESNET18 b{BATCH} (torch.profiler, {prof_iters} forwards): "
              f"{wall_ms / prof_iters:.3f} ms wall, {busy_ms / prof_iters:.3f} ms device busy, "
              f"idle share {profile_summary['idle_share']:.3f}; per forward: {top}")
    else:
        print("profile: the profiler saw no device activity; device breakdown not measured")
    for r in bitslice_paths:
        wall, names = device_profile(torch, lambda: r["run"]("cuda"), 1)
        busy = sum(ms for _, ms in names.values())
        profile_summary[r["path"]] = {
            "wall_ms": wall, "device_busy_ms": busy if names else None,
            "idle_share": 1 - busy / wall if names else None,
            "kernels": sorted(([nm, c, ms] for nm, (c, ms) in names.items()), key=lambda q: -q[2]),
        }
        if names:
            top = "; ".join(f"{nm[:40]} x{c:g} {ms:.3f} ms"
                            for nm, c, ms in profile_summary[r["path"]]["kernels"][:5])
            print(f"profile {r['path']} (one call): {wall:.3f} ms wall, {busy:.3f} ms device busy; {top}")

    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "gpu": gpu, "torch": torch.__version__, "cuda": torch.version.cuda, "batch": BATCH,
        "sm_count": sm_count, "max_sm_clock_hz": clock_hz, "forward_ms": fwd_ms,
        "forward_ms_p80": fwd_p80, "forward_ms_samples": fwd_samples,
        "kernel_ms": kernel_ms, "profile": profile_summary, "launches": launches, "expected_launches": expected,
        "path_launches": path_launches, "program": program_timing,
        "kernels": rows + bitslice_rows, "calls": details, "cases": smoke.cases, "failures": smoke.failures,
    }, indent=1))

    if smoke.failures:
        for f in smoke.failures:
            print("FAIL", f, file=sys.stderr)
        return 1
    path = [r for r in rows if r["launches"]] + bitslice_rows
    off_path = [r for r in rows if not r["launches"]]
    print(gpu)
    print(json.dumps({"kernels": path, "off_path": off_path, "forward_ms": fwd_ms,
                      "forward_ms_p80": fwd_p80, "batch": BATCH, "path_launches": path_launches,
                      "program_latency_ms": program_timing["latency_ms_median"]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
