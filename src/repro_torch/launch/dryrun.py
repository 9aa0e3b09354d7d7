"""The multi-pod dry run of the PyTorch port (the JAX package's
``launch/dryrun.py``): does an arch × shape cell fit the 256-GPU
(``pod16x16``) and 512-GPU (``pod2x16x16``) production meshes, and what
bounds its step?

JAX compiles each cell for placeholder devices.  The port runs the cell's
step once as one rank (rank 0) of a **fake** process group of 256 or 512
ranks (``launch.mesh.make_dryrun_mesh``), on ``meta`` tensors: it allocates
nothing and touches no device, which is what JAX's dry run does on its
placeholder devices.  The rank's inputs are its shards of
``launch.specs.input_specs`` cut by each leaf's spec (``shard_leaf``, as
``shard_params`` cuts a live rank's); the batch goes in whole, as every
rank of the port's SPMD steps takes it.  The kernels the steps reach take
their explicit meta route (``kernels.api.meta_operands``: the card's
checks, then a ``meta`` output), and the collectives go to the fake group,
which moves nothing.

What a record counts, all for that one rank and one step:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the step's
  PyTorch ops (its products: mm, bmm, convolutions, attention), plus each
  kernel's operations (``api.kernel_work``: 2·M·N·K per computed slice pair
  of the bit-sliced GEMM, 2·M·T·D for q·Kᵀ, two an element for the RG-LRU
  scan and three for its gradient).  XLA's ``cost_analysis`` also counts
  elementwise work, so the two do not agree; the port counts what it can
  name.
* bytes: each PyTorch op's tensor inputs and outputs (views and bare
  allocations excepted), through one ``TorchDispatchMode``, plus each
  kernel's inputs read once and outputs written once.
* launches: one a kernel call the card would launch (``api.kernel_work``'s
  ``calls``); the meta route itself launches and counts nothing.
* collectives: ``dist.collectives``' records of each ``torch.distributed``
  call (``launch.hlo_analysis.collective_stats``); the conjugates of tensor
  parallelism are the port's (Megatron's), not XLA's partitioner's.
* memory: argument and output bytes from the rank's ``meta`` trees; the
  analytic model (``launch.memory_model.analytic_memory``, held against the
  card's 80 GB); a peak from ``torch.distributed._tools.mem_tracker.
  MemTracker`` over the run (the live ``meta`` storages, arguments
  included), or None with the reason where it cannot run.
* the roofline: ``launch.hlo_analysis.roofline_terms`` at one H100 SXM's
  rates (``hlo_analysis.H100_SXM``), which are a model, not a measurement;
  every operation, the kernels' int8 and float32 ones included, is priced
  at the dense BF16 peak.

The port runs every layer in Python, so XLA's scan undercount (a while
loop's body costed once) does not arise and the counts above are whole.
``scan_correction`` keeps JAX's fields, computed the same way from 1-group
and 2-group runs: ``per_group_flops``, ``outside_flops`` and ``groups``, with
``outside + groups · per_group`` beside the whole count.

The decode cell's position is the last row of its cache (``seq_len - 1``),
passed as the host scalar the port's decode step reads; JAX traces it.
Records go to ``experiments/dryrun_torch/`` (never JAX's
``experiments/dryrun/``, which ``benchmarks/roofline.py`` reads).  The CLI
runs several cells in a pool of processes, one a core (a fake process group
is per process).  Run::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --mesh both --no-save
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import SHAPES, SHAPES_BY_NAME, cell_supported, get_config, list_archs
from repro_torch.dist import collectives, sharding
from repro_torch.dist.sharding import MeshRules
from repro_torch.kernels import api
from repro_torch.launch.hlo_analysis import H100_SXM, collective_stats, roofline_terms
from repro_torch.launch.mesh import make_dryrun_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.models.runtime import DEFAULT_FLAGS, RunFlags

RESULTS_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
RANK = 0  # the rank each record is of


def _model_flops_per_device(cfg, cell, n_devices: int) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE); decode D=batch tokens."""
    n = cfg.active_param_count()
    if cell.kind == "train":
        d = cell.tokens
        return 6.0 * n * d / n_devices
    if cell.kind == "prefill":
        d = cell.tokens
        return 2.0 * n * d / n_devices
    return 2.0 * n * cell.global_batch / n_devices  # decode: one token per seq


# ---------------------------------------------------------------------------
# a rank's inputs
# ---------------------------------------------------------------------------


def _local(tree: Any, rules: MeshRules, uneven: List[str], path: str = "") -> Any:
    """This rank's shard of a ``meta`` tree whose leaves carry ``.spec``
    (``shard_leaf``), noting in ``uneven`` each dim that does not divide."""
    if isinstance(tree, dict):
        return {k: _local(v, rules, uneven, f"{path}/{k}") for k, v in tree.items()}
    spec = getattr(tree, "spec", None)
    if spec is None:
        return tree
    for d, n, _, _ in sharding._axis_dims(spec, rules):
        if tree.shape[d] % n:
            uneven.append(f"{path}: dim {d} of {tree.shape[d]} over {n}")
    return sharding.shard_leaf(tree, spec, rules)


def _decode_cache(cache: Dict[str, Any], cell, rules: MeshRules, global_cache: Dict[str, Any]) -> Dict[str, Any]:
    """The rank's decode cache with its position (the cache's last row, a
    host scalar) and, under ``seq_shard_kv``, ``seq_sharded`` naming the
    leaves whose rows it holds a slice of (as ``transformer.init_cache``)."""
    from repro_torch.models import transformer

    cache = dict(cache, pos=transformer._host_pos(cell.seq_len - 1))
    seq = {}
    for key, entry in global_cache["blocks"].items():
        for name, leaf in entry.items():
            if leaf.spec[2] == rules.tp_axis:
                seq.setdefault(key, {})[name] = transformer._host_pos(leaf.shape[2])
    if seq:
        cache["seq_sharded"] = seq
    return cache


def tree_bytes(tree: Any) -> int:
    """Bytes of the tensor leaves of ``tree``."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def _build_step_args(cfg, cell, rules: MeshRules, flags: RunFlags):
    """(step, args, specs, argument bytes, uneven shards) of the cell on this
    rank: the port's step builders, the rank's shards of ``input_specs``
    and the whole batch."""
    specs = input_specs(cfg, cell, rules, flags)
    uneven: List[str] = []
    if cell.kind == "train":
        from repro_torch.train.steps import make_train_step

        state = _local(specs["state"], rules, uneven, "state")
        args_bytes = tree_bytes(state) + tree_bytes(_local(specs["batch"], rules, uneven, "batch"))
        return make_train_step(cfg, flags, rules), (state, specs["batch"]), specs, args_bytes, uneven
    from repro_torch.serve.engine import make_decode_step, make_prefill_step

    params = _local(specs["params"], rules, uneven, "params")
    if cell.kind == "prefill":
        args_bytes = tree_bytes(params) + tree_bytes(_local(specs["batch"], rules, uneven, "batch"))
        step = make_prefill_step(cfg, flags, rules, max_len=cell.seq_len)
        return step, (params, specs["batch"]), specs, args_bytes, uneven
    cache = _local(specs["cache"], rules, uneven, "cache")
    args_bytes = (tree_bytes(params) + tree_bytes(cache) + tree_bytes(_local(specs["tokens"], rules, uneven, "tokens")))
    cache = _decode_cache(cache, cell, rules, specs["cache"])
    return make_decode_step(cfg, flags, rules), (params, cache, specs["tokens"]), specs, args_bytes, uneven


def live_step_args(cfg, cell, rules: Optional[MeshRules], flags: RunFlags, device: Any = "cuda", seed: int = 0):
    """(step, args) of the cell with tensors on ``device``, the live
    counterpart of the dry run's: the same step builders; parameters from
    ``transformer.init_params(cfg, seed)`` (served quantized under
    ``quant_serve``), this rank's slices of them, its train state
    (``init_train_state``) or its decode cache (``init_cache`` at the cache's
    last row); the whole batch, tokens drawn from ``seed``."""
    from repro_torch.models import common, transformer
    from repro_torch.serve.engine import make_decode_step, make_prefill_step

    dev = torch.device(device)
    gen = torch.Generator().manual_seed(seed)
    b, s, dt = cell.global_batch, cell.seq_len, common.dtype_of(cfg)

    def ints(shape):
        return torch.randint(0, cfg.vocab_size, shape, generator=gen, dtype=torch.int32).to(dev)

    params = transformer.init_params(cfg, seed, device=dev)
    if cell.kind == "decode":
        batch = {"tokens": ints((b, 1))}
    else:
        batch = {"tokens": ints((b, s))}
        if cell.kind == "train":
            batch["labels"] = ints((b, s))
        if cfg.is_encdec:
            batch["enc_embeds"] = torch.randn((b, cfg.enc_seq_len, cfg.d_model), generator=gen).to(dev, dt)
        if cfg.frontend == "vision":
            batch["patch_embeds"] = torch.randn((b, cfg.n_patches, cfg.d_model), generator=gen).to(dev, dt)
    if cell.kind == "train":
        from repro_torch.train.optimizer import AdamWConfig
        from repro_torch.train.steps import init_train_state, make_train_step, train_state_specs

        specs = train_state_specs(cfg, rules, AdamWConfig(), flags) if rules is not None else None
        return make_train_step(cfg, flags, rules), (init_train_state(params, cfg, AdamWConfig(), specs, rules), batch)
    served = common.maybe_quantize_tree(params, cfg) if flags.quant_serve else params
    del params
    local = sharding.shard_params(served, cfg, rules) if rules is not None else served
    if cell.kind == "prefill":
        return make_prefill_step(cfg, flags, rules, max_len=s), (local, batch)
    cache = transformer.init_cache(cfg, b, s, flags, device=dev, rules=rules)
    cache["pos"] = transformer._host_pos(s - 1)
    return make_decode_step(cfg, flags, rules), (local, cache, batch["tokens"])


# ---------------------------------------------------------------------------
# counting one step
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
# ops that only allocate: they read and write nothing
_ALLOCATIONS = {_aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
                _aten.new_empty.default, _aten.new_empty_strided.default}


class _ByteCounter(TorchDispatchMode):
    """Bytes of each op's tensor inputs and outputs (views and bare
    allocations move none)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func not in _ALLOCATIONS:
            self.ops += 1
            self.bytes += tree_bytes((args, kwargs)) + tree_bytes(out)
        return out


@dataclass
class StepCount:
    """What :func:`count_step` counted of one call of a step."""

    flops: float
    bytes: float
    aten_flops: float
    aten_bytes: float
    aten_ops: int
    launches: Dict[str, int]
    kernel_work: Dict[str, Dict[str, float]]
    records: List[Any]
    peak_bytes: Optional[int]
    peak_reason: str
    seconds: float
    outputs: Any


def _peak(tracker) -> int:
    snap = tracker.get_tracker_snapshot("peak")
    return max(int(v["Total"]) for v in snap.values())


def count_step(step: Callable, args: Tuple[Any, ...], memory: bool = False) -> StepCount:
    """Run ``step(*args)`` once under the counters (on ``meta`` tensors for a
    dry run, or live on the CPU or the card): its FLOPs and bytes, kernel
    work and the launches the card makes for it (one a noted call),
    collective records and, with ``memory``, the peak of the live storages
    (``MemTracker``, the arguments included).  The counters are reset
    first; the kernels count as units (``api.kernels_as_units``) and the
    collectives are recorded (``collectives.recording_collectives``)."""
    from torch.utils.flop_counter import FlopCounterMode

    api.reset_kernel_work()
    collectives.reset_collective_records()
    tracker, reason = None, "not asked for"
    if memory:
        try:
            from torch.distributed._tools.mem_tracker import MemTracker
        except ImportError as e:  # the peak is then unknown, and says why
            reason = f"MemTracker unavailable in torch {torch.__version__}: {e}"
        else:
            tracker = MemTracker()
            tracker.track_external(*[t for t in tree_leaves(args) if isinstance(t, torch.Tensor)])
            reason = "MemTracker: the live storages' peak over the step, arguments included"
    flops, counter = FlopCounterMode(display=False), _ByteCounter()
    t0 = time.perf_counter()
    with api.kernels_as_units(), collectives.recording_collectives(), flops, counter:
        if tracker is not None:
            with tracker:
                out = step(*args)
        else:
            out = step(*args)
    seconds = time.perf_counter() - t0
    peak = None if tracker is None else _peak(tracker)
    work = api.kernel_work()
    k_ops = sum(w["ops"] for w in work.values())
    k_bytes = sum(w["bytes"] for w in work.values())
    aten_flops = float(flops.get_total_flops())
    return StepCount(
        flops=aten_flops + k_ops, bytes=float(counter.bytes + k_bytes), aten_flops=aten_flops,
        aten_bytes=float(counter.bytes), aten_ops=counter.ops, launches={k: w["calls"] for k, w in work.items()}, kernel_work=work,
        records=collectives.collective_records(), peak_bytes=peak, peak_reason=reason, seconds=seconds, outputs=out)


def output_bytes(out: Any) -> int:
    """Bytes of a step's outputs (a decode cache's ``seq_sharded`` names
    aside)."""
    if isinstance(out, dict):
        return sum(output_bytes(v) for k, v in out.items() if k != "seq_sharded")
    if isinstance(out, (tuple, list)):
        return sum(output_bytes(v) for v in out)
    return out.numel() * out.element_size() if isinstance(out, torch.Tensor) else 0


def _group_costs(cfg, cell, rules: MeshRules, flags: RunFlags, full: StepCount, coll) -> Dict[str, Any]:
    """JAX's ``scan_correction`` fields from 1-group and 2-group runs:

        body = u(2) - u(1);  outside = u(1) - body;  outside + G · body

    The port's whole count needs no correction; ``outside_plus_groups`` is
    held to it."""
    g = cfg.pattern_groups()
    plen = len(cfg.block_pattern)
    u = []
    for k in (1, 2):
        small = dataclasses.replace(cfg, n_layers=plen * k, n_enc_layers=(k if cfg.n_enc_layers else 0))
        step, args, _, _, _ = _build_step_args(small, cell, rules, flags)
        u.append(count_step(step, args))
    body = max(u[1].flops - u[0].flops, 0.0)
    outside = max(u[0].flops - body, 0.0)
    return {
        "flops": full.flops,
        "hbm_bytes": full.bytes,
        "collective_wire_bytes": coll.total_wire_bytes,
        "collective_operand_bytes": float(coll.total_operand_bytes),
        "per_group_flops": body,
        "outside_flops": outside,
        "groups": g,
        "outside_plus_groups_flops": outside + g * body,
        "corrected": False,
    }


# ---------------------------------------------------------------------------
# a cell
# ---------------------------------------------------------------------------


def run_cell(cfg, cell, rules: MeshRules, flags: RunFlags = DEFAULT_FLAGS, correction: bool = True,
             memory: bool = True) -> Dict[str, Any]:
    """The record's measured part for ``cfg`` × ``cell`` on this rank of
    ``rules``' mesh (a dry-run mesh, or any process mesh)."""
    from repro_torch.launch.memory_model import analytic_memory

    n_dev = rules.mesh.size
    step, args, specs, args_bytes, uneven = _build_step_args(cfg, cell, rules, flags)
    full = count_step(step, args, memory=memory)
    out_bytes = output_bytes(full.outputs)
    del step, args
    full.outputs = None
    coll = collective_stats(full.records)
    if correction:
        corrected = _group_costs(cfg, cell, rules, flags, full, coll)
    else:
        corrected = {"flops": full.flops, "hbm_bytes": full.bytes, "collective_wire_bytes": coll.total_wire_bytes,
                     "collective_operand_bytes": float(coll.total_operand_bytes), "per_group_flops": 0.0,
                     "outside_flops": 0.0, "groups": cfg.pattern_groups(), "corrected": False}
    mf = _model_flops_per_device(cfg, cell, n_dev)
    rl = roofline_terms(full.flops, full.bytes, coll, mf, peak_flops=H100_SXM.peak_flops,
                        hbm_bytes_per_s=H100_SXM.hbm_bytes_per_s, link_bytes_per_s=H100_SXM.link_bytes_per_s)
    return {
        "n_devices": n_dev,
        "rank": rules.mesh.device_mesh.get_rank() if hasattr(rules.mesh, "device_mesh") else RANK,
        "uneven_shards": uneven,
        "sharding_decisions": rules.decisions,
        "memory": {
            "argument_bytes_per_device": args_bytes,
            "output_bytes_per_device": out_bytes,
            "peak_bytes_per_device": full.peak_bytes,
            "peak_from": full.peak_reason,
            "analytic": analytic_memory(cfg, cell, rules, flags, specs, device_bytes=H100_SXM.memory_bytes),
        },
        "cost": {
            "flops": full.flops,
            "bytes_accessed": full.bytes,
            "aten_flops": full.aten_flops,
            "aten_bytes": full.aten_bytes,
            "aten_ops": full.aten_ops,
            "kernels": full.kernel_work,
            "scan_correction": corrected,
        },
        "launches": full.launches,
        "collectives": coll.to_json(),
        "roofline": rl.to_json(),
        "rates": H100_SXM.to_json(),
        "step_s": full.seconds,
    }


def lower_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    flags: RunFlags = DEFAULT_FLAGS,
    save: bool = True,
    verbose: bool = True,
    variant: str = "baseline",
    correction: bool = True,
) -> dict:
    """JAX's ``lower_cell``, run as rank ``RANK`` of the fake production mesh.
    ``compile_s`` is the seconds of the whole record (the port compiles
    nothing; ``step_s`` is the full step's own run)."""
    cfg = get_config(arch)
    cell = SHAPES_BY_NAME[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    record: dict = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "variant": variant,
        "flags": dataclasses.asdict(flags),
    }
    ok, why = cell_supported(cfg, cell)
    if not ok:
        record.update(status="skipped", reason=why)
        return _finish(record, save, verbose)

    t0 = time.time()
    try:
        with make_dryrun_mesh(multi_pod=multi_pod, rank=RANK) as mesh, torch.no_grad():
            measured = run_cell(cfg, cell, MeshRules.from_mesh(mesh), flags, correction)
        record.update(status="ok", compile_s=round(time.time() - t0, 1), **measured)
    except Exception as e:  # noqa: BLE001 — a failing cell is a bug report
        record.update(
            status="error",
            error=f"{type(e).__name__}: {e}",
            traceback=traceback.format_exc()[-4000:],
            compile_s=round(time.time() - t0, 1),
        )
    return _finish(record, save, verbose)


def _finish(record: dict, save: bool, verbose: bool) -> dict:
    if save:
        RESULTS_DIR.mkdir(parents=True, exist_ok=True)
        suffix = "" if record.get("variant", "baseline") == "baseline" else f"__{record['variant']}"
        name = f"{record['arch']}__{record['shape']}__{record['mesh']}{suffix}.json"
        (RESULTS_DIR / name).write_text(json.dumps(record, indent=2))
    if verbose:
        status = record["status"]
        line = f"[{record['mesh']}] {record['arch']:22s} {record['shape']:12s} {status}"
        if status == "ok":
            rl = record["roofline"]
            mem = record["memory"]
            peak = mem["peak_bytes_per_device"]
            line += (
                f"  run={record['compile_s']}s"
                f"  mem={mem['analytic']['analytic_peak_per_device']/2**30:.2f}GiB/dev"
                f"(peak {'n/a' if peak is None else f'{peak / 2**30:.1f}'})"
                f"  dom={rl['dominant']}"
                f"  (c={rl['compute_s']:.2e}s m={rl['memory_s']:.2e}s n={rl['collective_s']:.2e}s)"
            )
        elif status == "error":
            line += f"  {record['error'][:160]}"
        else:
            line += f"  {record['reason'][:80]}"
        print(line, flush=True)
    return record


def _lower_cell_args(args: tuple) -> dict:
    return lower_cell(*args)


def main() -> None:
    ap = argparse.ArgumentParser(description="PIMSAB-framework multi-pod dry-run (PyTorch port, meta tensors)")
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape cell or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--no-save", action="store_true")
    ap.add_argument("--no-correction", action="store_true",
                    help="skip the 1- and 2-group runs of the per-group fields (faster)")
    ap.add_argument("--skip-fresh", action="store_true",
                    help="skip cells whose saved record is already ok or skipped")
    # RunFlags overrides (perf hillclimb levers)
    ap.add_argument("--attn-chunk", type=int, default=DEFAULT_FLAGS.attn_chunk)
    ap.add_argument("--flash-threshold", type=int, default=DEFAULT_FLAGS.flash_threshold)
    ap.add_argument("--no-triangular", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-quant-serve", action="store_true")
    ap.add_argument("--quant-kv", action="store_true")
    ap.add_argument("--seq-shard-kv", action="store_true")
    ap.add_argument("--no-scan-layers", action="store_true")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--routing-groups", type=int, default=0)
    args = ap.parse_args()

    flags = RunFlags(
        attn_chunk=args.attn_chunk,
        flash_threshold=args.flash_threshold,
        triangular_attn=not args.no_triangular,
        remat=not args.no_remat,
        quant_serve=not args.no_quant_serve,
        quant_kv=args.quant_kv,
        seq_shard_kv=args.seq_shard_kv,
        scan_layers=not args.no_scan_layers,
        zero1=args.zero1,
        grad_accum=args.grad_accum,
        routing_groups=args.routing_groups,
    )
    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = [s.name for s in SHAPES] if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    cells = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                if args.skip_fresh:
                    mesh_name = "pod2x16x16" if mp else "pod16x16"
                    f = RESULTS_DIR / f"{arch}__{shape}__{mesh_name}.json"
                    if f.exists() and json.loads(f.read_text()).get("status") in ("ok", "skipped"):
                        continue
                cells.append((arch, shape, mp, flags, not args.no_save, True, args.variant, not args.no_correction))
    t0 = time.time()
    jobs = min(len(cells), len(os.sched_getaffinity(0)))
    if jobs > 1:
        # a cell a process (a fake process group is per process), one process a core; the long kinds
        # first (a prefill_32k cell runs minutes to hours op by op), so none starts last
        cells.sort(key=lambda c: ("prefill", "train", "decode").index(SHAPES_BY_NAME[c[1]].kind))
        with ProcessPoolExecutor(jobs, mp_context=multiprocessing.get_context("spawn")) as pool:
            records = list(pool.map(_lower_cell_args, cells))
    else:
        records = [_lower_cell_args(c) for c in cells]
    failures = sum(rec["status"] == "error" for rec in records)
    print(f"dry run: {len(records)} records in {time.time() - t0:.1f} s ({max(jobs, 1)} at once)", flush=True)
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


if __name__ == "__main__":
    main()
