"""The dry run's counters (``repro_torch.launch.hlo_analysis``,
``dist.collectives``' records, the kernels' meta route and work), held to
the JAX package and to live runs on the CPU:

* ``collective_stats`` of records equals JAX's ``parse_collectives`` of the
  same collectives written as HLO lines (counts, operand and wire bytes);
* ``roofline_terms`` equals JAX's at JAX's rates (test data here only);
* a step counted on ``meta`` tensors (``dryrun.count_step`` on a fake (1, 1)
  mesh) gives the FLOPs, bytes, PyTorch ops, kernel launches and work,
  collective records and argument and output bytes of the same step run
  live on the CPU (a gloo group of one rank), for every reduced config and
  step kind;
* the kernels' meta route, the fake group's refusals and the records of
  each collective."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import hlo_analysis as jhlo  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.configs import reduced_config as treduced  # noqa: E402
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.dist import collectives as tcoll  # noqa: E402
from repro_torch.dist.sharding import MeshRules  # noqa: E402
from repro_torch.kernels import api  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import hlo_analysis as thlo  # noqa: E402
from repro_torch.launch.mesh import make_dryrun_mesh, make_host_mesh  # noqa: E402
from repro_torch.models.runtime import RunFlags  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
# JAX's roofline constants (src/repro/launch/mesh.py), test data only
JAX_RATES = dict(peak_flops=197e12, hbm_bytes_per_s=819e9, link_bytes_per_s=50e9)
DTYPES = {"f32": 4, "bf16": 2, "s8": 1, "s32": 4}
# small sequences through the chunked attention: a step of each kind at every reduced config
FLAGS = RunFlags(attn_chunk=16, flash_threshold=64)
CELLS = (ShapeCell("t", "train", 32, 4), ShapeCell("p", "prefill", 32, 4), ShapeCell("d", "decode", 32, 4))


def _collectives(seed: int, n: int = 24):
    """``n`` collectives: (op, dtype, output dims, group size)."""
    rng = np.random.default_rng(seed)
    ops = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")
    out = []
    for _ in range(n):
        op = ops[rng.integers(len(ops))]
        g = int(rng.choice([2, 4, 8, 16, 32]))
        dims = [int(rng.integers(1, 64)) for _ in range(int(rng.integers(1, 4)))]
        if op == "all-gather":
            dims[0] *= g  # the gathered output: g shards
        out.append((op, str(rng.choice(list(DTYPES))), dims, g))
    return out


def _hlo(colls):
    lines = []
    for i, (op, dt, dims, g) in enumerate(colls):
        shape = f"{dt}[{','.join(map(str, dims))}]"
        groups = "source_target_pairs={{0,1}}" if op == "collective-permute" else \
            f"replica_groups=[{512 // g},{g}]<=[512]"
        lines.append(f"  %c.{i} = {shape}{{0}} {op}(%x.{i}), {groups}")
    return "\n".join(lines)


def _records(colls):
    """The same collectives as ``dist.collectives`` records them: each by
    the operand a rank hands it."""
    recs = []
    for op, dt, dims, g in colls:
        out = int(np.prod(dims)) * DTYPES[dt]
        operand = {"all-gather": out // g, "reduce-scatter": out * g}.get(op, out)
        recs.append(tcoll.CollectiveRecord(op, operand, g, "nvlink", 1))
    return recs


def _stats_dict(s):
    return {"counts": s.counts, "operand_bytes": s.operand_bytes, "wire_bytes": s.wire_bytes}


@pytest.mark.parametrize("seed", range(4))
def test_collective_stats_equals_parse_collectives(seed):
    colls = _collectives(seed)
    want = jhlo.parse_collectives(_hlo(colls))
    got = thlo.collective_stats(_records(colls))
    assert sum(want.counts.values()) == len(colls)
    assert _stats_dict(got) == _stats_dict(want)
    assert (got.total_operand_bytes, got.total_wire_bytes) == (want.total_operand_bytes, want.total_wire_bytes)
    assert got.link_wire_bytes == {"nvlink": got.total_wire_bytes}


def test_collective_stats_of_test_dists_four_ops_and_all_to_all():
    """``tests/test_dist.py``'s four HLO lines plus an all-to-all, as records."""
    hlo = """
  %all-reduce.1 = f32[1024,512]{1,0} all-reduce(%x), replica_groups=[16,16]<=[256], to_apply=%add
  %ag = bf16[4096]{0} all-gather(%y), replica_groups=[32,8]<=[256], dimensions={0}
  %rs = f32[128]{0} reduce-scatter(%z), replica_groups=[8,4]<=[32], dimensions={0}
  %cp = bf16[64,64]{1,0} collective-permute(%w), source_target_pairs={{0,1}}
  %a2a = s8[8,96]{1,0} all-to-all(%v), replica_groups=[64,8]<=[512], dimensions={0}
"""
    recs = [tcoll.CollectiveRecord("all-reduce", 1024 * 512 * 4, 16, "infiniband", 1),
            tcoll.CollectiveRecord("all-gather", 4096 * 2 // 8, 8, "nvlink", 1),
            tcoll.CollectiveRecord("reduce-scatter", 128 * 4 * 4, 4, "nvlink", 1),
            tcoll.CollectiveRecord("collective-permute", 64 * 64 * 2, 2, "nvlink", 1),
            tcoll.CollectiveRecord("all-to-all", 8 * 96, 8, "nvlink", 1)]
    want, got = jhlo.parse_collectives(hlo), thlo.collective_stats(recs)
    assert _stats_dict(got) == _stats_dict(want)
    assert got.link_wire_bytes["infiniband"] == got.wire_bytes["all-reduce"] == 2 * 1024 * 512 * 4 * 15 / 16
    # a record of count 3 is three calls
    three = thlo.collective_stats([recs[0]._replace(count=3)])
    assert three.counts == {"all-reduce": 3} and three.operand_bytes == {"all-reduce": 3 * 1024 * 512 * 4}


@pytest.mark.parametrize("flops,nbytes,model", [(1e12, 1e9, 5e11), (3.3e9, 7.1e11, 0.0), (0.0, 1.0, 0.0),
                                                (8.8e15, 2.2e12, 4.4e15)])
def test_roofline_terms_equals_jax_at_the_same_rates(flops, nbytes, model):
    colls = _collectives(7)
    jstats, tstats = jhlo.parse_collectives(_hlo(colls)), thlo.collective_stats(_records(colls))
    want = jhlo.roofline_terms(flops, nbytes, jstats, model)  # links=3, JAX's default
    got = thlo.roofline_terms(flops, nbytes, tstats, model, links=3, **JAX_RATES)
    assert got.to_json() == want.to_json()


def test_h100_rates_and_each_link_at_its_own_rate():
    r = thlo.H100_SXM
    assert (r.name, r.power_limit_w, r.peak_flops, r.hbm_bytes_per_s) == ("NVIDIA H100 80GB HBM3", 700.0, 989e12,
                                                                           3.35e12)
    assert "H100" in r.source and "data sheet" in r.source
    stats = thlo.collective_stats([tcoll.CollectiveRecord("all-reduce", 1000, 2, "nvlink", 1),
                                   tcoll.CollectiveRecord("all-reduce", 1000, 2, "infiniband", 1)])
    rl = thlo.roofline_terms(1e12, 1e9, stats, peak_flops=r.peak_flops, hbm_bytes_per_s=r.hbm_bytes_per_s,
                             link_bytes_per_s=r.link_bytes_per_s)
    assert rl.collective_s == 1000 / r.link_bytes_per_s["nvlink"] + 1000 / r.link_bytes_per_s["infiniband"]
    assert rl.compute_s == 1e12 / 989e12 and rl.memory_s == 1e9 / 3.35e12


def test_no_tpu_rate_in_the_port():
    """JAX's TPU v5e roofline constants appear nowhere in the port."""
    tpu = re.compile(r"\b(197e12|819e9|197\s*TFLOP|819\s*GB/s|v5e)\b")
    for path in sorted((REPO / "src" / "repro_torch").rglob("*.py")):
        if "core" in path.relative_to(REPO / "src" / "repro_torch").parts:
            continue  # the PIMSAB simulator's copy: no device rates
        assert not tpu.search(path.read_text()), path


# ---------------------------------------------------------------------------
# the kernels' meta route and work
# ---------------------------------------------------------------------------


def _meta(*shape, dtype=torch.int8):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_kernels_meta_route_shapes_launches_and_work():
    from repro_torch.kernels import attention, bitslice_matmul, rglru_scan

    api.reset_launch_counts()
    api.reset_kernel_work()

    def calls():
        out = bitslice_matmul.bitslice_matmul(_meta(2, 5, 32), _meta(2, 32, 7), slice_bits=8, skip=((1, 1),))
        assert (out.device.type, out.dtype, tuple(out.shape)) == ("meta", torch.int32, (5, 7))
        qk = attention.attention_qk(_meta(3, 16), _meta(40, 16))
        assert (qk.device.type, qk.dtype, tuple(qk.shape)) == ("meta", torch.int32, (3, 40))
        a = _meta(2, 9, 6, dtype=torch.float32)
        hs = rglru_scan.rglru_scan(a, a, _meta(2, 6, dtype=torch.float32))
        assert (hs.device.type, tuple(hs.shape)) == ("meta", (2, 9, 6))
        da, db, dh0 = rglru_scan._scan_bwd(a, _meta(2, 6, dtype=torch.float32), a, a, True)
        assert tuple(da.shape) == tuple(db.shape) == (2, 9, 6) and tuple(dh0.shape) == (2, 6)

    calls()  # outside kernels_as_units: nothing noted
    assert api.kernel_work() == {}
    with api.kernels_as_units():
        calls()
    assert api.launch_counts() == {}  # the meta route launches nothing, and counts no launch
    # (0,0), (0,1), (1,0) live: both x and both w slices read
    assert api.kernel_work() == {
        "bitslice_matmul": {"calls": 1, "ops": 2 * 5 * 32 * 7 * 3, "bytes": 2 * 5 * 32 + 2 * 32 * 7 + 4 * 5 * 7},
        "attention_qk": {"calls": 1, "ops": 2 * 3 * 40 * 16, "bytes": 3 * 16 + 40 * 16 + 4 * 3 * 40},
        "rglru_scan": {"calls": 1, "ops": 2 * 108, "bytes": 4 * (3 * 108 + 12)},
        "rglru_scan_bwd": {"calls": 1, "ops": 3 * 108, "bytes": 4 * (5 * 108 + 2 * 12)},
    }


def _refused_on_meta():
    from repro_torch.kernels import attention, bitslice_matmul, rglru_scan

    f32 = torch.float32
    return {
        "bitslice int32 slices": (TypeError, "int8 slice stacks", lambda: bitslice_matmul._bitslice_gemm(
            _meta(1, 4, 8, dtype=torch.int32), _meta(1, 8, 4, dtype=torch.int32), 8, ((0, 0),))),
        "bitslice too many slices": (ValueError, "at most", lambda: bitslice_matmul._bitslice_gemm(
            _meta(bitslice_matmul.MAX_SLICES + 1, 4, 8), _meta(1, 8, 4), 8, ((0, 0),))),
        "bitslice index range": (ValueError, "index range", lambda: bitslice_matmul._bitslice_gemm(
            _meta(1, 4, 2**31), _meta(1, 2**31, 4), 8, ((0, 0),))),
        "qk float operands": (TypeError, "operands, got", lambda: attention._qk(_meta(3, 16, dtype=f32), _meta(40, 16, dtype=f32))),
        "qk index range": (ValueError, "index range", lambda: attention._qk(_meta(2**16, 64), _meta(2**16, 64))),
        "scan bfloat16": (TypeError, "float32", lambda: rglru_scan._scan(*(_meta(2, 3, 4, dtype=torch.bfloat16),) * 2,
                                                                         _meta(2, 4, dtype=torch.bfloat16))),
        "scan index range": (ValueError, "index range", lambda: rglru_scan._scan(
            _meta(2**16, 2**8, 2**8, dtype=f32), _meta(2**16, 2**8, 2**8, dtype=f32), _meta(2**16, 2**8, dtype=f32))),
        "scan backward index range": (ValueError, "index range", lambda: rglru_scan._scan_bwd(
            *(_meta(2**16, 2**8, 2**8, dtype=f32), _meta(2**16, 2**8, dtype=f32)) + (_meta(2**16, 2**8, 2**8, dtype=f32),) * 2,
            True)),
    }


@pytest.mark.parametrize("case", list(_refused_on_meta()))
def test_meta_route_refuses_what_the_card_refuses(case):
    err, match, call = _refused_on_meta()[case]
    with pytest.raises(err, match=match):
        call()


@pytest.mark.parametrize("kernel", ["bitslice_matmul", "attention_qk", "rglru_scan", "rglru_scan_bwd"])
def test_meta_route_skips_an_empty_output_as_the_card_does(kernel):
    from repro_torch.kernels import attention, bitslice_matmul, rglru_scan

    f32 = torch.float32
    call = {"bitslice_matmul": lambda: bitslice_matmul._bitslice_gemm(_meta(1, 0, 8), _meta(1, 8, 4), 8, ((0, 0),)),
            "attention_qk": lambda: attention._qk(_meta(3, 16), _meta(0, 16)),
            "rglru_scan": lambda: rglru_scan._scan(_meta(2, 0, 4, dtype=f32), _meta(2, 0, 4, dtype=f32),
                                                   _meta(2, 4, dtype=f32)),
            "rglru_scan_bwd": lambda: rglru_scan._scan_bwd(_meta(2, 0, 4, dtype=f32), _meta(2, 4, dtype=f32),
                                                           _meta(2, 0, 4, dtype=f32), _meta(2, 0, 4, dtype=f32), True)}
    api.reset_kernel_work()
    with api.kernels_as_units():
        out = call[kernel]()
    first = out[0] if isinstance(out, tuple) else out
    assert first.device.type == "meta" and first.numel() == 0
    assert api.kernel_work() == {}  # no launch on the card, so no call noted


def test_kernels_without_a_meta_route_refuse_meta():
    for call in (lambda: api.int_matmul(_meta(4, 8, dtype=torch.int32), _meta(8, 4, dtype=torch.int32)),
                 lambda: api.relu(_meta(4, dtype=torch.int32)),
                 lambda: api.decode_gemv(_meta(4, 8), _meta(8)),
                 lambda: api.htree_reduce(_meta(4, 8, dtype=torch.float32))):
        with pytest.raises(ValueError, match="not 'meta'"):
            call()


def test_cpu_calls_note_work_and_kernels_as_units_hides_the_plain_version():
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import bitslice_matmul

    g = torch.Generator().manual_seed(0)
    x = torch.randint(-128, 128, (1, 8, 16), generator=g, dtype=torch.int8)
    w = torch.randint(-128, 128, (1, 16, 4), generator=g, dtype=torch.int8)
    api.reset_launch_counts()
    api.reset_kernel_work()
    want = bitslice_matmul.bitslice_matmul(x, w)
    with FlopCounterMode(display=False) as seen:
        bitslice_matmul.bitslice_matmul(x, w)
    assert seen.get_total_flops() > 0  # the plain version's float64 product, outside kernels_as_units
    assert api.kernel_work() == {}  # and no work noted there
    with api.kernels_as_units(), FlopCounterMode(display=False) as hidden:
        got = bitslice_matmul.bitslice_matmul(x, w)
    assert hidden.get_total_flops() == 0 and torch.equal(got, want)
    assert api.launch_counts() == {} and api.kernel_work()["bitslice_matmul"]["calls"] == 1


# ---------------------------------------------------------------------------
# the fake group and the records
# ---------------------------------------------------------------------------


def test_fake_group_takes_meta_and_refuses_cpu_tensors():
    with make_dryrun_mesh(shape=(2, 2), rank=3) as mesh:
        g = mesh.group("model")
        assert str(torch.distributed.get_backend(g)) == "fake"
        assert (mesh.coordinate("data"), mesh.coordinate("model"), mesh.device_type) == (1, 1, "meta")
        tcoll.reset_collective_records()
        x = torch.empty((4, 8), device="meta")
        assert tcoll.all_reduce_(x, g) is x
        with pytest.raises(RuntimeError, match="a cpu tensor on a fake process group"):
            tcoll.all_reduce_(torch.ones(3), g)
    assert not torch.distributed.is_initialized()


def test_make_dryrun_mesh_refuses_a_live_group(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdzv'}", world_size=1, rank=0)
    try:
        with pytest.raises(RuntimeError, match="already exists"):
            with make_dryrun_mesh():
                pass
        assert str(dist.get_backend()) == "gloo"
    finally:
        dist.destroy_process_group()


def test_each_collective_leaves_its_record():
    from repro_torch.dist import sharding

    with make_dryrun_mesh(shape=(2, 4), rank=5) as mesh:
        tcoll.reset_collective_records()
        tcoll.reset_call_counts()
        x = torch.empty((8, 6), dtype=torch.bfloat16, device="meta")
        tcoll.all_reduce_(x, mesh.group("model"))  # outside recording_collectives: no record
        assert tcoll.collective_records() == []
        tcoll.reset_call_counts()
        with tcoll.recording_collectives():
            tcoll.all_reduce_(x, mesh.group("model"))
            out = tcoll.all_gather_dim(x, 1, 2, mesh.group("data"))
            assert tuple(out.shape) == (8, 12) and out.device.type == "meta"
            tcoll.shuffle(x, mesh, "model")
            tcoll.htree_allreduce(x, mesh, "model")  # a butterfly: log2(4) send/recv pairs
            tcoll.all_reduce_(x, mesh.group("model"))
        assert tcoll.collective_records() == [
            tcoll.CollectiveRecord("all-reduce", 96, 4, "nvlink", 2),
            tcoll.CollectiveRecord("all-gather", 96, 2, "nvlink", 1),
            tcoll.CollectiveRecord("all-to-all", 96, 4, "nvlink", 1),
            tcoll.CollectiveRecord("collective-permute", 96, 4, "nvlink", 2),
        ]
        assert tcoll.call_counts() == {"all_reduce": 2, "all_gather_into_tensor": 1, "all_to_all_single": 1,
                                       "batch_isend_irecv": 2}
        rules = MeshRules.from_mesh(mesh)
        assert sharding.data_index(rules) == 1 and sharding.model_index(rules) == 1
    with make_dryrun_mesh(rank=17) as mesh:  # 16 x 16: a model group spans two 8-GPU nodes
        assert tcoll.group_link(mesh.group("model")) == "infiniband"
        assert tcoll.group_link(mesh.group("data")) == "infiniband"
    with make_dryrun_mesh(shape=(4, 8)) as mesh:
        assert (tcoll.group_link(mesh.group("model")), tcoll.group_link(mesh.group("data"))) == \
            ("nvlink", "infiniband")


def test_multi_pod_mesh_groups_pod_and_data_together():
    with make_dryrun_mesh(multi_pod=True, rank=300) as mesh:
        assert mesh.shape == {"pod": 2, "data": 16, "model": 16} and mesh.size == 512
        rules = MeshRules.from_mesh(mesh)
        assert rules.dp_axes == ("pod", "data") and rules.dp == 32
        g = mesh.group(("pod", "data"))
        assert torch.distributed.get_world_size(g) == 32
        # rank 300 = pod 1, data 2, model 12: row 16 + 2 of the flattened data axes
        assert mesh.coordinate(("pod", "data")) == 18 and mesh.coordinate("model") == 12
        with pytest.raises(ValueError, match="one data axis"):
            mesh.group(("data", "model"))


# ---------------------------------------------------------------------------
# a step counted on meta tensors against the same step live on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def meta_counts():
    """Every reduced config's steps counted on a fake (1, 1) mesh."""
    out = {}
    for arch in list_archs():
        cfg = treduced(tget(arch))
        for cell in CELLS:
            with make_dryrun_mesh(shape=(1, 1)) as mesh, torch.no_grad():
                step, args, _, args_bytes, uneven = dryrun._build_step_args(cfg, cell, MeshRules.from_mesh(mesh),
                                                                            FLAGS)
                c = dryrun.count_step(step, args)
            assert not uneven
            out[arch, cell.kind] = (c, args_bytes, dryrun.output_bytes(c.outputs))
    return out


@pytest.mark.parametrize("kind", [c.kind for c in CELLS])
@pytest.mark.parametrize("arch", list_archs())
def test_meta_step_counts_equal_the_live_cpu_step(meta_counts, arch, kind, tmp_path):
    import torch.distributed as dist

    cfg, cell = treduced(tget(arch)), next(c for c in CELLS if c.kind == kind)
    meta, args_bytes, out_bytes = meta_counts[arch, kind]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdzv'}", world_size=1, rank=0)
    try:
        rules = MeshRules.from_mesh(make_host_mesh(device="cpu"))
        step, args = dryrun.live_step_args(cfg, cell, rules, FLAGS, "cpu")
        api.reset_launch_counts()
        with torch.no_grad():
            live = dryrun.count_step(step, args)
    finally:
        dist.destroy_process_group()
    assert api.launch_counts() == {}  # the CPU runs plain versions: no launch, only the work noted
    assert all(t.device.type == "cpu" for t in live.outputs[1].values()) if kind == "train" else \
        live.outputs[1].device.type == "cpu"
    assert (meta.flops, meta.aten_flops, meta.bytes, meta.aten_ops) == \
        (live.flops, live.aten_flops, live.bytes, live.aten_ops)
    assert meta.flops > 0 and meta.kernel_work == live.kernel_work and meta.records == live.records
    assert meta.launches == live.launches == {k: w["calls"] for k, w in live.kernel_work.items()}
    assert (args_bytes, out_bytes) == (dryrun.tree_bytes(args), dryrun.output_bytes(live.outputs))
    if kind != "train" and cfg.quant.enabled:
        assert meta.launches["bitslice_matmul"] > 0


def test_cli_help_names_the_jax_flags():
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--help"], capture_output=True, text=True,
                       timeout=120, cwd=str(REPO), env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert r.returncode == 0, r.stderr
    for flag in ("--arch", "--shape", "--mesh", "--variant", "--no-save", "--no-correction", "--skip-fresh",
                 "--attn-chunk", "--flash-threshold", "--no-triangular", "--no-remat", "--no-quant-serve",
                 "--quant-kv", "--seq-shard-kv", "--no-scan-layers", "--zero1", "--grad-accum",
                 "--routing-groups"):
        assert flag in r.stdout
