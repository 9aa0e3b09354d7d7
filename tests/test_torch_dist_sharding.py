"""The port's sharding rules (``repro_torch.dist.sharding``) against the JAX
package's: the partition spec type, ``MeshRules``, and ``param_specs`` and
``serve.engine.cache_specs`` for all 10 configs at full size (on ``meta``)
on the meshes 16 × 16, 2 × 16 × 16, 4 × 4, 8 × 1 and 1 × 1, with
``seq_shard_kv`` off and on — every spec entry for entry and the decision
logs equal.  Also the port's SPMD side: the model's refusals, ``constrain``,
the batch split and the host mesh's refusals."""
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import PartitionSpec as JP  # noqa: E402

from _torch_specs_ref import (  # noqa: E402,F401
    MESHES,
    FakeMesh,
    assert_specs_equal,
    cached_shapes,
    rules_pair,
)
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.models.runtime import RunFlags as JFlags  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import reduced_config as treduced  # noqa: E402
from repro_torch.dist import sharding as tsh  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.runtime import RunFlags as TFlags  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

ARCHS = list_archs()
DECODE = [c for c in JSHAPES if c.kind == "decode"]


@pytest.mark.parametrize("entries", [(), (None,), ("data",), (("data",),), (("pod", "data"), None),
                                     (["pod", "data"], "model"), (None, "model", None)])
def test_partition_spec_equals_jax(entries):
    j, t = JP(*entries), tsh.P(*entries)
    assert tuple(t) == tuple(j) and len(t) == len(j) and repr(t) == repr(j)
    assert t == tuple(j) and t == tsh.P(*tuple(j)) and hash(t) == hash(tsh.P(*tuple(j)))
    assert (t == tsh.P(*entries, None)) == (j == JP(*entries, None))
    assert all(t[i] == j[i] for i in range(len(j)))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_rules_equal_jax(mesh):
    jr, tr = rules_pair(mesh, fake=True)
    assert (tr.dp, tr.tp, tr.dp_axes, tr.tp_axis) == (jr.dp, jr.tp, jr.dp_axes, jr.tp_axis)
    for b in (1, 2, 3, 8, 12, 16, 256):
        assert tr.batch_axes(b) == jr.batch_axes(b)
    for size in (1, 4, 14, 16, 896):
        assert tr.tp_if(size, "x") == jr.tp_if(size, "x")
    for b in (4, 5):
        assert tuple(tsh.act_spec(b, tr)) == tuple(jsh.act_spec(b, jr))
    assert tr.decisions == jr.decisions


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_equal_jax(arch, mesh):
    jcfg, tcfg = jget(arch), tget(arch)
    jr, tr = rules_pair(mesh, fake=True)
    assert_specs_equal(jsh.param_specs(jt.params_shape(jcfg), jcfg, jr),
                       tsh.param_specs(tt.params_shape(tcfg), tcfg, tr), f"{arch} param_specs")
    assert tr.decisions == jr.decisions
    for ssk in (False, True):
        for cell in DECODE:
            args = (cell.global_batch, cell.seq_len)
            assert_specs_equal(jengine.cache_specs(jcfg, *args, jr, JFlags(seq_shard_kv=ssk)),
                               tengine.cache_specs(tcfg, *args, tr, TFlags(seq_shard_kv=ssk)),
                               f"{arch} cache_specs {cell.name} seq_shard_kv={ssk}")
            assert tr.decisions == jr.decisions, (cell.name, ssk)
        for shape in ((128, 32768, jcfg.n_kv_heads, 64), (1, 2048, 4), (2, 16)):
            assert tuple(tsh.cache_entry_spec(shape, tcfg, tr, seq_shard_kv=ssk)) == \
                tuple(jsh.cache_entry_spec(shape, jcfg, jr, seq_shard_kv=ssk))
    assert tr.decisions == jr.decisions


def test_jax_fallback_cases_hold_in_the_port():
    """``tests/test_dist.py``'s divisibility and MoE cases."""
    r = tsh.MeshRules(mesh=FakeMesh({"data": 16, "model": 16}), dp_axes=("data",))
    cfg = tget("qwen2-0.5b")  # 14 heads, kv=2: both !% 16
    blk = tsh.param_specs(tt.params_shape(cfg), cfg, r)["blocks"]["00_attn"]
    assert blk["attn"]["wq"]["w"] == tsh.P(None, None, None) and blk["attn"]["wk"]["w"] == tsh.P(None, None, None)
    assert blk["ffn"]["w_gate"]["w"] == tsh.P(None, None, "model")
    assert blk["ffn"]["w_down"]["w"] == tsh.P(None, "model", None)
    assert any("replicated" in d for d in r.decisions)
    kimi = tget("kimi-k2-1t-a32b")
    specs = tsh.param_specs(tt.params_shape(kimi), kimi, r)
    assert specs["blocks"]["00_attn"]["attn"]["wq"]["w"] == tsh.P(None, None, "model")
    assert specs["blocks"]["00_attn"]["ffn"]["w_gate"] == tsh.P(None, "model", None, None)
    assert specs["embed"]["w"] == tsh.P("model", None)
    assert r.batch_axes(256) == ("data",) and r.batch_axes(1) is None


def test_constrain_is_the_identity():
    _, tr = rules_pair("8x1")
    x = torch.arange(6)
    assert tsh.constrain(x, tr, tsh.act_spec(8, tr)) is x and tsh.constrain(x, None, None) is x


def test_batch_shard_rows():
    """A rank's rows of a sharded batch, all rows of a replicated one; a mesh
    with no ranks runs one data shard and refuses more."""
    s = tsh.BatchShard(batch=16, dp=8, index=3, sharded=True, group=None)
    assert (s.rows, s.start) == (2, 6)
    assert s.take({"tokens": torch.arange(16)[:, None]})["tokens"].flatten().tolist() == [6, 7]
    r = tsh.BatchShard(batch=12, dp=8, index=3, sharded=False, group=None)
    assert (r.rows, r.start) == (12, 0)
    _, one = rules_pair("1x1")
    assert tsh.batch_shard(one, 12) == tsh.BatchShard(12, 1, 0, True, None)
    _, eight = rules_pair("8x1")
    with pytest.raises(ValueError, match="cannot run 8 data shards"):
        tsh.batch_shard(eight, 16)


def test_model_runs_data_parallel_rules_and_refuses_tensor_parallel():
    cfg = treduced(tget("qwen2-0.5b"))
    p = tt.init_params(cfg, 0, device="cpu")
    batch = {"tokens": torch.randint(2, cfg.vocab_size, (2, 8), dtype=torch.int32)}
    _, one = rules_pair("1x1")
    want, _ = tt.forward(p, cfg, batch)
    got, aux = tt.forward(p, cfg, batch, rules=one)
    assert torch.equal(want, got) and float(aux) == 0.0
    _, tp = rules_pair("4x4")  # a layout with no ranks: tensor-parallel rules run on a process mesh only
    with pytest.raises(ValueError, match="make_host_mesh"):
        tt.forward(p, cfg, batch, rules=tp)
    with pytest.raises(TypeError, match="MeshRules"):
        tt.forward(p, cfg, batch, rules=object())


def test_production_mesh_describes_the_pods():
    m = tmesh.make_production_mesh()
    assert (m.axis_names, m.shape, m.size) == (("data", "model"), {"data": 16, "model": 16}, 256)
    m = tmesh.make_production_mesh(multi_pod=True)
    assert (m.axis_names, m.size) == (("pod", "data", "model"), 512)
    r = tsh.MeshRules.from_mesh(m)
    assert (r.dp_axes, r.dp, r.tp) == (("pod", "data"), 32, 16)


def test_host_mesh_needs_a_process_group_of_the_device_s_backend():
    with pytest.raises(RuntimeError, match="initialised process group"):
        tmesh.make_host_mesh(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmesh.make_host_mesh()


def test_host_mesh_over_one_gloo_rank(tmp_path):
    """A (1, 1) gloo mesh: each axis's group and this rank's coordinates,
    read through the rules; a CUDA mesh over gloo is refused."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdzv'}", world_size=1, rank=0)
    try:
        mesh = tmesh.make_host_mesh(device="cpu")
        assert (mesh.axis_names, mesh.shape, mesh.device_type) == (("data", "model"), {"data": 1, "model": 1}, "cpu")
        assert mesh.coordinate("data") == mesh.coordinate(("data",)) == 0
        assert dist.get_world_size(mesh.group("data")) == 1 and str(dist.get_backend(mesh.group("model"))) == "gloo"
        rules = tsh.MeshRules.from_mesh(mesh)
        assert tsh.data_group(rules) is mesh.group("data") and tsh.data_index(rules) == 0
        with pytest.raises(ValueError, match="one data axis"):
            mesh.group(("data", "model"))
        if torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="nccl"):
                tmesh.make_host_mesh()
    finally:
        dist.destroy_process_group()
