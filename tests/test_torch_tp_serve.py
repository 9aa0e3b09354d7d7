"""The port's tensor-parallel serving steps against the JAX package's: each
case runs ``serve.engine.make_prefill_step`` and two ``make_decode_step``
calls under ``MeshRules`` on gloo process groups of CPU processes, on each
rank's slices of JAX's weights (``sharding.shard_params``), and JAX's
jitted steps under ``MeshRules.from_mesh`` of the same forced mesh with the
parameters placed by ``param_specs``.

* Meshes (data, model): (1, 2) on a world of 2 ranks, (2, 2) and (1, 4) on a
  world of 4; each world one gloo group for all its cases, each side under
  its own time limit (``tests/_torch_dist_ref.py``).
* Cases: all ten configs at ``reduced_config`` in float32 with int8 weights
  and an int8 KV cache, and without quantization; Granite (one KV head) under
  ``RunFlags.seq_shard_kv`` at (1, 2), whose cache keeps its rows split over
  the model axis at rest; Qwen2, RecurrentGemma and DBRX in bfloat16.
* Tolerances (``tests/_torch_lm_ref.py``): float32 within 1e-5 of the largest
  JAX logit, 2**-6 with int8 activations or KV (the JAX package's own drift
  across meshes is at most 2.3e-6); bfloat16 within 2**-4 of JAX run op by
  op (XLA's partitioned fusion moves JAX's own jitted bfloat16 logits by
  1-3%), with the routing groups of the mesh's data axis.
* The port at tp = k against the port without rules: every quantized linear
  bit-equal (its int32 accumulator added over the axis, the row absmax taken
  over it), with one slice pair and with ``w8a16``'s two, and the logits
  within the same class; every rank returns the same global logits, and
  ``gather_params`` gives back the unsharded weights bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_dist_ref import start_jax, start_ranks  # noqa: E402
from _torch_lm_ref import ARCHS, FAMILIES, FLAG_KW, assert_close, jax_steps, to_np, tol  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.models import common as jc  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.models.runtime import RunFlags as JFlags  # noqa: E402

MESHES = ((1, 2), (2, 2), (1, 4))
B, S, MAX_LEN, STEPS = 4, 8, 16, 2
QUANT = dict(FLAG_KW, quant_serve=True, quant_kv=True)
FLOAT = dict(FLAG_KW, quant_serve=False, quant_kv=False)
BF16 = ("qwen2-0.5b", "recurrentgemma-2b", "dbrx-132b")
CASES = tuple(
    [{"name": f"{a}/q", "arch": a, "dtype": "float32", "flags": QUANT, "meshes": MESHES} for a in ARCHS + FAMILIES]
    + [{"name": f"{a}/f", "arch": a, "dtype": "float32", "flags": FLOAT, "meshes": MESHES} for a in ARCHS + FAMILIES]
    + [{"name": f"granite-20b/seq{q}", "arch": "granite-20b", "dtype": "float32",
        "flags": dict(flags, seq_shard_kv=True), "meshes": ((1, 2),)} for q, flags in (("q", QUANT), ("f", FLOAT))]
    + [{"name": f"{a}/bf16", "arch": a, "dtype": "bfloat16", "flags": dict(FLAG_KW, quant_serve=True),
        "meshes": ((1, 2), (2, 2))} for a in BF16])


def _np(leaf):
    a = np.asarray(leaf)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _params(case):
    cfg = dataclasses.replace(jreduced(jget(case["arch"])), dtype=case["dtype"])
    params = jt.init_params(jax.random.key(0), cfg)
    if case["flags"].get("quant_serve", True):
        params = jc.maybe_quantize_tree(params, cfg)
    return cfg, params


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(2, cfg.vocab_size, (B, S)).astype(np.int32)}
    for name, on, rows in (("patch_embeds", cfg.frontend == "vision", cfg.n_patches),
                           ("enc_embeds", cfg.is_encdec, cfg.enc_seq_len)):
        if on:
            batch[name] = _np(jax.numpy.asarray(rng.standard_normal((B, rows, cfg.d_model)).astype(np.float32),
                                                cfg.dtype))
    feed = rng.integers(2, cfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    return batch, feed


def _inputs():
    out = {}
    for i, case in enumerate(CASES):
        cfg, params = _params(case)
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            out[f"{case['name']}/params/" + "/".join(k.key for k in path)] = _np(leaf)
        batch, feed = _batch(cfg, 11 + i)
        out.update({f"{case['name']}/batch/{k}": v for k, v in batch.items()})
        out[f"{case['name']}/feed"] = feed
    return out


def _jax_eager(case, inputs, dp):
    """JAX's prefill and decode steps run op by op (no jit, no scan), routed
    in ``dp`` groups as on a mesh whose data axis is ``dp``."""
    cfg, params = _params(case)
    fl = JFlags(**case["flags"], scan_layers=False, routing_groups=dp)
    _, _, pre, dec = jax_steps(cfg, fl, MAX_LEN, eager=True)
    name = case["name"]
    batch = {k[len(name) + 7:]: v for k, v in inputs.items() if k.startswith(f"{name}/batch/")}
    batch = {k: (jax.numpy.asarray(v.view(jax.numpy.bfloat16)) if v.dtype == np.uint16 else jax.numpy.asarray(v))
             for k, v in batch.items()}
    cache, logits = pre(params, batch)
    out = {"prefill": np.asarray(logits, np.float32)}
    for i in range(STEPS):
        cache, logits = dec(params, cache, jax.numpy.asarray(inputs[f"{name}/feed"][i]))
        out[f"decode{i}"] = np.asarray(logits, np.float32)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's jitted outputs by mesh, JAX's op-by-op bfloat16 outputs,
    {world: each rank's results}); every group side by side under its own
    time limit."""
    tmp = tmp_path_factory.mktemp("tp_serve")
    inputs = _inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    spec = {"inputs": str(tmp / "inputs.npz"), "cases": list(CASES), "meshes": [list(m) for m in MESHES],
            "max_len": MAX_LEN}
    f32 = [c for c in CASES if c["dtype"] == "float32"]
    jax_runs = []
    for m in MESHES:  # one JAX process a mesh, side by side
        (tmp / f"m{m[0]}x{m[1]}").mkdir()
        jax_runs.append(start_jax("tp_serve", tmp / f"m{m[0]}x{m[1]}", dict(spec, cases=f32, meshes=[list(m)]),
                                  timeout=240))
    ranks = {w: start_ranks("tp_serve", w, tmp, spec, timeout=240) for w in (2, 4)}
    eager = {(c["name"], dp): _jax_eager(c, inputs, dp) for c in CASES if c["dtype"] == "bfloat16"
             for dp in sorted({m[0] for m in c["meshes"]})}
    want = {}
    for g in jax_runs:
        want.update(g.results())
    return want, eager, {w: g.results() for w, g in ranks.items()}


def _world(mesh):
    return mesh[0] * mesh[1]


def _cases(dtype):
    return [(c["name"], m) for c in CASES if c["dtype"] == dtype for m in c["meshes"]]


@pytest.mark.parametrize("name,mesh", _cases("float32"), ids=lambda v: f"{v[0]}x{v[1]}" if isinstance(v, tuple) else v)
def test_tp_serving_equals_jax_on_the_same_mesh(runs, name, mesh):
    want_all, _, ranks = runs
    case = next(c for c in CASES if c["name"] == name)
    rel = tol("float32", case["flags"]["quant_serve"] or case["flags"]["quant_kv"])
    tag = f"{name}/{mesh[0]}x{mesh[1]}"
    first = ranks[_world(mesh)][0]
    for res in ranks[_world(mesh)]:
        for k in ["prefill"] + [f"decode{i}" for i in range(STEPS)]:
            got, want = to_np(res[f"{tag}/{k}"]), want_all[f"{tag}/{k}"]
            assert_close(want, got, rel, f"{tag} {k}")
            assert torch.equal(res[f"{tag}/{k}"], first[f"{tag}/{k}"]), f"{tag} {k}: ranks differ"
        assert res[f"{tag}/gathered_equal"]  # gather_params(shard_params(p)) is p, bit for bit
    # the cache, gathered to the global layout, against JAX's
    jkeys = sorted(k[len(tag) + 7:] for k in want_all if k.startswith(f"{tag}/cache/"))
    assert jkeys == sorted(k[len(tag) + 7:] for k in first if k.startswith(f"{tag}/cache/"))
    for k in jkeys:
        got, want = to_np(first[f"{tag}/cache/{k}"]), want_all[f"{tag}/cache/{k}"]
        assert got.shape == want.shape, k
        if want.dtype == np.int8:  # int8 payloads of float K/V that agree to an ulp
            assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max(initial=0) <= 1, k
        elif want.size:
            assert_close(want, got, rel, f"{tag} cache {k}")
    assert first[f"{tag}/calls"].get("reduce_from_model", 0) > 0, first[f"{tag}/calls"]
    # init_cache(..., rules=) lays an empty cache out as the prefill leaves its own
    seq, shapes = first[f"{tag}/init_cache_layout"]
    assert seq == first[f"{tag}/seq_sharded"]
    assert shapes == {k[len(tag) + 6:]: v for k, v in first.items() if k.startswith(f"{tag}/rest/")}


@pytest.mark.parametrize("name,mesh", _cases("float32"), ids=lambda v: f"{v[0]}x{v[1]}" if isinstance(v, tuple) else v)
def test_tp_against_tp1_is_bit_equal_on_the_quantized_linears(runs, name, mesh):
    """At tp = k every quantized linear gives the unsharded one's result bit
    for bit (its int32 accumulator added over the model axis); the logits
    stay within the class of the port without rules, whose routing groups
    are the same at dp = 1."""
    _, _, ranks = runs
    case = next(c for c in CASES if c["name"] == name)
    tag = f"{name}/{mesh[0]}x{mesh[1]}"
    rel = tol("float32", case["flags"]["quant_serve"] or case["flags"]["quant_kv"])
    for res in ranks[_world(mesh)]:
        if case["flags"]["quant_serve"]:
            checks = res[f"{tag}/int32_equal"]
            assert checks and all(checks.values()), checks
        else:
            assert f"{tag}/int32_equal" not in res
    first = ranks[_world(mesh)][0]
    if mesh[0] == 1 or not jreduced(jget(case["arch"])).is_moe:
        for k in ["prefill"] + [f"decode{i}" for i in range(STEPS)]:
            assert_close(to_np(first[f"{name}/ref/{k}"]), to_np(first[f"{tag}/{k}"]), rel, f"{tag} {k} vs tp = 1")


@pytest.mark.parametrize("name,mesh", _cases("bfloat16"), ids=lambda v: f"{v[0]}x{v[1]}" if isinstance(v, tuple) else v)
def test_tp_serving_bf16_equals_jax_op_by_op(runs, name, mesh):
    _, eager, ranks = runs
    want = eager[(name, mesh[0])]
    tag = f"{name}/{mesh[0]}x{mesh[1]}"
    for res in ranks[_world(mesh)]:
        for k, w in want.items():
            assert res[f"{tag}/{k}"].dtype == torch.bfloat16
            assert_close(w, to_np(res[f"{tag}/{k}"]), tol("bfloat16", False), f"{tag} {k}")
        assert all(res[f"{tag}/int32_equal"].values()), res[f"{tag}/int32_equal"]


@pytest.mark.parametrize("q", ["q", "f"])
def test_granite_seq_shard_kv_keeps_its_rows_split_at_rest(runs, q):
    """Granite's one KV head does not divide tp = 2: under
    ``seq_shard_kv`` each rank keeps half the rows of every K/V leaf at rest
    (``cache["seq_sharded"]`` names them), while the KV heads of the other
    configs shard by heads."""
    _, _, ranks = runs
    tag = f"granite-20b/seq{q}/1x2"
    cfg = jreduced(jget("granite-20b"))
    for res in ranks[2]:
        names = res[f"{tag}/seq_sharded"]
        want = ["k", "v"] + (["k_scale", "v_scale"] if q == "q" else [])
        assert names == sorted(f"00_attn/{n}" for n in want), names
        assert res[f"{tag}/rest/00_attn/k"] == (cfg.pattern_groups(), B, MAX_LEN // 2, 1, cfg.resolved_head_dim)
        plain = f"granite-20b/{q}/1x2"
        assert res[f"{plain}/seq_sharded"] == []
        assert res[f"{plain}/rest/00_attn/k"] == (cfg.pattern_groups(), B, MAX_LEN, 1, cfg.resolved_head_dim)
        heads = "qwen2-0.5b/q/1x2"  # two KV heads: one a rank
        assert res[f"{heads}/rest/00_attn/k"][2:4] == (MAX_LEN, 1)


@pytest.mark.parametrize("index", range(3))
def test_local_kv_heads_when_the_kv_heads_do_not_divide(index):
    """A rank whose query heads split and whose KV heads replicate attends
    with the KV heads its query heads need (``transformer._local_kv``): 12
    query and 4 KV heads at tp = 3 give rank 1 query heads 4-7, served by KV
    heads 1, 1, 2, 2 (contiguous), and ranks 0 and 2 three heads of one KV
    head and one of the next (one KV head a query head).  Its attention
    equals those query heads' of the unsharded attention."""
    from repro_torch.configs import get_config as tget
    from repro_torch.configs import reduced_config as treduced
    from repro_torch.dist.sharding import ModelShard
    from repro_torch.models import attention as tattn
    from repro_torch.models import transformer as tt

    cfg = dataclasses.replace(treduced(tget("qwen2-0.5b")), n_heads=12, n_kv_heads=4, dtype="float32")
    g = torch.Generator().manual_seed(index)
    q, k, v = (torch.randn((2, 8, h, 16), generator=g) for h in (12, 4, 4))
    kw = dict(causal=True, chunk=8, triangular=True, flash_threshold=64)
    want = tattn.full_attention(q, k, v, **kw)[:, :, 4 * index:4 * index + 4]
    kl, vl = tt._local_kv((k, v), cfg, ModelShard(3, index, None), 4)
    assert kl.shape[2] == (2 if index == 1 else 4)
    got = tattn.full_attention(q[:, :, 4 * index:4 * index + 4], kl, vl, **kw)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
