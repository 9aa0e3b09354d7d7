"""The port's decoder-only LLM (``repro_torch.configs``, ``models.common``,
``models.attention``, ``models.transformer``) against the JAX package.

Each module's function runs on the same numpy-seeded inputs in both packages
(the port on CPU tensors, its kernels' plain versions); the whole slice runs
Qwen2-0.5B at ``reduced_config`` on weights carried from JAX's
``init_params`` under every serving flag, in float32 and bfloat16.  The
tolerances and their reasons are in ``tests/_torch_lm_ref.py``; integer
parts are bit-exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_archs as jlist_archs  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.kernels.api import PrecisionSpec as JSpec  # noqa: E402
from repro.models import attention as ja  # noqa: E402
from repro.models import common as jc  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import api as tapi  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402
from repro_torch.models import common as tc  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

from _torch_lm_ref import assert_close, configs, f32, flags, np_tree, run_slice, to_np, to_torch  # noqa: E402


def _normal(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _pair(a, dtype="float32"):
    """(JAX array, port tensor) of numpy ``a`` in ``dtype``."""
    j = jnp.asarray(a, dtype)
    return j, to_torch(j)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_list_archs_equals_jax():
    assert tconfigs.list_archs() == jlist_archs()


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", jlist_archs())
def test_config_equals_jax_field_by_field(arch, reduced):
    jcfg, tcfg = jget_config(arch), tconfigs.get_config(arch)
    if reduced:
        jcfg, tcfg = jreduced(jcfg), tconfigs.reduced_config(tcfg)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert repr(tcfg) == repr(jcfg)  # the serve steps' cache keys
    assert (tcfg.param_count(), tcfg.padded_vocab(), tcfg.layer_kinds()) == \
        (jcfg.param_count(), jcfg.padded_vocab(), jcfg.layer_kinds())


def test_unknown_arch_raises_as_jax():
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("gpt-5")


# ---------------------------------------------------------------------------
# models/common.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_equals_jax(dtype):
    jx, tx = _pair(_normal((3, 5, 64), 0) * 3, dtype)
    js, ts = _pair(_normal((64,), 1), dtype)
    want = jc.rmsnorm({"scale": js}, jx, 1e-5)
    got = tc.rmsnorm({"scale": ts}, tx, 1e-5)
    assert got.dtype == tx.dtype
    # one rounding of float32 (rsqrt may differ by an ulp), or of bfloat16
    assert_close(want, to_np(got), 2e-6 if dtype == "float32" else 2.0 ** -8, "rmsnorm")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_equals_jax(dtype, theta):
    jx, tx = _pair(_normal((2, 7, 3, 16), 2), dtype)
    pos = np.arange(100, 107)[None]
    want = jc.apply_rope(jx, jnp.asarray(pos), theta)
    got = tc.apply_rope(tx, torch.from_numpy(pos), theta)
    # positions up to ~100 rad: sin/cos of float32 angles agree to a few ulps
    assert_close(want, to_np(got), 1e-5 if dtype == "float32" else 2.0 ** -8, "rope")
    np.testing.assert_allclose(to_np(tc.rope_freqs(16, theta)), f32(jc.rope_freqs(16, theta)), rtol=2e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_equals_jax(dtype):
    jg, tg = _pair(_normal((4, 32), 3) * 4, dtype)
    ju, tu = _pair(_normal((4, 32), 4), dtype)
    assert_close(jc.swiglu(jg, ju), to_np(tc.swiglu(tg, tu)),
                 1e-6 if dtype == "float32" else 2.0 ** -8, "swiglu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-20b", "phi-3-vision-4.2b"])
def test_maybe_quantize_tree_bit_exact(arch, dtype):
    jcfg, tcfg = configs(arch, dtype)
    params = jt.init_params(jax.random.key(0), jcfg)
    want = np_tree(jc.maybe_quantize_tree(params, jcfg))
    got = tc.maybe_quantize_tree(to_torch(params), tcfg)
    flat_w, _ = jax.tree_util.tree_flatten_with_path(want)
    n_q = 0
    for path, leaf in flat_w:
        node = got
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape, path
        if str(leaf.dtype) == "bfloat16":
            assert node.dtype == torch.bfloat16
            assert np.array_equal(node.view(torch.int16).numpy(), leaf.view(np.int16)), path
        else:
            assert np.array_equal(node.numpy(), leaf), path
        n_q += leaf.dtype == np.int8
    # every linear of every block quantized (wq wk wv wo + 3 FFN), plus the head / adapter
    assert n_q == 7 + (not jcfg.tie_embeddings) + (jcfg.frontend == "vision")


def test_maybe_quantize_tree_leaves_unquantized_config_alone():
    _, tcfg = configs("qwen2-0.5b", "float32")
    tcfg = dataclasses.replace(tcfg, quant=dataclasses.replace(tcfg.quant, enabled=False))
    p = tt.init_params(tcfg, 0, device="cpu")
    assert tc.maybe_quantize_tree(p, tcfg) is p


# ---------------------------------------------------------------------------
# models/attention.py
# ---------------------------------------------------------------------------


def _qkv(b, s, t, hq, hkv, d, seed, dtype="float32"):
    q = _pair(_normal((b, s, hq, d), seed), dtype)
    k = _pair(_normal((b, t, hkv, d), seed + 1), dtype)
    v = _pair(_normal((b, t, hkv, d), seed + 2), dtype)
    return q, k, v


ATT_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_direct_attention_equals_jax(causal, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, 6, 9, 4, 2, 8, 10, dtype)
    jmask = (jnp.arange(6)[:, None] + 3) >= jnp.arange(9)[None, :] if causal else None
    tmask = torch.from_numpy(np.array(jmask)) if causal else None
    want = ja._direct_attention(ja._gqa_fold(jq, 2), jk, jv, jmask)
    got = ta._direct_attention(ta._gqa_fold(tq, 2), tk, tv, tmask)
    assert_close(want, to_np(got), ATT_TOL[dtype], "direct")


@pytest.mark.parametrize("causal,triangular,window,s,t", [
    (True, True, 0, 16, 16), (True, False, 0, 16, 16), (True, True, 5, 16, 16), (True, False, 5, 16, 16),
    (False, False, 0, 8, 16), (False, False, 0, 8, 13)])
def test_chunked_attention_equals_jax(causal, triangular, window, s, t):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, s, t, 4, 2, 8, 20)
    kw = dict(causal=causal, chunk=4, triangular=triangular, window=window)  # chunk < S
    want = ja.chunked_attention(ja._gqa_fold(jq, 2), jk, jv, **kw)
    got = ta.chunked_attention(ta._gqa_fold(tq, 2), tk, tv, **kw)
    assert_close(want, to_np(got), 1e-5, "chunked")


@pytest.mark.parametrize("s,window", [(12, 4), (10, 4), (3, 8)])
def test_local_attention_equals_jax(s, window):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, s, s, 4, 2, 8, 30)
    assert_close(ja.local_attention(jq, jk, jv, window), to_np(ta.local_attention(tq, tk, tv, window)),
                 1e-5, "local")


@pytest.mark.parametrize("s,flash_threshold", [(8, 64), (16, 8)], ids=["direct", "chunked"])
def test_full_attention_equals_jax(s, flash_threshold):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, s, s, 4, 2, 8, 40)
    kw = dict(causal=True, chunk=4, triangular=True, flash_threshold=flash_threshold)
    assert_close(ja.full_attention(jq, jk, jv, **kw), to_np(ta.full_attention(tq, tk, tv, **kw)), 1e-5, "full")


@pytest.mark.parametrize("spec", ["int8", "int4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_exact(dtype, spec):
    jx, tx = _pair(_normal((2, 7, 3, 16), 50) * 5, dtype)
    wq, ws = ja.quantize_kv(jx, getattr(JSpec, spec))
    gq, gs = ta.quantize_kv(tx, getattr(tapi.PrecisionSpec, spec))
    assert gq.dtype == torch.int8 and gs.dtype == torch.float32
    assert np.array_equal(gq.numpy(), np.asarray(wq))
    assert np.array_equal(gs.numpy(), np.asarray(ws))


def test_kv_qmax_refuses_wide_specs():
    with pytest.raises(ValueError, match="at most 8-bit"):
        ta._kv_qmax(tapi.PrecisionSpec.int16)


def _int8_cache(b, t, hkv, d, seed):
    k = _normal((b, t, hkv, d), seed)
    v = _normal((b, t, hkv, d), seed + 1)
    (kq, ks), (vq, vs) = ja.quantize_kv(jnp.asarray(k)), ja.quantize_kv(jnp.asarray(v))
    return [np.array(a) for a in (kq, vq, ks, vs)]


@pytest.mark.parametrize("b,hq,hkv", [(2, 4, 2), (3, 14, 2), (1, 4, 4)])
def test_int8_scores_bit_exact(b, hq, hkv):
    d, t = 16, 11
    kq = _int8_cache(b, t, hkv, d, 60)[0]
    qq = np.random.default_rng(61).integers(-127, 128, (b, hkv, hq // hkv, d)).astype(np.int8)
    want = jnp.einsum("bhgd,bthd->bhgt", jnp.asarray(qq), jnp.asarray(kq), preferred_element_type=jnp.int32)
    tapi.reset_launch_counts()
    got = ta.int8_scores(torch.from_numpy(qq), torch.from_numpy(kq))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(want))
    assert tapi.launch_counts() == {}  # CPU operands: the plain version, no launch


@pytest.mark.parametrize("cap,rows", [(1, 1), (4 * 1232, 2), (1 << 24, 5)],
                         ids=["row-a-call", "two-rows-a-call", "one-call"])
def test_int8_scores_row_groups_bit_exact(monkeypatch, cap, rows):
    """Each grouping of batch rows into row-dot calls gives JAX's scores
    exactly: a call over R rows writes R²·Hkv²·G·T·4 bytes (1232 a row
    here), the cap sets R, and 5 rows in calls of 2 leave a last call of 1."""
    b, hkv, g, d, t = 5, 2, 7, 16, 11
    monkeypatch.setattr(ta, "INT8_SCORES_CALL_BYTES", cap)
    assert ta.int8_scores_rows_per_call(b, hkv, g, t) == rows
    kq = _int8_cache(b, t, hkv, d, 62)[0]
    qq = np.random.default_rng(63).integers(-127, 128, (b, hkv, g, d)).astype(np.int8)
    want = jnp.einsum("bhgd,bthd->bhgt", jnp.asarray(qq), jnp.asarray(kq), preferred_element_type=jnp.int32)
    got = ta.int8_scores(torch.from_numpy(qq), torch.from_numpy(kq))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(want))


def test_int8_scores_rows_per_call_spreads_evenly():
    """Qwen2-0.5B's heads: one call up to the cap, then the fewest calls,
    their rows balanced, never above the cap unless one row already is."""
    for b in (1, 3, 4, 16, 33, 64, 257):
        for t in (1, 128, 1024, 4096, 32768):
            rows = ta.int8_scores_rows_per_call(b, 2, 7, t)
            calls = -(-b // rows)
            assert 1 <= rows <= b and (rows == 1 or rows * rows * 4 * 7 * t * 4 <= ta.INT8_SCORES_CALL_BYTES)
            assert calls == 1 or -(-b // (calls - 1)) * -(-b // (calls - 1)) * 4 * 7 * t * 4 > ta.INT8_SCORES_CALL_BYTES
    assert ta.int8_scores_rows_per_call(4, 2, 7, 128) == 4


@pytest.mark.parametrize("valid", [None, [11, 5]], ids=["all", "masked"])
def test_decode_attention_int8_equals_jax(valid):
    b, t, hq, hkv, d = 2, 11, 4, 2, 16
    kq, vq, ks, vs = _int8_cache(b, t, hkv, d, 70)
    jq, tq = _pair(_normal((b, 1, hq, d), 71))
    jvl = None if valid is None else jnp.asarray(valid, jnp.int32)
    tvl = None if valid is None else torch.tensor(valid, dtype=torch.int32)
    want = ja.decode_attention_int8(jq, *map(jnp.asarray, (kq, vq, ks, vs)), jvl)
    got = ta.decode_attention_int8(tq, *map(torch.from_numpy, (kq, vq, ks, vs)), tvl)
    assert_close(want, to_np(got), 1e-5, "decode int8")


def test_decode_attention_int8_query_quantization_bit_exact():
    """The query's int8 payload and scale (``attention.py:233–256``) equal JAX's."""
    qf = _normal((2, 2, 7, 64), 72) * 3
    qmax = 127
    qs = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(qf)), axis=-1) / qmax, 1e-8)
    qq = jnp.clip(jnp.round(jnp.asarray(qf) / qs[..., None]), -qmax, qmax).astype(jnp.int8)
    gq, gs = ta._quantize_rows(torch.from_numpy(qf), qmax)
    assert np.array_equal(gq.numpy(), np.asarray(qq)) and np.array_equal(gs.numpy(), np.asarray(qs))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("valid", [None, [9, 4]], ids=["all", "masked"])
def test_decode_attention_equals_jax(valid, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, 1, 9, 4, 2, 8, 80, dtype)
    jvl = None if valid is None else jnp.asarray(valid, jnp.int32)
    tvl = None if valid is None else torch.tensor(valid, dtype=torch.int32)
    assert_close(ja.decode_attention(jq, jk, jv, jvl), to_np(ta.decode_attention(tq, tk, tv, tvl)),
                 ATT_TOL[dtype], "decode")


# ---------------------------------------------------------------------------
# the slice: Qwen2-0.5B under every serving flag
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant_kv", [False, True], ids=["bf16kv", "int8kv"])
@pytest.mark.parametrize("quant_serve", [False, True], ids=["float", "int8w"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qwen2_slice_equals_jax(dtype, quant_serve, quant_kv):
    held = run_slice("qwen2-0.5b", dtype, quant_serve, quant_kv)
    if dtype == "float32" and not (quant_serve or quant_kv):
        assert held >= 2 * (12 + 1 + 3)  # nearly every position is held at 1e-5


# ---------------------------------------------------------------------------
# refusals and entry points
# ---------------------------------------------------------------------------


def test_rules_raise_naming_s13():
    """Tensor-parallel rules run on a process mesh (ROADMAP S13b,
    ``tests/test_torch_tp_serve.py``); a model axis wider than one on a mesh
    with no ranks describes a layout and raises ValueError naming
    ``make_host_mesh``, and rules that are no MeshRules TypeError."""
    from repro_torch.dist.sharding import MeshRules
    from repro_torch.launch.mesh import MeshDescription

    _, tcfg = configs("qwen2-0.5b", "float32")
    p = tt.init_params(tcfg, 0, device="cpu")
    batch = {"tokens": torch.ones((1, 8), dtype=torch.int32)}
    tp = MeshRules.from_mesh(MeshDescription((1, 2), ("data", "model")))
    for rules, err, match in ((tp, ValueError, "make_host_mesh"), (object(), TypeError, "MeshRules")):
        for call in (lambda: tt.forward(p, tcfg, batch, rules=rules),
                     lambda: tt.prefill(p, tcfg, batch, rules=rules),
                     lambda: tt.decode_step(p, tcfg, tt.init_cache(tcfg, 1, 8, device="cpu"),
                                            batch["tokens"][:, :1], rules=rules)):
            with pytest.raises(err, match=match):
                call()


def test_params_and_cache_shapes_on_meta_equal_jax():
    jcfg, tcfg = configs("qwen2-0.5b", "bfloat16")
    jshape = jax.tree_util.tree_flatten_with_path(jt.params_shape(jcfg))[0]
    mine = tt.params_shape(tcfg)
    for path, leaf in jshape:
        node = mine
        for k in path:
            node = node[k.key]
        assert node.device.type == "meta" and tuple(node.shape) == leaf.shape and node.dtype == torch.bfloat16
    assert tt.param_bytes(mine) == jt.param_bytes(jt.params_shape(jcfg))
    jfl, tfl = flags(quant_kv=True)
    jc_shape = jax.tree_util.tree_flatten_with_path(jt.cache_shape(jcfg, 2, 16, jfl))[0]
    tc_shape = tt.cache_shape(tcfg, 2, 16, tfl)
    for path, leaf in jc_shape:
        node = tc_shape
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape and str(node.dtype).endswith(str(leaf.dtype)), path


def test_init_params_is_seeded_and_shaped_like_jax():
    jcfg, tcfg = configs("granite-20b", "float32")
    a, b = tt.init_params(tcfg, 3, device="cpu"), tt.init_params(tcfg, 3, device="cpu")
    assert torch.equal(a["blocks"]["00_attn"]["attn"]["wq"]["w"], b["blocks"]["00_attn"]["attn"]["wq"]["w"])
    assert not torch.equal(a["embed"]["w"], tt.init_params(tcfg, 4, device="cpu")["embed"]["w"])
    for path, leaf in jax.tree_util.tree_flatten_with_path(jt.params_shape(jcfg))[0]:
        node = a
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape, path


def test_scan_layers_changes_nothing():
    """JAX's lax.scan over groups is a Python loop in the port: the flag that
    unrolls JAX's scan leaves the port's outputs bit-equal, and JAX's
    unrolled forward agrees with the port as its scanned one does."""
    jcfg, tcfg = configs("qwen2-0.5b", "float32")
    params = jt.init_params(jax.random.key(0), jcfg)
    tp = to_torch(params)
    toks = np.random.default_rng(4).integers(2, 256, (2, 8)).astype(np.int32)
    outs = []
    for scan in (True, False):
        jfl, tfl = flags(scan_layers=scan)
        want, _ = jt.forward(params, jcfg, {"tokens": jnp.asarray(toks)}, jfl)
        got, _ = tt.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)}, tfl)
        assert_close(want, to_np(got), 1e-5, f"scan_layers={scan}")
        outs.append(got)
    assert torch.equal(outs[0], outs[1])
