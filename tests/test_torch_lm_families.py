"""The port's model layer on the families beyond decoder-only attention,
against the JAX package: the RG-LRU hybrid (RecurrentGemma-2B), xLSTM-1.3B,
the two mixtures of experts (DBRX-132B, Kimi-K2) and the encoder–decoder
(Whisper-medium), each at ``reduced_config`` on weights carried from JAX's
``init_params``: ``forward``, ``loss_fn``, ``prefill`` and ``decode_step``,
the serving form of the weights, the cache layouts, the engine and the
launcher.  Tolerances and the reference (jitted, or op by op for bfloat16):
``tests/_torch_lm_ref.py``.

Tier-1 holds each family with every serving flag on and with every flag
off, in float32 and bfloat16; the mixed flag settings are the slow tier.
"""
import contextlib
import dataclasses
import io
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import common as jc  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tserve_cli  # noqa: E402
from repro_torch.models import common as tc  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

from _torch_lm_ref import (FAMILIES, configs, f32, flags, np_tree, run_slice,  # noqa: E402
                           to_np, to_torch, tol)


def _grid():
    for arch, dtype, qs, qk in itertools.product(FAMILIES, ("float32", "bfloat16"), (False, True), (False, True)):
        marks = () if qs == qk else (pytest.mark.slow,)
        yield pytest.param(arch, dtype, qs, qk, marks=marks,
                           id=f"{arch}-{dtype}-{'int8w' if qs else 'float'}-{'int8kv' if qk else 'bf16kv'}")


@pytest.mark.parametrize("arch,dtype,quant_serve,quant_kv", list(_grid()))
def test_family_slice_equals_jax(arch, dtype, quant_serve, quant_kv):
    """forward (logits and aux), loss_fn (ce, aux), prefill (logits and the
    cache's layout and dtypes) and 3 decode steps at S = 12, past the
    RG-LRU hybrid's 8-token window with 12 % 8 != 0 (the ring's eviction)."""
    held = run_slice(arch, dtype, quant_serve, quant_kv, eager=dtype == "bfloat16")
    if dtype == "float32" and not (quant_serve or quant_kv):
        assert held >= 2 * (12 + 1 + 3) - 2  # nearly every position is held at 1e-5


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-1.3b", "whisper-medium"])
def test_prefill_decode_consistency(arch, dtype):
    """A decode step after prefill(7) gives the last logits of prefill(8),
    in the port, on parameters carried from JAX's init_params(key 1): the
    recurrent states and the conv tail carry over, and 8 tokens stay within
    the local window, where prefill's mask (w + 1 keys) and decode's ring (w
    rows) agree.  bfloat16 at the JAX test's tolerance; float32 within 1e-5
    of the largest logit.  The MoE families are left out: a prefill routes
    its tokens with a capacity that a one-token step does not have."""
    jcfg, tcfg = configs(arch, dtype)
    _, tfl = flags()
    params = to_torch(jt.init_params(jax.random.key(1), jcfg))
    toks = torch.from_numpy(np.array(jax.random.randint(jax.random.key(2), (1, 8), 2, jcfg.vocab_size)))
    full = {"tokens": toks}
    if tcfg.is_encdec:
        full["enc_embeds"] = torch.ones((1, tcfg.enc_seq_len, tcfg.d_model), dtype=tt.dtype_of(tcfg))
    _, logits_full = tt.prefill(params, tcfg, full, tfl, max_len=12)
    cache_s, _ = tt.prefill(params, tcfg, dict(full, tokens=toks[:, :7]), tfl, max_len=12)
    _, logits_step = tt.decode_step(params, tcfg, cache_s, toks[:, 7:8], tfl)
    if dtype == "bfloat16":
        np.testing.assert_allclose(to_np(logits_full), to_np(logits_step), atol=0.55, rtol=0.2)
    else:
        ref = to_np(logits_full)
        np.testing.assert_allclose(to_np(logits_step), ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def _first_local_k(cache):
    """Group 0's local-attention K rows of batch row 0, head 0: (w, hd)."""
    return f32(cache["blocks"]["01_local_attn"]["k"])[0, 0, :, 0]


def test_local_attn_ring_beyond_the_window_evicts_as_jax():
    """A property of the JAX package the port keeps: a prefill of s > w
    tokens lays the last w out from slot 0, and decode writes slot pos % w,
    so with s % w != 0 the first step evicts a token that is not the oldest.
    Window 8, prompt 11: slots hold tokens 3..10, the step at pos 11 lands
    in slot 3, evicting token 6; token 3 stays.  Tokens are named by their K
    rows from a prefill that keeps all 12 (window 16)."""
    jcfg, tcfg = configs("recurrentgemma-2b", "float32")
    jfl, tfl = flags()
    params = jt.init_params(jax.random.key(0), jcfg)
    tp = to_torch(params)
    toks = np.random.default_rng(6).integers(2, 256, (1, 12)).astype(np.int32)
    # the first local-attention layer's K rows do not depend on the window
    wide = dataclasses.replace(tcfg, window=16)
    all_k = f32(to_np(tt.prefill(tp, wide, {"tokens": torch.from_numpy(toks)}, tfl, max_len=16)[0]
                      ["blocks"]["01_local_attn"]["k"]))[0, 0, :12, 0]
    jcache, _ = jt.prefill(params, jcfg, {"tokens": jnp.asarray(toks[:, :11])}, jfl, max_len=16)
    tcache, _ = tt.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks[:, :11])}, tfl, max_len=16)
    jcache, _ = jt.decode_step(params, jcfg, jcache, jnp.asarray(toks[:, 11:]), jfl)
    tcache, _ = tt.decode_step(tp, tcfg, tcache, torch.from_numpy(toks[:, 11:]), tfl)
    got, want = _first_local_k(tcache), _first_local_k(jcache)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    def token_of(row):
        d = np.abs(all_k - row).max(axis=1)
        return int(d.argmin())

    assert [token_of(r) for r in got] == [3, 4, 5, 11, 7, 8, 9, 10]


def _meta_equal(want_tree, got_tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(want_tree)[0]:
        node = got_tree
        for k in path:
            node = node[k.key]
        assert node.device.type == "meta" and tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).endswith(str(leaf.dtype)), path
    assert len(jax.tree_util.tree_leaves(want_tree)) == len(tt._tree_leaves(got_tree))


@pytest.mark.parametrize("quant_kv", [False, True], ids=["bf16kv", "int8kv"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_params_and_cache_shapes_on_meta_equal_jax(arch, quant_kv):
    """Parameter and cache trees on the meta device: JAX's keys, shapes and
    dtypes (the float cross_k/cross_v beside an int8 cache, the recurrent
    states, a local-attention entry of min(window, max_len) rows)."""
    jcfg, tcfg = configs(arch, "bfloat16")
    mine = tt.params_shape(tcfg)
    _meta_equal(jt.params_shape(jcfg), mine)
    assert tt.param_bytes(mine) == jt.param_bytes(jt.params_shape(jcfg))
    jfl, tfl = flags(quant_kv=quant_kv)
    _meta_equal(jt.cache_shape(jcfg, 2, 16, jfl)["blocks"], tt.cache_shape(tcfg, 2, 16, tfl)["blocks"])


# quantized leaves of reduced_config's tree: RG-LRU 5 + FFN 3, local attention
# 4 + FFN 3; mLSTM 6, sLSTM 3, the head; MoE attention 4 (the experts and the
# router stay float), the head; the decoder's 4 + cross 4 + FFN 3, an encoder
# block's 7, the audio adapter and the head
QUANTIZED_LEAVES = {"recurrentgemma-2b": 15, "xlstm-1.3b": 10, "dbrx-132b": 5, "kimi-k2-1t-a32b": 5,
                    "whisper-medium": 20}


@pytest.mark.parametrize("arch", FAMILIES)
def test_maybe_quantize_tree_bit_exact(arch):
    jcfg, tcfg = configs(arch, "bfloat16")
    params = jt.init_params(jax.random.key(0), jcfg)
    want = np_tree(jc.maybe_quantize_tree(params, jcfg))
    got = tc.maybe_quantize_tree(to_torch(params), tcfg)
    n_q = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape, path
        if str(leaf.dtype) == "bfloat16":
            assert np.array_equal(node.view(torch.int16).numpy(), leaf.view(np.int16)), path
        else:
            assert np.array_equal(node.numpy(), leaf), path
        n_q += leaf.dtype == np.int8
    assert n_q == QUANTIZED_LEAVES[arch]


@pytest.mark.parametrize("arch", FAMILIES)
def test_rules_raise_naming_s13(arch):
    """check_supported runs every family without rules and under
    data-parallel MeshRules (ROADMAP S13); tensor-parallel rules run on a
    process mesh (ROADMAP S13b), while a model axis wider than one on a mesh
    with no ranks raises ValueError naming ``make_host_mesh``; rules that
    are no MeshRules raise TypeError."""
    from repro_torch.dist.sharding import MeshRules
    from repro_torch.launch.mesh import MeshDescription

    _, tcfg = configs(arch, "float32")
    tt.check_supported(tcfg)
    tt.check_supported(tcfg, rules=MeshRules.from_mesh(MeshDescription((8, 1), ("data", "model"))))
    with pytest.raises(ValueError, match=f"{arch}.*make_host_mesh"):
        tt.check_supported(tcfg, rules=MeshRules.from_mesh(MeshDescription((2, 4), ("data", "model"))))
    with pytest.raises(TypeError, match=f"{arch}.*MeshRules"):
        tt.check_supported(tcfg, rules=object())


def test_init_params_is_seeded_and_has_every_family_branch():
    """The port's own draws: seeded, and the enc–dec, MoE and recurrent
    subtrees present (the untied head, the encoder, the audio adapter)."""
    _, tcfg = configs("whisper-medium", "float32")
    a, b = tt.init_params(tcfg, 3, device="cpu"), tt.init_params(tcfg, 3, device="cpu")
    assert torch.equal(a["enc_blocks"]["00_attn"]["attn"]["wq"]["w"], b["enc_blocks"]["00_attn"]["attn"]["wq"]["w"])
    assert {"lm_head", "enc_blocks", "enc_norm", "audio_adapter"} <= set(a)
    assert {"lnx", "cross"} <= set(a["blocks"]["00_attn"]) and "cross" not in a["enc_blocks"]["00_attn"]
    _, dcfg = configs("dbrx-132b", "float32")
    ffn = tt.init_params(dcfg, 0, device="cpu")["blocks"]["00_attn"]["ffn"]
    assert ffn["w_gate"].shape == (2, dcfg.n_experts, dcfg.d_model, dcfg.d_ff) and ffn["router"]["w"].dtype == torch.float32
    _, xcfg = configs("xlstm-1.3b", "float32")
    blocks = tt.init_params(xcfg, 0, device="cpu")["blocks"]
    assert set(blocks) == {"00_mlstm", "01_slstm"} and "ffn" not in blocks["00_mlstm"]


# ---------------------------------------------------------------------------
# the engine and the launcher
# ---------------------------------------------------------------------------

ENGINE_PROMPTS = ((3, 5), (8, 6), (11, 4), (12, 6))


def _requests(mod, cfg, seed=5):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, prompt=rng.integers(2, cfg.vocab_size, size=n).astype(np.int32), max_new_tokens=m)
            for i, (n, m) in enumerate(ENGINE_PROMPTS)]


@pytest.mark.parametrize("quant_serve", [False, True], ids=["float", "int8w"])
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "whisper-medium"])
def test_engine_streams_equal_jax(arch, quant_serve):
    """Both engines in float32 on JAX's weights over prompts of 3–12 tokens
    (past the 8-token window, and past max_len 16): equal token streams, up
    to the first step where the JAX engine's top-2 margin is within twice
    the tolerance (a near-tie either package may break either way)."""
    jcfg, tcfg = configs(arch, "float32")
    jfl, tfl = flags(quant_serve=quant_serve)
    params = jt.init_params(jax.random.key(0), jcfg)
    je = jengine.ServeEngine(jcfg, params, jfl, max_len=16)
    log = []

    def recording(step):
        def call(*args):
            cache, logits = step(*args)
            log.append(f32(logits))
            return cache, logits
        return call

    je._prefill, je._decode = recording(je._prefill), recording(je._decode)
    want = [r.generated for r in je.run(_requests(jengine, jcfg))]
    te = tengine.ServeEngine(tcfg, to_torch(params), tfl, max_len=16)
    got = [r.generated for r in te.run(_requests(tengine, tcfg))]
    rel = tol("float32", quant_serve)
    assert [len(w) for w in want] == [m for _, m in ENGINE_PROMPTS]
    compared = 0
    for lane, (w, g) in enumerate(zip(want, got)):
        for k, (a, b) in enumerate(zip(w, g)):
            if a != b:
                top2 = np.sort(log[k][lane])[-2:]
                assert top2[1] - top2[0] <= 2 * rel * np.abs(log[k]).max(), (lane, k, w, g)
                break
            compared += 1
        else:
            assert len(w) == len(g), (lane, w, g)
    if not quant_serve:
        assert compared == sum(m for _, m in ENGINE_PROMPTS)


def test_engine_prompt_batch_carries_zero_frames_for_encdec():
    _, tcfg = configs("whisper-medium", "float32")
    e = tengine.ServeEngine(tcfg, tt.init_params(tcfg, 0, device="cpu"), flags()[1], max_len=16)
    batch = e.prompt_batch(_requests(tengine, tcfg))
    assert batch["enc_embeds"].shape == (4, tcfg.enc_seq_len, tcfg.d_model)
    assert batch["enc_embeds"].dtype == torch.float32 and not batch["enc_embeds"].any()


@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_launcher_serves_every_arch(arch):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserve_cli.main(["--arch", arch, "--reduced", "--new-tokens", "3", "--device", "cpu"])
    assert out.getvalue().startswith("served 4 requests, 12 tokens in ")


def test_launcher_flags_equal_jax_but_for_encdec_frames():
    """The JAX launcher's flags, but an encoder–decoder config's frames take
    the direct attention: at full size whisper-medium's 1500 frames are no
    multiple of the 64-token chunk, where JAX's chunked attention asserts."""
    full = tconfigs.get_config("whisper-medium")
    assert tserve_cli.serve_flags(True, full).flash_threshold == 1500
    for arch in tconfigs.list_archs():
        cfg = tconfigs.reduced_config(tconfigs.get_config(arch))
        assert tserve_cli.serve_flags(True, cfg) == tserve_cli.RunFlags(attn_chunk=64, flash_threshold=256)
    from repro_torch.models import attention as ta

    q = torch.zeros((1, 1500, 2, 8))
    with pytest.raises(ValueError, match="not a multiple of the chunk 64"):
        ta.full_attention(q, q, q, causal=False, chunk=64, triangular=False, flash_threshold=256)
