"""Shared helpers of the port's LLM tests (``tests/test_torch_lm*.py``,
``tests/test_torch_serve_engine.py``): the JAX package as the reference, its
weights carried into the port leaf by leaf, and the tolerances.

Tolerances, relative to the largest reference logit (``tol``):

* float32 without quantization: 1e-5.  The ops are the same, but a few
  (rsqrt, sin/cos, the float products' summation order) differ by an ulp or
  two between XLA and torch; observed differences stay below 1e-6.
* float32 with int8 activations (``quant_serve``) or an int8 KV cache
  (``quant_kv``): 2**-6.  An ulp of difference upstream can move one value
  across an int8 rounding boundary, which moves that row's products by one
  quantization step (observed up to 0.0046 at a largest logit of 0.97).
* bfloat16: 2**-4, 16 bfloat16 ulps (2**-8 relative).  XLA keeps the
  intermediates of a fused bfloat16 computation in float32 where torch rounds
  every op to bfloat16 (observed up to 0.026 at 0.96, two layers).  For the
  families of ``FAMILIES`` in bfloat16 the reference is the JAX package run
  op by op (``eager=True``: no ``jax.jit``, ``scan_layers=False``), which
  rounds as the port does: jitted, XLA's fusion alone moves xLSTM's logits
  by 0.18 of the largest (int8 activations: a changed rounding moves a
  value across a quantization boundary, and the chunk scan's normalization
  carries it on), while the port stays within 0.013 of the op-by-op run
  (observed; bit-equal with int8 weights).
* the MoE aux loss: 1e-5 relative (a float32 sum over the router's
  probabilities; routing equal); the cross-entropy within twice the
  logits' absolute tolerance (a logsumexp minus one logit).

Integer parts are never held to a tolerance: quantized weights, int8 KV
payloads of equal float inputs and the int32 scores are bit-exact.  Greedy
tokens must be equal wherever the reference's top-2 margin exceeds twice the
tolerance (:func:`assert_greedy_equal`).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced
from repro.models import common as jc
from repro.models import transformer as jt
from repro.models.runtime import RunFlags as JFlags
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced_config as treduced
from repro_torch.models import transformer as tt
from repro_torch.models.runtime import RunFlags as TFlags

# the five decoder-only archs with attention blocks and a dense FFN
ARCHS = ("qwen2-0.5b", "minicpm-2b", "granite-20b", "internlm2-20b", "phi-3-vision-4.2b")
# the other families: the RG-LRU hybrid, xLSTM, the two MoE, the encoder–decoder
FAMILIES = ("recurrentgemma-2b", "xlstm-1.3b", "dbrx-132b", "kimi-k2-1t-a32b", "whisper-medium")
# the small-S test flags of tests/test_arch_smoke.py
FLAG_KW = dict(attn_chunk=8, flash_threshold=64)


def tol(dtype: str, quant: bool) -> float:
    if dtype == "bfloat16":
        return 2.0 ** -4
    return 2.0 ** -6 if quant else 1e-5


def configs(arch: str, dtype: str):
    """(JAX config, port config): ``reduced_config`` of ``arch`` in ``dtype``."""
    return (dataclasses.replace(jreduced(jget_config(arch)), dtype=dtype),
            dataclasses.replace(treduced(tget_config(arch)), dtype=dtype))


def flags(**kw):
    """(JAX RunFlags, port RunFlags) with the same fields."""
    kw = {**FLAG_KW, **kw}
    return JFlags(**kw), TFlags(**kw)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def to_torch(tree):
    """A JAX tree (params, quantized params, cache) as the port's CPU tree."""
    return tt.params_from_numpy(np_tree(tree), device="cpu")


def to_np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def assert_close(ref, got, rel: float, what: str = "") -> float:
    """max |ref − got| ≤ rel · max |ref|; returns the absolute tolerance."""
    ref, got = f32(ref), f32(got)
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    assert np.isfinite(got).all(), what
    atol = rel * float(np.abs(ref).max())
    err = float(np.abs(ref - got).max())
    assert err <= atol, f"{what}: max |diff| {err} > {atol} (rel {rel})"
    return atol


def assert_greedy_equal(ref, got, atol: float) -> int:
    """The argmax over the last axis is equal wherever the reference's top-2
    margin exceeds ``2 · atol``; returns how many positions that held for."""
    ref, got = f32(ref).reshape(-1, f32(ref).shape[-1]), f32(got).reshape(-1, f32(got).shape[-1])
    top2 = np.sort(ref, axis=-1)[:, -2:]
    sure = (top2[:, 1] - top2[:, 0]) > 2 * atol
    assert (ref.argmax(-1)[sure] == got.argmax(-1)[sure]).all()
    return int(sure.sum())


@functools.lru_cache(maxsize=None)
def jax_steps(cfg, fl, max_len, eager=False):
    """JAX forward (logits, aux), loss parts, prefill and decode step for
    (config, flags): jitted, or (``eager``) run op by op."""
    steps = (lambda p, b: jt.forward(p, cfg, b, fl),
             lambda p, b: jt.loss_fn(p, cfg, b, fl)[1],
             lambda p, b: jt.prefill(p, cfg, b, fl, max_len=max_len),
             lambda p, c, t: jt.decode_step(p, cfg, c, t, fl))
    return steps if eager else tuple(jax.jit(f) for f in steps)


def batch_pair(cfg, b: int, s: int, seed: int):
    """(JAX batch, port batch): random tokens and labels, plus patch
    embeddings for a vision config and frame embeddings for an
    encoder–decoder one."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, cfg.vocab_size, (b, s)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    for name, on, rows in (("patch_embeds", cfg.frontend == "vision", cfg.n_patches),
                           ("enc_embeds", cfg.is_encdec, cfg.enc_seq_len)):
        if on:
            e = jnp.asarray(rng.standard_normal((b, rows, cfg.d_model)).astype(np.float32), cfg.dtype)
            jb[name] = e
            tb[name] = to_torch(e)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    jb["labels"], tb["labels"] = jnp.asarray(labels), torch.from_numpy(labels)
    return jb, tb


def run_slice(arch, dtype, quant_serve, quant_kv, b=2, s=12, max_len=16, steps=3, seed=1, eager=False):
    """forward, the loss, prefill and ``steps`` decode steps of ``arch`` at
    ``reduced_config`` in both packages on JAX's weights, each decode step
    fed JAX's greedy tokens; asserts every output within the tolerance
    (against JAX run op by op if ``eager``) and returns how many greedy
    positions were held."""
    jcfg, tcfg = configs(arch, dtype)
    jfl, tfl = flags(quant_serve=quant_serve, quant_kv=quant_kv, **({"scan_layers": False} if eager else {}))
    rel = tol(dtype, quant_serve or quant_kv)
    params = jt.init_params(jax.random.key(0), jcfg)
    if quant_serve:
        params = jc.maybe_quantize_tree(params, jcfg)
    tp = to_torch(params)
    jb, tb = batch_pair(jcfg, b, s, seed)
    jfwd, jloss, jpre, jdec = jax_steps(jcfg, jfl, max_len, eager)
    held = 0
    want, want_aux = jfwd(params, jb)
    got, aux = tt.forward(tp, tcfg, tb, tfl)
    assert got.dtype == tt.dtype_of(tcfg) and aux.dtype == torch.float32 and aux.shape == ()
    atol = assert_close(want, to_np(got), rel, "forward")
    held += assert_greedy_equal(want, to_np(got), atol)
    if jcfg.is_moe:
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
        assert float(aux) > 0
    else:
        assert float(aux) == float(want_aux) == 0.0
    loss, parts = tt.loss_fn(tp, tcfg, tb, tfl)
    want_parts = jloss(params, jb)
    assert abs(float(parts["ce"]) - float(want_parts["ce"])) <= 2 * atol, (parts, want_parts)
    assert float(parts["aux"]) == float(aux) and float(loss) == float(parts["ce"] + 0.01 * parts["aux"])
    jcache, want = jpre(params, jb)
    tcache, got = tt.prefill(tp, tcfg, tb, tfl, max_len=max_len)
    held += assert_greedy_equal(want, to_np(got), assert_close(want, to_np(got), rel, "prefill"))
    assert int(tcache["pos"]) == int(jcache["pos"]) == s
    jflat = jax.tree_util.tree_flatten_with_path(np_tree(jcache["blocks"]))[0]
    assert sorted(".".join(k.key for k in p) for p, _ in jflat) == \
        sorted(f"{blk}.{n}" for blk, e in tcache["blocks"].items() for n in e)
    for path, leaf in jflat:
        mine = tcache["blocks"][path[0].key][path[1].key]
        assert tuple(mine.shape) == leaf.shape and str(mine.dtype).endswith(str(leaf.dtype)), path
        if leaf.dtype == np.int8 and dtype == "float32":
            # int8 payloads of float32 K/V that agree to an ulp: at most a
            # rounding-boundary step apart (equal inputs: test_quantize_kv_bit_exact)
            assert np.abs(mine.numpy().astype(np.int32) - leaf.astype(np.int32)).max() <= 1, path
    tok = np.array(jnp.argmax(want, -1), np.int32)[:, None]
    for step in range(steps):
        before = tt._tree_map(torch.clone, tcache["blocks"])
        jcache, want = jdec(params, jcache, jnp.asarray(tok))
        tnew, got = tt.decode_step(tp, tcfg, tcache, torch.from_numpy(tok), tfl)
        assert all(torch.equal(a, b) for a, b in zip(tt._tree_leaves(before), tt._tree_leaves(tcache["blocks"])))
        tcache = tnew
        atol = assert_close(want, to_np(got), rel, f"decode step {step}")
        held += assert_greedy_equal(want, to_np(got), atol)
        assert int(tcache["pos"]) == int(jcache["pos"]) == s + step + 1
        tok = np.array(jnp.argmax(want, -1), np.int32)[:, None]
    return held
