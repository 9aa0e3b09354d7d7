"""The port's decoder-only LLM on every arch it covers, against the JAX
package: MiniCPM-2B, Granite-20B, InternLM2-20B and Phi-3-Vision-4.2B (its
vision stub fed patch embeddings) at ``reduced_config``, on weights carried
from JAX's ``init_params`` (Qwen2-0.5B's grid is in ``test_torch_lm.py``),
and the port's counterpart of ``tests/test_arch_smoke.py``'s
``test_prefill_decode_consistency``.  Tolerances: ``tests/_torch_lm_ref.py``.

Tier-1 holds each arch with every serving flag on and with every flag off,
in float32 and bfloat16; the mixed flag settings are the slow tier.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.models import transformer as jt  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

from _torch_lm_ref import ARCHS, configs, flags, run_slice, to_np, to_torch  # noqa: E402

OTHER_ARCHS = [a for a in ARCHS if a != "qwen2-0.5b"]


def _grid():
    for arch, dtype, qs, qk in itertools.product(OTHER_ARCHS, ("float32", "bfloat16"), (False, True),
                                                 (False, True)):
        marks = () if qs == qk else (pytest.mark.slow,)
        yield pytest.param(arch, dtype, qs, qk, marks=marks,
                           id=f"{arch}-{dtype}-{'int8w' if qs else 'float'}-{'int8kv' if qk else 'bf16kv'}")


@pytest.mark.parametrize("arch,dtype,quant_serve,quant_kv", list(_grid()))
def test_arch_slice_equals_jax(arch, dtype, quant_serve, quant_kv):
    run_slice(arch, dtype, quant_serve, quant_kv)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch, dtype):
    """Greedy decode after prefill(s) == the last logits of prefill(s+1), in
    the port, on parameters carried from JAX's init_params(key 1) and tokens
    from key 2, as the JAX test draws them.  bfloat16 at the JAX test's
    tolerance; float32, where the two differ only in summation order, within
    1e-5 of the largest logit."""
    jcfg, tcfg = configs(arch, dtype)
    _, tfl = flags()
    params = to_torch(jt.init_params(jax.random.key(1), jcfg))
    toks = torch.from_numpy(np.array(jax.random.randint(jax.random.key(2), (1, 9), 2, jcfg.vocab_size)))
    full = {"tokens": toks}
    if tcfg.frontend == "vision":
        full["patch_embeds"] = torch.ones((1, tcfg.n_patches, tcfg.d_model), dtype=tt.dtype_of(tcfg))
    _, logits_full = tt.prefill(params, tcfg, full, tfl, max_len=12)
    cache_s, _ = tt.prefill(params, tcfg, dict(full, tokens=toks[:, :8]), tfl, max_len=12)
    _, logits_step = tt.decode_step(params, tcfg, cache_s, toks[:, 8:9], tfl)
    if dtype == "bfloat16":
        np.testing.assert_allclose(to_np(logits_full), to_np(logits_step), atol=0.55, rtol=0.2)
    else:
        ref = to_np(logits_full)
        np.testing.assert_allclose(to_np(logits_step), ref, atol=1e-5 * np.abs(ref).max(), rtol=0)
