"""The port's serving engine (``repro_torch.serve.engine``) and launcher
(``repro_torch.launch.serve``) against the JAX package's.

Both engines run Qwen2-0.5B at ``reduced_config`` in float32 on the same
weights (JAX's ``init_params``, quantized by each engine) over 4 requests of
mixed prompt lengths, one of which runs past ``max_len`` (where JAX's
``dynamic_update_slice`` clamps the write to the last row).  Token streams
must be equal up to the first step where the JAX engine's top-2 margin is
within twice the tolerance of ``tests/_torch_lm_ref.py`` (a near-tie either
package may break either way); the JAX engine's logits are recorded to check
that.
"""
import contextlib
import io
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.launch import serve as jserve_cli  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.kernels import api as tapi  # noqa: E402
from repro_torch.launch import serve as tserve_cli  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

from _torch_lm_ref import configs, f32, flags, to_np, to_torch, tol  # noqa: E402

MAX_LEN = 16
# prompt lengths and new tokens: the longest prompt (12) plus 6 new tokens
# writes rows 12..16, past max_len = 16 (the clamp)
PROMPTS = ((3, 5), (8, 6), (11, 4), (12, 6))


def _requests(mod, cfg, seed=5):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, prompt=rng.integers(2, cfg.vocab_size, size=n).astype(np.int32), max_new_tokens=m)
            for i, (n, m) in enumerate(PROMPTS)]


def _recording(step, log):
    def call(*args):
        cache, logits = step(*args)
        log.append(f32(logits))
        return cache, logits
    return call


def _run_pair(quant_serve=True, quant_kv=False, eos=-1, backend=None, dtype="float32"):
    """(JAX streams, the JAX engine's logits per step, port streams)."""
    jcfg, tcfg = configs("qwen2-0.5b", dtype)
    jfl, tfl = flags(quant_serve=quant_serve, quant_kv=quant_kv)
    params = jt.init_params(jax.random.key(0), jcfg)
    je = jengine.ServeEngine(jcfg, params, jfl, max_len=MAX_LEN, eos=eos, backend=backend)
    log = []
    je._prefill, je._decode = _recording(je._prefill, log), _recording(je._decode, log)
    jreqs = je.run(_requests(jengine, jcfg))
    te = tengine.ServeEngine(tcfg, to_torch(params), tfl, max_len=MAX_LEN, eos=eos, backend=backend)
    treqs = te.run(_requests(tengine, tcfg))
    return [r.generated for r in jreqs], log, [r.generated for r in treqs], tol(dtype, quant_serve or quant_kv)


def _assert_streams_agree(want, logits, got, rel):
    """Per lane: equal streams, or equal up to a near-tie of the JAX engine
    (top-2 margin ≤ 2 · rel · max |logits| at that step); returns the count
    of tokens compared."""
    compared = 0
    for lane, (w, g) in enumerate(zip(want, got)):
        assert len(g) == len(w) or w != g
        for k, (a, b) in enumerate(zip(w, g)):
            if a != b:
                step = logits[k][lane]
                top2 = np.sort(step)[-2:]
                assert top2[1] - top2[0] <= 2 * rel * np.abs(logits[k]).max(), (lane, k, w, g)
                break
            compared += 1
        else:
            assert len(w) == len(g), (lane, w, g)
    return compared


@pytest.mark.parametrize("quant_kv", [False, True], ids=["bf16kv", "int8kv"])
@pytest.mark.parametrize("quant_serve", [False, True], ids=["float", "int8w"])
def test_engine_streams_equal_jax(quant_serve, quant_kv):
    want, logits, got, rel = _run_pair(quant_serve, quant_kv)
    assert [len(w) for w in want] == [m for _, m in PROMPTS]
    compared = _assert_streams_agree(want, logits, got, rel)
    if not (quant_serve or quant_kv):
        assert compared == sum(m for _, m in PROMPTS)  # float32 at 1e-5: no near-tie


def test_engine_eos_retires_lanes_as_jax():
    probe, _, _, _ = _run_pair(quant_serve=False)
    eos = probe[1][1]  # lane 1's second token: that lane retires there
    want, logits, got, rel = _run_pair(quant_serve=False, eos=eos)
    assert len(want[1]) <= 2 and want[1][-1] == eos
    _assert_streams_agree(want, logits, got, rel)
    assert got == want


def test_decode_past_max_len_clamps_to_the_last_row_as_jax():
    """A write at pos ≥ max_len lands on row max_len − 1, as JAX's
    dynamic_update_slice clamps it; torch indexing would raise."""
    jcfg, tcfg = configs("qwen2-0.5b", "float32")
    jfl, tfl = flags(quant_serve=False)
    params = jt.init_params(jax.random.key(0), jcfg)
    tp = to_torch(params)
    toks = np.random.default_rng(3).integers(2, 256, (1, 8)).astype(np.int32)
    jcache, _ = jt.prefill(params, jcfg, {"tokens": jax.numpy.asarray(toks)}, jfl, max_len=8)
    tcache, _ = tt.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)}, tfl, max_len=8)
    for step in range(2):
        nt = np.full((1, 1), 7 + step, np.int32)
        jcache, jl = jt.decode_step(params, jcfg, jcache, jax.numpy.asarray(nt), jfl)
        tcache, tl = tt.decode_step(tp, tcfg, tcache, torch.from_numpy(nt), tfl)
        assert int(tcache["pos"]) == 9 + step
        np.testing.assert_allclose(to_np(tl), f32(jl), atol=1e-5 * np.abs(f32(jl)).max(), rtol=0)
        for n in ("k", "v"):
            np.testing.assert_allclose(to_np(tcache["blocks"]["00_attn"][n]),
                                       f32(jcache["blocks"]["00_attn"][n]), atol=1e-5, rtol=0)


def test_second_engine_hits_the_compile_cache():
    _, tcfg = configs("qwen2-0.5b", "float32")
    _, tfl = flags(quant_serve=False)
    params = tt.init_params(tcfg, 0, device="cpu")
    tapi.clear_compile_cache()
    e1 = tengine.ServeEngine(tcfg, params, tfl, max_len=MAX_LEN)
    info = tapi.compile_cache_info()
    assert (info.hits, info.misses, info.size) == (0, 2, 2)
    e2 = tengine.ServeEngine(tcfg, params, tfl, max_len=MAX_LEN)
    info = tapi.compile_cache_info()
    assert (info.hits, info.misses, info.size) == (2, 2, 2)
    assert e2._prefill is e1._prefill and e2._decode is e1._decode
    tengine.ServeEngine(tcfg, params, tfl, max_len=MAX_LEN + 1)  # another prefill signature
    info = tapi.compile_cache_info()
    assert (info.hits, info.misses) == (3, 3)


@pytest.mark.parametrize("backend", ["xla", "pallas", "interpret", "pimsab"])
def test_each_jax_backend_changes_nothing(backend):
    """JAX's int8 serving path calls no registry kernel, so its backend scope
    changes no token; the port's engine behaves the same under each name
    (the pimsab scope reaches no simulator: no report is logged)."""
    base_want, _, base, _ = _run_pair(quant_kv=True)
    tapi.clear_sim_report_log()
    want, _, got, _ = _run_pair(quant_kv=True, backend=backend)
    assert want == base_want and got == base
    assert tuple(tapi.sim_report_log()) == ()


def test_unknown_backend_raises_when_a_step_runs_as_jax():
    jcfg, tcfg = configs("qwen2-0.5b", "float32")
    jfl, tfl = flags()
    params = jt.init_params(jax.random.key(0), jcfg)
    je = jengine.ServeEngine(jcfg, params, jfl, max_len=MAX_LEN, backend="bogus")
    with pytest.raises(ValueError, match="unknown backend"):
        je.run(_requests(jengine, jcfg))
    te = tengine.ServeEngine(tcfg, to_torch(params), tfl, max_len=MAX_LEN, backend="bogus")
    with pytest.raises(ValueError, match="unknown backend"):
        te.run(_requests(tengine, tcfg))


def test_serve_params_shape_on_meta_equals_jax():
    jcfg, tcfg = configs("granite-20b", "bfloat16")
    jfl, tfl = flags()
    want = jax.tree_util.tree_flatten_with_path(jengine.serve_params_shape(jcfg, jfl))[0]
    got = tengine.serve_params_shape(tcfg, tfl)
    for path, leaf in want:
        node = got
        for k in path:
            node = node[k.key]
        assert node.device.type == "meta" and tuple(node.shape) == leaf.shape
        assert str(node.dtype).endswith(str(leaf.dtype)), path


def _cli_lines(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue().splitlines()


def _shape(line):
    return re.sub(r"\d+(\.\d+)?", "N", line)


@pytest.mark.parametrize("extra", [[], ["--no-quant", "--requests", "3", "--new-tokens", "5"]],
                         ids=["quant", "no-quant"])
def test_cli_prints_the_jax_launchers_lines(extra, monkeypatch):
    args = ["--arch", "qwen2-0.5b", "--reduced"] + extra
    monkeypatch.setattr(sys, "argv", ["serve"] + args)
    want = _cli_lines(lambda _: jserve_cli.main(), None)
    got = _cli_lines(tserve_cli.main, args + ["--device", "cpu"])
    assert [_shape(x) for x in got] == [_shape(x) for x in want]
    n_req = 3 if extra else 4
    n_tok = 5 if extra else 16
    assert got[0].startswith(f"served {n_req} requests, {n_req * n_tok} tokens in ")
    assert got[0].endswith(f"quant_serve={not extra})")


def test_cli_requests_equal_the_jax_launchers():
    jcfg, tcfg = configs("qwen2-0.5b", "bfloat16")
    rng = np.random.default_rng(0)
    want = [rng.integers(2, jcfg.vocab_size, size=8).astype(np.int32) for _ in range(4)]
    got = tserve_cli.make_requests(tcfg, 4, 16)
    assert all(np.array_equal(r.prompt, w) and r.max_new_tokens == 16 for r, w in zip(got, want))
    assert tserve_cli.serve_flags() == tserve_cli.RunFlags(attn_chunk=64, flash_threshold=256, quant_serve=True)


def test_cli_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card refusal cannot be shown here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve_cli.main(["--arch", "qwen2-0.5b", "--reduced"])
