"""The port's recurrent blocks (``repro_torch.models.recurrent``) against the
JAX package's ``models/recurrent.py``: the causal convolution, the RG-LRU
(its sequence form on the RG-LRU scan kernel's plain version, its decode
form elementwise), the mLSTM chunk scan and decode step, and the sLSTM, on
numpy-seeded inputs and on the weights of JAX's ``init_params`` at
``reduced_config``.

Tolerances, relative to the largest reference value: the convolution is
bit-equal (the same multiply-adds in the same dtype); the RG-LRU within 1e-4
(JAX scans associatively, the kernel step by step, each step one fused
multiply-add); the mLSTM and sLSTM, the same float32 ops in the same order
up to ``einsum``'s summation order, within 1e-5; bfloat16 blocks against JAX
run op by op within 2**-8 (one bfloat16 rounding).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import recurrent as jr  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.kernels import api as tapi  # noqa: E402
from repro_torch.models import recurrent as tr  # noqa: E402

from _torch_lm_ref import assert_close, configs, f32, to_np, to_torch  # noqa: E402

BLOCK_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -8}


def _normal(shape, seed, scale=1.0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale


def _pair(a, dtype="float32"):
    j = jnp.asarray(a, dtype)
    return j, to_torch(j)


def _bits(t):
    """A float32 or bfloat16 array's bits, for bit-equality."""
    a = t if isinstance(t, np.ndarray) else (np.asarray(t) if not torch.is_tensor(t) else None)
    if a is None:
        return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32).numpy()
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


# ---------------------------------------------------------------------------
# causal conv1d and the elementwise functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "carried"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_bit_equal(dtype, with_state):
    ju, tu = _pair(_normal((2, 9, 24), 0), dtype)
    jk, tk = _pair(_normal((4, 24), 1, 0.1), dtype)
    js, ts = _pair(_normal((2, 3, 24), 2), dtype) if with_state else (None, None)
    wy, ws = jr.causal_conv1d(ju, jk, js)
    gy, gs = tr.causal_conv1d(tu, tk, ts)
    assert gy.dtype == tu.dtype and gs.shape == (2, 3, 24)
    assert np.array_equal(_bits(gy), _bits(wy)) and np.array_equal(_bits(gs), _bits(ws))


def test_elementwise_forms_equal_jax():
    """softplus as logaddexp (F.softplus is x above 20), log-sigmoid, and
    the tanh-approximate GELU, on values up to ±40: within 2e-7 relative,
    or 1e-6 absolute where a value is near 0 (its last few ulps)."""
    x = np.linspace(-40, 40, 801).astype(np.float32)
    jx, tx = _pair(x)
    for want, got in ((jax.nn.softplus(jx), tr._softplus(tx)), (jax.nn.log_sigmoid(jx), tr._log_sigmoid(tx)),
                      (jax.nn.gelu(jx), tr._gelu(tx))):
        np.testing.assert_allclose(to_np(got), f32(want), rtol=2e-7, atol=1e-6)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def _mixer(arch, kind, dtype="float32", quant=False):
    """Group 0's mixer of ``kind`` from JAX's init_params at reduced_config:
    (JAX params, port params, JAX config, port config)."""
    from repro.models import common as jc

    jcfg, tcfg = configs(arch, dtype)
    params = jt.init_params(jax.random.key(0), jcfg)
    if quant:
        params = jc.maybe_quantize_tree(params, jcfg)
    key = next(k for k in params["blocks"] if k.endswith(kind))
    p = jax.tree_util.tree_map(lambda l: l[0], params["blocks"][key]["mixer"])
    return p, to_torch(p), jcfg, tcfg


def _rglru_state(cfg, b, seed, dtype):
    return {"h": _normal((b, cfg.d_model), seed), "conv": _normal((b, 3, cfg.d_model), seed + 1)}


FORMS = {"sequence": (12, False), "sequence-carried": (12, True), "decode": (1, True)}


@pytest.mark.parametrize("form", list(FORMS))
def test_rglru_block_equals_jax(form, monkeypatch):
    """y and the new state within 1e-4 of JAX's (associative scan, or its
    elementwise decode step); the sequence forms make one RG-LRU scan call
    from the carried h (or zeros), the decode step none."""
    s, carried = FORMS[form]
    jp, tp, jcfg, tcfg = _mixer("recurrentgemma-2b", "rglru")
    jx, tx = _pair(_normal((2, s, jcfg.d_model), 3))
    jst = tst = None
    if carried:
        st = _rglru_state(jcfg, 2, 4, "float32")
        jst = {k: jnp.asarray(v) for k, v in st.items()}
        tst = {k: torch.from_numpy(v) for k, v in st.items()}
    calls = []
    scan = tapi.rglru_scan

    def counting(a, b, h0):
        calls.append((tuple(a.shape), h0.clone()))
        return scan(a, b, h0)

    monkeypatch.setattr(tapi, "rglru_scan", counting)
    wy, wst = jr.rglru_block_apply(jp, jx, jcfg, jst)
    gy, gst = tr.rglru_block_apply(tp, tx, tcfg, tst)
    assert_close(wy, to_np(gy), 1e-4, "y")
    assert_close(wst["h"], to_np(gst["h"]), 1e-4, "h")
    assert np.array_equal(to_np(gst["conv"]), f32(wst["conv"]))
    if s == 1:
        assert calls == []
    else:
        assert [c[0] for c in calls] == [(2, s, jcfg.d_model)]
        assert torch.equal(calls[0][1], tst["h"] if carried else torch.zeros((2, jcfg.d_model)))


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8w"])
@pytest.mark.parametrize("form", list(FORMS))
def test_rglru_block_bfloat16_equals_jax_op_by_op(form, quant):
    s, carried = FORMS[form]
    jp, tp, jcfg, tcfg = _mixer("recurrentgemma-2b", "rglru", "bfloat16", quant)
    jx, tx = _pair(_normal((2, s, jcfg.d_model), 5), "bfloat16")
    jst = tst = None
    if carried:
        st = _rglru_state(jcfg, 2, 6, "bfloat16")
        jst = {"h": jnp.asarray(st["h"]), "conv": jnp.asarray(st["conv"], jnp.bfloat16)}
        tst = {"h": torch.from_numpy(st["h"]), "conv": to_torch(jst["conv"])}
    wy, wst = jr.rglru_block_apply(jp, jx, jcfg, jst)
    gy, gst = tr.rglru_block_apply(tp, tx, tcfg, tst)
    assert gy.dtype == torch.bfloat16 and gst["h"].dtype == torch.float32
    assert_close(wy, to_np(gy), BLOCK_TOL["bfloat16"], "y")
    assert_close(wst["h"], to_np(gst["h"]), 1e-4, "h")


def test_rglru_state_init_equals_jax():
    jcfg, tcfg = configs("recurrentgemma-2b", "bfloat16")
    want, got = jr.rglru_state_init(jcfg, 3), tr.rglru_state_init(tcfg, 3)
    for n in ("h", "conv"):
        assert tuple(got[n].shape) == want[n].shape and str(got[n].dtype).endswith(str(want[n].dtype))
        assert not got[n].any()


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def _mlstm_inputs(b, s, h, dh, seed, state="random"):
    """q, k, v, ig, lf and a state (zeros or random with a finite m)."""
    q = _normal((b, s, h, dh), seed) / np.sqrt(dh)
    k = _normal((b, s, h, dh), seed + 1)
    v = _normal((b, s, h, dh), seed + 2)
    ig = _normal((b, s, h), seed + 3)
    lf = np.log(1 / (1 + np.exp(-_normal((b, s, h), seed + 4) - 2))).astype(np.float32)  # log sigmoid
    if state == "zeros":
        st = {"C": np.zeros((b, h, dh, dh), np.float32), "n": np.zeros((b, h, dh), np.float32),
              "m": np.zeros((b, h), np.float32)}
    else:
        st = {"C": _normal((b, h, dh, dh), seed + 5), "n": _normal((b, h, dh), seed + 6),
              "m": _normal((b, h), seed + 7)}
    return tuple(a.astype(np.float32) for a in (q, k, v, ig, lf)), st


@pytest.mark.parametrize("state", ["zeros", "random"])
@pytest.mark.parametrize("s,chunk", [(10, 4), (8, 4), (5, 8), (1, 4)])
def test_mlstm_chunk_scan_equals_jax(s, chunk, state):
    """S a multiple of the chunk or not (the tail padded with ig = -1e30),
    one chunk shorter than the chunk size, a single step."""
    xs, st = _mlstm_inputs(2, s, 2, 8, 10, state)
    wy, wst = jr._mlstm_chunk_scan(*map(jnp.asarray, xs), {k: jnp.asarray(v) for k, v in st.items()}, chunk)
    gy, gst = tr._mlstm_chunk_scan(*map(torch.from_numpy, xs), {k: torch.from_numpy(v) for k, v in st.items()},
                                   chunk)
    assert_close(wy, to_np(gy), 1e-5, "y")
    for n in ("C", "n", "m"):
        assert_close(wst[n], to_np(gst[n]), 1e-5, n)


def test_mlstm_decode_step_equals_jax():
    xs, st = _mlstm_inputs(3, 1, 2, 8, 20)
    xs = [a[:, 0] for a in xs]
    wy, wst = jr._mlstm_decode_step(*map(jnp.asarray, xs), {k: jnp.asarray(v) for k, v in st.items()})
    gy, gst = tr._mlstm_decode_step(*map(torch.from_numpy, xs), {k: torch.from_numpy(v) for k, v in st.items()})
    assert_close(wy, to_np(gy), 1e-5, "y")
    for n in ("C", "n", "m"):
        assert_close(wst[n], to_np(gst[n]), 1e-5, n)


@pytest.mark.parametrize("chunk", [3, 16])
def test_mlstm_chunked_equals_step_by_step(chunk):
    """The chunk scan over 11 steps equals 11 decode steps from the same
    state (the same stabilized recurrence, summed in another order)."""
    xs, st = _mlstm_inputs(2, 11, 2, 8, 30)
    ts = [torch.from_numpy(a) for a in xs]
    y_chunk, st_chunk = tr._mlstm_chunk_scan(*ts, {k: torch.from_numpy(v) for k, v in st.items()}, chunk)
    cell = {k: torch.from_numpy(v) for k, v in st.items()}
    ys = []
    for t in range(11):
        y, cell = tr._mlstm_decode_step(*(a[:, t] for a in ts), cell)
        ys.append(y)
    assert_close(to_np(torch.stack(ys, 1)), to_np(y_chunk), 1e-4, "y")
    for n in ("C", "n"):
        # C and n are stored relative to exp(m): compare the unscaled state
        a = cell[n] * torch.exp(cell["m"]).reshape(*cell["m"].shape, *([1] * (cell[n].dim() - 2)))
        b = st_chunk[n] * torch.exp(st_chunk["m"]).reshape(*st_chunk["m"].shape, *([1] * (cell[n].dim() - 2)))
        assert_close(to_np(a), to_np(b), 1e-4, n)


@pytest.mark.parametrize("form", list(FORMS))
def test_mlstm_block_equals_jax(form):
    s, carried = FORMS[form]
    jp, tp, jcfg, tcfg = _mixer("xlstm-1.3b", "mlstm")
    jx, tx = _pair(_normal((2, s, jcfg.d_model), 40))
    jst = tst = None
    if carried:
        pf, h, dh = tr._mlstm_dims(tcfg)
        _, st = _mlstm_inputs(2, 1, h, dh, 41)
        st["conv"] = _normal((2, 3, pf), 42)
        jst = {k: jnp.asarray(v) for k, v in st.items()}
        tst = {k: torch.from_numpy(v) for k, v in st.items()}
    wy, wst = jr.mlstm_block_apply(jp, jx, jcfg, jst, chunk=8)
    gy, gst = tr.mlstm_block_apply(tp, tx, tcfg, tst, chunk=8)
    assert_close(wy, to_np(gy), 1e-5, "y")
    for n in ("C", "n", "m", "conv"):
        assert_close(wst[n], to_np(gst[n]), 1e-5, n)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8w"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_blocks_bfloat16_equal_jax_op_by_op(kind, quant):
    jp, tp, jcfg, tcfg = _mixer("xlstm-1.3b", kind, "bfloat16", quant)
    jx, tx = _pair(_normal((2, 12, jcfg.d_model), 43), "bfloat16")
    japply, tapply = (jr.mlstm_block_apply, tr.mlstm_block_apply) if kind == "mlstm" else \
        (jr.slstm_block_apply, tr.slstm_block_apply)
    wy, _ = japply(jp, jx, jcfg)
    gy, _ = tapply(tp, tx, tcfg)
    assert gy.dtype == torch.bfloat16
    assert_close(wy, to_np(gy), BLOCK_TOL["bfloat16"], kind)


def test_mlstm_state_inits_equal_jax():
    jcfg, tcfg = configs("xlstm-1.3b", "bfloat16")
    want, got = jr.mlstm_full_state_init(jcfg, 2), tr.mlstm_full_state_init(tcfg, 2)
    assert set(got) == set(want) == {"C", "n", "m", "conv"}
    for n in want:
        assert tuple(got[n].shape) == want[n].shape and str(got[n].dtype).endswith(str(want[n].dtype))
        assert not got[n].any()


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", list(FORMS))
def test_slstm_block_equals_jax(form):
    s, carried = FORMS[form]
    jp, tp, jcfg, tcfg = _mixer("xlstm-1.3b", "slstm")
    jx, tx = _pair(_normal((2, s, jcfg.d_model), 50))
    jst = tst = None
    if carried:
        h, dh = tcfg.n_heads, tcfg.d_model // tcfg.n_heads
        st = {"c": _normal((2, h, dh), 51), "n": np.abs(_normal((2, h, dh), 52)) + 1,
              "h": _normal((2, h, dh), 53), "m": _normal((2, h, dh), 54)}
        jst = {k: jnp.asarray(v) for k, v in st.items()}
        tst = {k: torch.from_numpy(v) for k, v in st.items()}
    wy, wst = jr.slstm_block_apply(jp, jx, jcfg, jst)
    gy, gst = tr.slstm_block_apply(tp, tx, tcfg, tst)
    assert_close(wy, to_np(gy), 1e-5, "y")
    for n in ("c", "n", "h", "m"):
        assert_close(wst[n], to_np(gst[n]), 1e-5, n)


def test_slstm_state_init_equals_jax():
    jcfg, tcfg = configs("xlstm-1.3b", "float32")
    want, got = jr.slstm_state_init(jcfg, 2), tr.slstm_state_init(tcfg, 2)
    for n in ("c", "n", "h", "m"):
        assert tuple(got[n].shape) == want[n].shape and np.array_equal(to_np(got[n]), f32(want[n]))
