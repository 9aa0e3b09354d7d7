"""The PyTorch port's attention decode kernels (``repro_torch.kernels.attention``)
against the JAX package.

Inputs are drawn with numpy from fixed seeds and handed to both packages:
the conformance inputs of ``tests/test_pimsab_conformance.py`` (seeds 27–31,
34–35) and the edges the card kernels must get right (int32 wrap, shifts of
32 or more, negative accumulators, multi-hot and all-zero selectors, an
int32 row appended to an int8 cache, ragged and mixed-type decode GEMVs).  Each registry kernel of the port on
CPU tensors (its plain version) must equal the JAX Pallas body run under
``use_backend("interpret")`` and the JAX oracle (``"xla"``) bit for bit; the
port's oracles must equal the JAX oracles and run on ``meta`` tensors.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import api as japi  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import api as tapi  # noqa: E402
from repro_torch.kernels import attention as tatt  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def ints(shape, lo, hi, seed, dtype=np.int32):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(dtype)


def selector(t, rows, dtype=np.int32, value=1):
    s = np.zeros(t, dtype)
    s[list(rows)] = value
    return s


# name → (registry kernel, operands, kwargs)
CASES = {
    # the conformance inputs
    "qk-conformance": ("attention_qk", lambda: (ints((2, 8), -10, 10, 27), ints((4, 8), -10, 10, 28)), {}),
    "softmax-conformance": ("softmax_fixedpoint", lambda: (ints((4, 8), -400, 400, 29),), dict(in_frac=7)),
    "pv-conformance": ("attention_pv", lambda: (ints((2, 8), 0, 64, 30), ints((8, 4), -100, 100, 31)), {}),
    "kv_append-conformance": ("kv_append", lambda: (ints((8, 4), -100, 100, 34), ints((4,), -100, 100, 35),
                                                    selector(8, [5])), {}),
    # K6
    "qk-int8-gqa": ("attention_qk", lambda: (ints((7, 64), -128, 128, 40, np.int8),
                                             ints((300, 64), -128, 128, 41, np.int8)),
                    dict(q_bits=8, out_bits=22)),
    "qk-int8-odd-width": ("attention_qk", lambda: (ints((3, 5), -128, 128, 42, np.int8),
                                                   ints((33, 5), -128, 128, 43, np.int8)), {}),
    "qk-int8-q-int32-k": ("attention_qk", lambda: (ints((2, 16), -128, 128, 44, np.int8),
                                                   ints((40, 16), -2**20, 2**20, 45)), {}),
    "qk-int32-wrap": ("attention_qk", lambda: (ints((3, 32), I32_MIN, I32_MAX, 46),
                                               ints((50, 32), I32_MIN, I32_MAX, 47)), {}),
    # K7
    "softmax-in_frac-3": ("softmax_fixedpoint", lambda: (ints((3, 100), -50, 50, 48),), dict(in_frac=3)),
    "softmax-in_frac-13-scores": ("softmax_fixedpoint", lambda: (ints((7, 500), -2**20, 2**20, 49),),
                                  dict(in_frac=13)),
    "softmax-in_frac-28": ("softmax_fixedpoint", lambda: (ints((2, 64), -2**30, 2**30, 50),), dict(in_frac=28)),
    "softmax-int8-rows": ("softmax_fixedpoint", lambda: (ints((3, 40), -128, 128, 51, np.int8),),
                          dict(in_frac=5, in_bits=8)),
    # K8
    "pv-int8-values": ("attention_pv", lambda: (ints((7, 300), 0, 64, 53), ints((300, 64), -128, 128, 54, np.int8)),
                       {}),
    "pv-negative-acc": ("attention_pv", lambda: (ints((2, 100), -100, 100, 55), ints((100, 7), -1000, 1000, 56)),
                        dict(shift=3)),
    "pv-shift-40": ("attention_pv", lambda: (ints((3, 30), -1000, 1000, 57), ints((30, 5), -1000, 1000, 58)),
                    dict(shift=40)),
    "pv-shift-0": ("attention_pv", lambda: (ints((2, 20), -50, 50, 59), ints((20, 3), -50, 50, 60)), dict(shift=0)),
    "pv-int32-wrap": ("attention_pv", lambda: (ints((2, 50), I32_MIN, I32_MAX, 61), ints((50, 6), I32_MIN, I32_MAX, 62)),
                      dict(shift=6)),
    # K10
    "kv_append-two-hot": ("kv_append", lambda: (ints((10, 4), -100, 100, 63), ints((4,), -100, 100, 64),
                                                selector(10, [2, 9])), {}),
    "kv_append-all-zero": ("kv_append", lambda: (ints((10, 4), -100, 100, 65), ints((4,), -100, 100, 66),
                                                 selector(10, [])), {}),
    "kv_append-int32-to-int8": ("kv_append", lambda: (ints((12, 8), -128, 128, 67, np.int8),
                                                      ints((8,), I32_MIN, I32_MAX, 68), selector(12, [3], np.int8)),
                                {}),
    "kv_append-int8-selector-256": ("kv_append", lambda: (ints((6, 3), -100, 100, 69), ints((3,), -9, 9, 70),
                                                          selector(6, [1], np.int32, 256)), {}),
    # K9
    "gemv-int8-qwen-kv-proj": ("decode_gemv", lambda: (ints((128, 896), -128, 128, 73, np.int8),
                                                       ints((896,), -128, 128, 74, np.int8)),
                               dict(w_bits=8, x_bits=8)),
    "gemv-int8-ragged-K": ("decode_gemv", lambda: (ints((40, 37), -128, 128, 75, np.int8),
                                                   ints((37,), -128, 128, 76, np.int8)), {}),
    "gemv-int32-kernels-bench": ("decode_gemv", lambda: (ints((64, 512), -1000, 1000, 77),
                                                         ints((512,), -1000, 1000, 78)), {}),
    "gemv-int32-wrap": ("decode_gemv", lambda: (ints((16, 64), I32_MIN, I32_MAX, 79),
                                                ints((64,), I32_MIN, I32_MAX, 84)), {}),
    "gemv-int8-w-int32-x": ("decode_gemv", lambda: (ints((24, 48), -128, 128, 85, np.int8),
                                                    ints((48,), -2**20, 2**20, 86)), {}),
    "kv_append-int8-cache-64": ("kv_append", lambda: (ints((40, 64), -128, 128, 71, np.int8),
                                                      ints((64,), -128, 128, 72, np.int8),
                                                      selector(40, [39], np.int8)), {}),
}

# Cases where the Pallas body and the oracle disagree: scores whose range
# leaves int32 wrap x − max(x), and the exponentials' sum then goes beyond
# what the body's shifted restoring division handles.  The port follows the
# oracle.
ORACLE_ONLY = {
    "softmax-full-range": ("softmax_fixedpoint", lambda: (ints((2, 77), I32_MIN, I32_MAX, 52),), dict(in_frac=10)),
}


def _compare(want, got):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    assert str(got.dtype) == str(want.dtype), (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_jax_pallas_body(case):
    """The port's registry kernel on CPU tensors (the plain version of its
    CUDA kernel) equals the JAX Pallas body run in interpret mode."""
    name, make, kwargs = CASES[case]
    args = make()
    with japi.use_backend("interpret"):
        want = getattr(japi, name)(*map(jnp.asarray, args), **kwargs)
    tapi.reset_launch_counts()
    got = getattr(tapi, name)(*map(torch.from_numpy, args), **kwargs)
    assert tapi.launch_counts() == {}
    _compare(want, got)


@pytest.mark.parametrize("case", sorted(CASES) + sorted(ORACLE_ONLY))
def test_kernel_and_oracle_match_jax_oracle(case):
    name, make, kwargs = {**CASES, **ORACLE_ONLY}[case]
    args = make()
    with japi.use_backend("xla"):
        want = getattr(japi, name)(*map(jnp.asarray, args), **kwargs)
    targs = [torch.from_numpy(a) for a in args]
    _compare(want, tapi.get_kernel(name).oracle(*targs, **kwargs))
    _compare(want, getattr(tapi, name)(*targs, **kwargs))


def test_softmax_follows_the_oracle_on_a_long_equal_row():
    """At 2^17 equal scores the row sum is 2^23: the oracle's exact divide
    gives 2^14 // 2^23 = 0 everywhere.  (The Pallas body's restoring division
    shifts that sum left by up to 8 bits in int32, wraps, and gives 64 for
    every entry; the port is held to the oracle.)"""
    x = np.zeros((1, 131072), np.int32)
    want = jref.softmax_fixedpoint_ref(jnp.asarray(x), in_frac=13)
    got = tapi.softmax_fixedpoint(torch.from_numpy(x), in_frac=13)
    _compare(want, got)
    assert not got.any()


@pytest.mark.parametrize("in_frac,exc", [(2, NotImplementedError), (0, NotImplementedError),
                                         (29, OverflowError)])
def test_softmax_refuses_in_frac_where_jax_does(in_frac, exc):
    x = ints((2, 8), -50, 50, 80)
    with pytest.raises(exc):
        jref.softmax_fixedpoint_ref(jnp.asarray(x), in_frac=in_frac)
    with pytest.raises(exc):
        tref.softmax_fixedpoint_ref(torch.from_numpy(x), in_frac=in_frac)
    with pytest.raises(exc):
        tapi.softmax_fixedpoint(torch.from_numpy(x), in_frac=in_frac)


# name → (oracle, operand avals, kwargs, out aval)
META = {
    "attention_qk": (tref.attention_qk_ref, [((7, 64), torch.int8), ((300, 64), torch.int8)],
                     dict(q_bits=8), ((7, 300), torch.int32)),
    "softmax_fixedpoint": (tref.softmax_fixedpoint_ref, [((7, 300), torch.int32)], dict(in_frac=13),
                           ((7, 300), torch.int32)),
    "attention_pv": (tref.attention_pv_ref, [((7, 300), torch.int32), ((300, 64), torch.int8)], dict(shift=6),
                     ((7, 64), torch.int32)),
    "kv_append": (tref.kv_append_ref, [((300, 64), torch.int8), ((64,), torch.int32), ((300,), torch.int8)], {},
                  ((300, 64), torch.int8)),
    "decode_gemv": (tref.decode_gemv_ref, [((4864, 896), torch.int8), ((896,), torch.int8)], dict(w_bits=8),
                    ((4864,), torch.int32)),
}


@pytest.mark.parametrize("name", sorted(META))
def test_oracle_runs_on_meta_tensors(name):
    oracle, avals, kwargs, (shape, dtype) = META[name]
    out = oracle(*(torch.empty(s, dtype=d, device="meta") for s, d in avals), **kwargs)
    assert out.device.type == "meta" and tuple(out.shape) == shape and out.dtype == dtype
    assert tapi.get_kernel(name).oracle is oracle


def test_softmax_constants_equal_jax():
    assert (tref.SOFTMAX_F, tref.SOFTMAX_K, tref.SOFTMAX_FI) == \
        (jref.SOFTMAX_F, jref.SOFTMAX_K, jref.SOFTMAX_FI)


def test_kv_append_returns_a_new_cache():
    cache = torch.from_numpy(ints((6, 4), -9, 9, 81))
    before = cache.clone()
    out = tapi.kv_append(cache, torch.full((4,), 100, dtype=torch.int32),
                         torch.from_numpy(selector(6, [0, 5], np.int8)))
    assert torch.equal(cache, before) and out.data_ptr() != cache.data_ptr()
    assert out.dtype == cache.dtype and (out[[0, 5]] == 100).all() and torch.equal(out[1:5], cache[1:5])


@pytest.mark.parametrize("call,match", [
    (lambda: tapi.attention_qk(torch.zeros((1, 4), dtype=torch.int8), torch.zeros((5, 3), dtype=torch.int8)),
     "width"),
    (lambda: tapi.attention_pv(torch.zeros((1, 4), dtype=torch.int32), torch.zeros((5, 3), dtype=torch.int8)),
     "length"),
    (lambda: tapi.kv_append(torch.zeros((5, 3), dtype=torch.int8), torch.zeros(4, dtype=torch.int8),
                            torch.zeros(5, dtype=torch.int8)), "new row"),
    (lambda: tapi.kv_append(torch.zeros((5, 3), dtype=torch.int8), torch.zeros(3, dtype=torch.int8),
                            torch.zeros(4, dtype=torch.int8)), "selector"),
    (lambda: tapi.softmax_fixedpoint(torch.empty((1, tatt.SOFTMAX_MAX_COLS), dtype=torch.int32, device="meta"),
                                     in_frac=13), "columns"),
    (lambda: tapi.decode_gemv(torch.zeros((5, 3), dtype=torch.int8), torch.zeros(4, dtype=torch.int8)),
     "activation"),
])
def test_wrappers_refuse_bad_shapes(call, match):
    with pytest.raises(ValueError, match=match):
        call()


@pytest.mark.parametrize("dtype,ok", [(torch.int8, True), (torch.int32, True), (torch.int64, False),
                                      (torch.float32, False), (torch.int16, False)])
def test_card_operand_types(dtype, ok):
    """The card kernels take int8 and int32 (the selector also bool); other
    types are refused before a launch."""
    t = torch.zeros(3, dtype=dtype)
    if ok:
        assert tatt._elem_bytes(t) == t.element_size()
    else:
        with pytest.raises(TypeError, match="attention kernels take"):
            tatt._elem_bytes(t)
    assert tatt._elem_bytes(torch.zeros(3, dtype=torch.bool), tatt._SEL_BYTES) == 1


def test_attention_path_on_cpu_launches_no_kernel():
    q = torch.from_numpy(ints((1, 16), -128, 128, 82, np.int8))
    kc = torch.from_numpy(ints((32, 16), -128, 128, 83, np.int8))
    tapi.reset_launch_counts()
    kc2 = tapi.kv_append(kc, q[0], torch.from_numpy(selector(32, [4], np.int8)))
    p = tapi.softmax_fixedpoint(tapi.attention_qk(q, kc2), in_frac=13)
    out = tapi.attention_pv(p, kc2)
    assert tapi.launch_counts() == {} and out.shape == (1, 16) and out.dtype == torch.int32


def test_decode_gemv_wraps_like_the_oracle():
    """An int32 dot product past 2^31 wraps mod 2^32 on the port as in the
    JAX oracle."""
    w = np.full((2, 4), 2**30, np.int32)
    x = np.array([1, 1, 1, 2], np.int32)
    got = tapi.decode_gemv(torch.from_numpy(w), torch.from_numpy(x))
    _compare(jref.decode_gemv_ref(jnp.asarray(w), jnp.asarray(x)), got)
    assert got.tolist() == [2**30, 2**30]  # 5·2^30 mod 2^32
