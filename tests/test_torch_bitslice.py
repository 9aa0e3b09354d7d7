"""The PyTorch port's bit-sliced GEMM surface against the JAX package.

Covers ``repro_torch.kernels.ref`` (slice decomposition), the
``bitslice_matmul`` registry kernel (the plain version of
``csrc/bitslice_gemm.cu`` on CPU tensors), ``SlicedTensor`` /
``PrecisionSpec`` / ``api.matmul`` / ``api.quantized_matmul`` and the
quantized linear layers of ``repro_torch.models.common``.  Inputs are drawn
with numpy from fixed seeds and handed to both packages.  Integers must be
bit-exact, shifts of 32 or more included (both give 0 there).  The float32
outputs of the quantized paths are bit-equal too: quantization, the integer
product and the scale multiplications are the same IEEE operations in the
same order.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import api as japi  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro_torch.kernels import api as tapi  # noqa: E402
from repro_torch.kernels import bitslice_matmul as tbm  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402

I32_MIN, I32_MAX = -(2**31), 2**31 - 1
PRESETS = ("int4", "int8", "int12", "int16", "w4a8", "w8a16")


def ints(shape, lo, hi, seed, dtype=np.int32):
    return np.random.default_rng(seed).integers(lo, hi, shape, endpoint=False).astype(dtype)


def floats(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def same(want, got):
    """Bit-equality of a JAX array and a torch tensor, dtype included."""
    want, got = np.asarray(want), got.numpy()
    assert got.shape == want.shape and str(got.dtype) == str(want.dtype), \
        (got.shape, got.dtype, want.shape, want.dtype)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# slice decomposition
# ---------------------------------------------------------------------------


def _slice_inputs(bits, sb, seed):
    lo, hi = jref.slice_range(bits, sb)
    edges = [lo - 1, lo, lo + 1, hi - 1, hi, hi + 1, 0, 1, -1, I32_MIN, I32_MAX]
    edges = [min(max(v, I32_MIN), I32_MAX) for v in edges]
    span = np.clip(np.array([2 * lo, 2 * hi + 1]), I32_MIN, I32_MAX)
    rand = ints((97,), span[0], span[1], seed, np.int64)
    return np.concatenate([np.array(edges, np.int64), rand]).astype(np.int32)


@pytest.mark.parametrize("bits", [1, 3, 8, 12, 16, 24, 31, 32])
@pytest.mark.parametrize("sb", range(1, 9))
def test_slices_match_jax(sb, bits):
    """``slice_range``, ``to_slices`` (clamp edges and int32 extremes
    included) and ``from_slices`` agree with JAX; where the range leaves
    int32, both refuse with ``OverflowError``."""
    assert tref.slice_range(bits, sb) == jref.slice_range(bits, sb)
    x = _slice_inputs(bits, sb, seed=sb * 100 + bits)
    try:
        want = jref.to_slices(jnp.asarray(x), bits, sb)
    except OverflowError:
        with pytest.raises(OverflowError):
            tref.to_slices(t(x), bits, sb)
        return
    got = tref.to_slices(t(x), bits, sb)
    same(want, got)
    same(jref.from_slices(want, sb), tref.from_slices(got, sb))


def test_from_slices_of_raw_digit_stacks_wraps_like_jax():
    s = ints((5, 33), -128, 128, 1, np.int8)
    same(jref.from_slices(jnp.asarray(s), 8), tref.from_slices(t(s), 8))


# ---------------------------------------------------------------------------
# the bitslice_matmul kernel's plain version against the Pallas body / oracle
# ---------------------------------------------------------------------------


def _stacks(sx, m, k, sw, n, sb, seed):
    half = 1 << (sb - 1)
    return (ints((sx, m, k), -half, half, seed, np.int8),
            ints((sw, k, n), -half, half, seed + 1, np.int8))


# name → (sx, m, k, sw, n, slice_bits, skip); shapes divide the (64, 64, 64) block
INTERPRET_CASES = {
    "one-pair": (1, 128, 64, 1, 64, 8, ()),
    "2x2-pairs-K128": (2, 64, 128, 2, 64, 8, ()),
    "skip-one-pair": (2, 64, 64, 2, 128, 8, ((1, 0),)),
    "shift48-4x4-slices": (4, 64, 64, 4, 64, 8, ()),
}


@pytest.mark.parametrize("case", sorted(INTERPRET_CASES))
def test_bitslice_matmul_matches_jax_pallas_body(case):
    sx, m, k, sw, n, sb, skip = INTERPRET_CASES[case]
    x, w = _stacks(sx, m, k, sw, n, sb, seed=len(case))
    with japi.use_backend("interpret"):
        want = japi.dispatch("bitslice_matmul", jnp.asarray(x), jnp.asarray(w),
                             slice_bits=sb, skip=skip, pallas_kwargs={"block": (64, 64, 64)})
    same(want, tapi.dispatch("bitslice_matmul", t(x), t(w), slice_bits=sb, skip=skip))


# ragged shapes (no block divides them) and shifts of 32 or more
ORACLE_CASES = {
    "ragged-M37-K29-N45": (2, 37, 29, 3, 45, 8, ()),
    "ragged-skip": (3, 50, 17, 2, 9, 8, ((0, 1), (2, 0))),
    "shift48-int32-digits": (4, 19, 23, 4, 21, 8, ()),
    "shift-sb4-up-to-40": (6, 11, 13, 5, 7, 4, ()),
    "shift-sb1-up-to-37": (20, 9, 8, 18, 10, 1, ()),
    "sb5-skip": (3, 16, 40, 3, 24, 5, ((0, 0), (1, 2))),
    "all-skipped": (2, 8, 8, 2, 8, 8, ((0, 0), (0, 1), (1, 0), (1, 1))),
}


@pytest.mark.parametrize("case", sorted(ORACLE_CASES))
def test_bitslice_matmul_matches_jax_oracle(case):
    sx, m, k, sw, n, sb, skip = ORACLE_CASES[case]
    x, w = _stacks(sx, m, k, sw, n, sb, seed=len(case) + 7)
    with japi.use_backend("xla"):
        want = japi.dispatch("bitslice_matmul", jnp.asarray(x), jnp.asarray(w),
                             slice_bits=sb, skip=skip)
    same(want, tapi.dispatch("bitslice_matmul", t(x), t(w), slice_bits=sb, skip=skip))
    same(want, tapi.bitslice_matmul_oracle(t(x), t(w), slice_bits=sb, skip=skip))
    pairs = tapi.active_pairs(sx, sw, skip)
    same(want, tbm._bitslice_plain(t(x), t(w), sb, pairs))


def test_bitslice_matmul_ref_and_wide_ref_match_jax():
    x, w = _stacks(3, 20, 30, 2, 10, 8, seed=3)
    same(jref.bitslice_matmul_ref(jnp.asarray(x), jnp.asarray(w), 8),
         tref.bitslice_matmul_ref(t(x), t(w), 8))
    a, b = ints((12, 40), I32_MIN, I32_MAX, 4), ints((40, 9), -2**20, 2**20, 5)
    same(jref.int_matmul_wide_ref(jnp.asarray(a), jnp.asarray(b), 32, 21),
         tref.int_matmul_wide_ref(t(a), t(b), 32, 21))


def test_bitslice_matmul_refuses_mismatched_inner_dimensions():
    x, w = _stacks(1, 4, 5, 1, 4, 8, seed=9)
    with pytest.raises(ValueError, match="inner dimensions"):
        tapi.dispatch("bitslice_matmul", t(x), t(w[:, :4]), slice_bits=8)


# ---------------------------------------------------------------------------
# zero-slice skipping (the regression of tests/test_api.py)
# ---------------------------------------------------------------------------


def test_zero_slices_are_actually_skipped():
    x = t(ints((128, 128), -100, 100, 0))
    w = t(ints((128, 128), -50, 50, 1))
    xs, ws = tapi.SlicedTensor.from_int(x, 8), tapi.SlicedTensor.from_int(w, 16)
    assert ws.zero_slices == (1,), "the high weight slice must be all zero"
    skip = tapi.skip_pairs(xs, ws)
    assert skip == ((0, 1),)
    got = tapi.matmul(xs, ws)
    executed = tapi.last_executed_pairs()
    assert not (set(skip) & set(executed)), (skip, executed)
    assert set(executed) == set(tapi.active_pairs(1, 2, skip))
    dense = tapi.SlicedTensor(slices=ws.slices, slice_bits=8, orig_bits=16, zero_slices=())
    want = tapi.matmul(xs, dense)
    assert tapi.last_executed_pairs() == ((0, 0), (0, 1))
    assert torch.equal(want, got) and torch.equal(got, x @ w)


def test_quantized_matmul_applies_skip_by_construction():
    x = floats((32, 48), 2)
    w_q = ints((48, 24), -100, 100, 3)
    w_scale = np.full((24,), 0.01, np.float32)
    out = tapi.quantized_matmul(t(x), t(w_q), t(w_scale), tapi.PrecisionSpec.int16)
    # |w| < 128 → its high slice is zero and every pair reading it is skipped
    assert tapi.last_executed_pairs() == ((0, 0), (1, 0))
    want = japi.quantized_matmul(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(w_scale),
                                 japi.PrecisionSpec.int16)
    assert japi.last_executed_pairs() == tapi.last_executed_pairs()
    same(want, out)


@pytest.mark.parametrize("dead", [(), (0,), (1,), (0, 2)])
def test_zero_slice_pairs_and_skip_pairs_match_jax(dead):
    x = ints((3, 6, 5), -128, 128, 4, np.int8)
    w = ints((2, 5, 7), -128, 128, 5, np.int8)
    for s in dead:
        x[s] = 0
    assert tapi.zero_slice_pairs(t(x), t(w)) == japi.zero_slice_pairs(x, w)
    assert tapi.zero_slice_pairs(x, w) == japi.zero_slice_pairs(x, w)
    assert tapi.zero_slice_pairs(None, t(w)) == japi.zero_slice_pairs(None, w) == ()
    xs = tapi.SlicedTensor(slices=t(x), zero_slices=tapi._zero_slice_ids(t(x)))
    ws = tapi.SlicedTensor(slices=t(w), zero_slices=tapi._zero_slice_ids(t(w)))
    jxs = japi.SlicedTensor(slices=jnp.asarray(x), zero_slices=japi._zero_slice_ids(jnp.asarray(x)))
    jws = japi.SlicedTensor(slices=jnp.asarray(w), zero_slices=japi._zero_slice_ids(jnp.asarray(w)))
    assert xs.zero_slices == jxs.zero_slices == tuple(dead)
    assert tapi.skip_pairs(xs, ws) == japi.skip_pairs(jxs, jws)
    for skip in ((), ((0, 0),), ((2, 1), (0, 1))):
        assert tapi.active_pairs(3, 2, skip) == japi.active_pairs(3, 2, skip)


def test_zero_slice_ids_need_values():
    meta = torch.zeros((2, 3, 4), dtype=torch.int8, device="meta")
    assert tapi._zero_slice_ids(meta) == () and tapi._zero_slice_ids(None) == ()
    assert tapi.zero_slice_pairs(meta, meta) == ()
    assert tapi.static_value(meta) is None and tapi.static_value(None) is None
    x = torch.zeros(3)
    assert tapi.static_value(x) is x
    assert np.array_equal(tapi.static_value([1, 2]), np.array([1, 2]))


# ---------------------------------------------------------------------------
# PrecisionSpec and SlicedTensor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", PRESETS)
def test_precision_presets_match_jax(preset):
    tp, jp = getattr(tapi.PrecisionSpec, preset), getattr(japi.PrecisionSpec, preset)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert (tp.act_slices, tp.weight_slices, tp.single_pass) == \
        (jp.act_slices, jp.weight_slices, jp.single_pass)


@pytest.mark.parametrize("kwargs", [dict(slice_bits=0), dict(slice_bits=9), dict(act_bits=0),
                                    dict(act_bits=20, weight_bits=16)])
def test_precision_spec_validates_like_jax(kwargs):
    with pytest.raises(ValueError):
        japi.PrecisionSpec(**kwargs)
    with pytest.raises(ValueError):
        tapi.PrecisionSpec(**kwargs)


def test_precision_spec_from_quant_config():
    q = dataclasses.make_dataclass("Q", ["act_bits", "weight_bits", "slice_bits"])(12, 4, 4)
    assert tapi.PrecisionSpec.from_quant_config(q) == tapi.PrecisionSpec(12, 4, 4)


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("weight", [False, True], ids=["act", "weight"])
def test_sliced_tensor_quantize_matches_jax(preset, weight):
    x = floats((24, 40), 6, scale=3.0)
    x[3] = 0.0  # an all-zero row: the scale floor
    want = japi.SlicedTensor.quantize(jnp.asarray(x), getattr(japi.PrecisionSpec, preset), weight=weight)
    got = tapi.SlicedTensor.quantize(t(x), getattr(tapi.PrecisionSpec, preset), weight=weight)
    same(want.slices, got.slices)
    same(want.scale, got.scale)
    assert (got.slice_bits, got.orig_bits, got.zero_slices) == \
        (want.slice_bits, want.orig_bits, want.zero_slices)
    same(want.to_int(), got.to_int())
    same(want.dequantize(), got.dequantize())
    assert got.shape == want.shape and got.n_slices == want.n_slices


def test_sliced_tensor_flattens_like_the_jax_pytree():
    st = tapi.SlicedTensor.from_int(t(ints((4, 5), -300, 300, 7)), 16)
    jst = japi.SlicedTensor.from_int(jnp.asarray(ints((4, 5), -300, 300, 7)), 16)
    (leaves, td) = tapi._program.tree_flatten(st)
    jleaves, _ = jax.tree_util.tree_flatten(jst)
    assert len(leaves) == len(jleaves) == 1  # scale None is a node without leaves
    assert td.aux == jst.tree_flatten()[1]
    back = tapi._program.tree_unflatten(td, leaves)
    assert isinstance(back, tapi.SlicedTensor) and back.zero_slices == st.zero_slices


def test_matmul_refuses_mixed_slice_widths():
    a = tapi.SlicedTensor.from_int(t(ints((4, 4), -8, 8, 8)), 8, slice_bits=8)
    b = tapi.SlicedTensor.from_int(t(ints((4, 4), -8, 8, 9)), 8, slice_bits=4)
    with pytest.raises(ValueError, match="slice_bits mismatch"):
        tapi.matmul(a, b)


@pytest.mark.parametrize("preset", PRESETS)
def test_quantized_matmul_matches_jax(preset):
    x = floats((2, 9, 40), 10, scale=2.0)
    w_q = ints((40, 12), -(2**7), 2**7, 11)
    w_scale = np.abs(floats((12,), 12)) * 0.01 + 1e-3
    want = japi.quantized_matmul(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(w_scale),
                                 getattr(japi.PrecisionSpec, preset))
    got = tapi.quantized_matmul(t(x), t(w_q), t(w_scale), getattr(tapi.PrecisionSpec, preset))
    same(want, got)
    assert tapi.last_executed_pairs() == japi.last_executed_pairs()


def test_matmul_with_explicit_skip_matches_jax():
    x, w = ints((20, 16), -30000, 30000, 13), ints((16, 8), -30000, 30000, 14)
    jx, jw = japi.SlicedTensor.from_int(jnp.asarray(x), 16), japi.SlicedTensor.from_int(jnp.asarray(w), 16)
    tx, tw = tapi.SlicedTensor.from_int(t(x), 16), tapi.SlicedTensor.from_int(t(w), 16)
    same(japi.matmul(jx, jw, skip=((1, 1),)), tapi.matmul(tx, tw, skip=((1, 1),)))
    assert tapi.last_executed_pairs() == ((0, 0), (0, 1), (1, 0))


# ---------------------------------------------------------------------------
# quantized linear layers (models/common.py)
# ---------------------------------------------------------------------------


def _linear_params(d_in, d_out, seed, bias=False):
    w = floats((d_in, d_out), seed, scale=0.1)
    jp = jcommon.quantize_weight(jnp.asarray(w), 8)
    tp = tcommon.quantize_weight(t(w), 8)
    if bias:
        b = floats((d_out,), seed + 1)
        jp, tp = dict(jp, b=jnp.asarray(b)), dict(tp, b=t(b))
    return jp, tp


def test_quantize_weight_and_act_quant_match_jax():
    w = floats((3, 16, 24), 20, scale=0.2)
    jp, tp = jcommon.quantize_weight(jnp.asarray(w), 8), tcommon.quantize_weight(t(w), 8)
    same(jp["w_q"], tp["w_q"])
    same(jp["w_scale"], tp["w_scale"])
    x = floats((5, 7, 16), 21)
    for bits in (4, 8):
        (jq, js), (tq, ts) = jcommon._dynamic_act_quant(jnp.asarray(x), bits), \
            tcommon._dynamic_act_quant(t(x), bits)
        same(jq, tq)
        same(js, ts)


def test_int_matmul_on_cpu_is_a_widening_product():
    x, w = ints((2, 3, 16), -128, 128, 22, np.int8), ints((16, 5), -128, 128, 23, np.int8)
    same(jcommon.int_matmul(jnp.asarray(x), jnp.asarray(w)), tcommon.int_matmul(t(x), t(w)))


@pytest.mark.parametrize("spec", ["int8", "int4", "w8a16", "int16"])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
def test_quant_linear_matches_jax(spec, bias):
    """Single-pass (int8, int4) and multi-slice (w8a16, int16) branches."""
    jp, tp = _linear_params(32, 24, seed=30, bias=bias)
    x = floats((3, 5, 32), 31)
    want = jcommon.quant_linear(jp, jnp.asarray(x), getattr(japi.PrecisionSpec, spec))
    got = tcommon.quant_linear(tp, t(x), getattr(tapi.PrecisionSpec, spec))
    same(want, got)
    same(jcommon.linear(jp, jnp.asarray(x), getattr(japi.PrecisionSpec, spec)),
         tcommon.linear(tp, t(x), getattr(tapi.PrecisionSpec, spec)))


def test_linear_float_path_matches_jax():
    w, x = floats((16, 8), 32), floats((4, 16), 33)
    b = floats((8,), 34)
    want = jcommon.linear({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))
    got = tcommon.linear({"w": t(w), "b": t(b)}, t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("spec", ["int8", "w8a16", "int16"])
def test_quant_linear_relu_matches_jax(spec):
    jp, tp = _linear_params(48, 40, seed=40)
    x = floats((2, 6, 48), 41)
    want = jcommon.quant_linear_relu(jp, jnp.asarray(x), getattr(japi.PrecisionSpec, spec))
    tapi.reset_launch_counts()
    got = tcommon.quant_linear_relu(tp, t(x), getattr(tapi.PrecisionSpec, spec))
    same(want, got)
    assert tapi.launch_counts() == {}  # CPU tensors run the plain versions
    assert tapi.last_executed_pairs() == japi.last_executed_pairs()


def test_quant_linear_relu_with_bias_takes_the_eager_composition():
    jp, tp = _linear_params(16, 8, seed=50, bias=True)
    x = floats((4, 16), 51)
    same(jcommon.quant_linear_relu(jp, jnp.asarray(x)), tcommon.quant_linear_relu(tp, t(x)))
    w = floats((16, 8), 52)
    got = tcommon.quant_linear_relu({"w": t(w)}, t(x))
    np.testing.assert_allclose(got.numpy(), np.maximum(x @ w, 0), atol=1e-5, rtol=1e-5)


def test_registry_kernel_is_the_wrapper_of_the_cuda_source():
    kd = tapi.get_kernel("bitslice_matmul")
    assert kd.impl is tbm.bitslice_matmul and kd.oracle is tapi.bitslice_matmul_oracle
    assert tbm._build.ENTRY_POINTS["bitslice_gemm_i8"][0] == "bitslice_gemm"
