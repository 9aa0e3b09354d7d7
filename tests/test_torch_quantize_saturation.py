"""The port's int8 quantization saturates above 8 bits, as the JAX package's.

``quantize_weight(w, bits)`` clips to ``[-2**(bits-1), 2**(bits-1) - 1]``
and casts to int8.  Above 8 bits the clip leaves values outside int8; XLA's
float → int8 conversion saturates them (200.0 → 127) where a torch cast
wraps (200.0 → −56).  ``repro_torch.models.common`` saturates first, so both
packages give the same int8 weights and the same ``quant_linear`` outputs.
Inputs are drawn with numpy and handed to both packages; everything is
compared bit for bit, as ``test_torch_bitslice.py`` compares the quantized
paths.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import api as japi  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro_torch.kernels import api as tapi  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def same(want, got):
    """Bit-equality of a JAX array and a torch tensor, dtype included."""
    want, got = np.asarray(want), got.numpy()
    assert got.shape == want.shape and str(got.dtype) == str(want.dtype), \
        (got.shape, got.dtype, want.shape, want.dtype)
    np.testing.assert_array_equal(got, want)


def weights(name):
    if name == "one-hot":  # the minimal failing input: 1.0 quantizes to qmax ≥ 255
        return np.array([[1.0], [0.0]], np.float32)
    return np.random.default_rng(0).standard_normal((40, 6)).astype(np.float32)


@pytest.mark.parametrize("name", ["one-hot", "normal-40x6"])
@pytest.mark.parametrize("bits", range(9, 17))
def test_quantize_weight_saturates_like_jax_above_8_bits(bits, name):
    w = weights(name)
    want = jcommon.quantize_weight(jnp.asarray(w), bits)
    got = tcommon.quantize_weight(t(w), bits)
    same(want["w_q"], got["w_q"])
    same(want["w_scale"], got["w_scale"])
    assert int(got["w_q"].max()) == 127  # each column's absmax saturates


@pytest.mark.parametrize("backend", ["xla", "interpret"])
@pytest.mark.parametrize("spec", ["int12", "int16"])
def test_quant_linear_on_a_freshly_quantized_wide_weight_matches_jax(spec, backend):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((40, 6)).astype(np.float32)
    x = rng.standard_normal((9, 40)).astype(np.float32)
    jspec, tspec = getattr(japi.PrecisionSpec, spec), getattr(tapi.PrecisionSpec, spec)
    jp = jcommon.quantize_weight(jnp.asarray(w), jspec.weight_bits)
    tp = tcommon.quantize_weight(t(w), tspec.weight_bits)
    with japi.use_backend(backend):
        want = jcommon.quant_linear(jp, jnp.asarray(x), jspec)
    same(want, tcommon.quant_linear(tp, t(x), tspec))


@pytest.mark.parametrize("bits", range(2, 9))
def test_dynamic_act_quant_through_the_saturating_cast_is_unchanged(bits):
    """At bits ≤ 8 the clip already keeps values in int8: the shared
    saturating cast changes nothing, against JAX and the plain cast."""
    x = (np.random.default_rng(bits).standard_normal((5, 7, 16)) * 3).astype(np.float32)
    jq, js = jcommon._dynamic_act_quant(jnp.asarray(x), bits)
    tq, ts = tcommon._dynamic_act_quant(t(x), bits)
    same(jq, tq)
    same(js, ts)
    qmax = 2 ** (bits - 1) - 1
    plain = torch.clamp(torch.round(t(x) / ts), -qmax - 1, qmax).to(torch.int8)
    assert torch.equal(tq, plain)
