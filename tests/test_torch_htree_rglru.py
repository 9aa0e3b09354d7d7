"""The PyTorch port's H-tree reduction and RG-LRU scan
(``repro_torch.kernels.htree_reduce``, ``repro_torch.kernels.rglru_scan``)
against the JAX package.

Inputs are drawn with numpy from fixed seeds and handed to both packages.
``htree_reduce`` on CPU tensors (the plain version of its CUDA kernel) must
equal the JAX Pallas body run under ``use_backend("interpret")`` bit for
bit in float32, bfloat16 and int32: both add adjacent pairs first.
``rglru_scan``'s plain version must equal the Pallas body bit for bit too,
since both round ``a·h + b`` once (an fma); its oracle, an associative scan
that adds in another order, must stay within the JAX kernel tests' tolerance
(atol = rtol = 1e-4) of JAX's oracle and of the plain version.
"""
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import api as japi  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import api as tapi  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rglru_scan as trg  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)


def lanes(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-2**31, 2**31, shape).astype(np.int32)
    return rng.standard_normal(shape).astype(np.float32)


def to_both(x, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    if dtype == "bfloat16":
        return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def as_numpy(arr):
    """float32 numpy values of a JAX array or a torch tensor (bfloat16
    widens exactly)."""
    if isinstance(arr, torch.Tensor):
        return (arr.float() if arr.dtype == torch.bfloat16 else arr).numpy()
    return np.asarray(arr.astype(jnp.float32) if arr.dtype == jnp.bfloat16 else arr)


def gates(shape, seed):
    """a = sigmoid(normal), b and h0 normal, as ``benchmarks/kernels_bench.py``
    draws them."""
    rng = np.random.default_rng(seed)
    bsz, _, w = shape
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal(shape)))).astype(np.float32)
    return a, rng.standard_normal(shape).astype(np.float32), rng.standard_normal((bsz, w)).astype(np.float32)


# ---------------------------------------------------------------------------
# htree_reduce
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("shape", [(8, 512), (64, 512), (256, 1024)])
def test_htree_matches_jax_pallas_body(shape, dtype):
    xj, xt = to_both(lanes(shape, dtype, sum(shape)), dtype)
    with japi.use_backend("interpret"):
        want = japi.htree_reduce(xj)
    tapi.reset_launch_counts()
    got = tapi.htree_reduce(xt)
    assert tapi.launch_counts() == {}
    assert got.dtype == xt.dtype and tuple(got.shape) == (shape[1],) and str(want.dtype) == dtype
    np.testing.assert_array_equal(as_numpy(got), as_numpy(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("n", [1, 2, 16])
def test_htree_oracle_matches_jax_oracle(n, dtype):
    xj, xt = to_both(lanes((n, 33), dtype, n + 7), dtype)
    want = jref.htree_reduce_ref(xj)
    np.testing.assert_array_equal(as_numpy(tapi.get_kernel("htree_reduce").oracle(xt)), as_numpy(want))
    np.testing.assert_array_equal(as_numpy(tapi.htree_reduce(xt)), as_numpy(want))


def test_htree_differs_from_a_serial_sum():
    """The tree order matters in float32: a sequential sum of the same lanes
    differs, so the bit-equal comparisons above pin the order."""
    x = torch.from_numpy(lanes((256, 1024), "float32", 5))
    serial = x[0].clone()
    for i in range(1, 256):
        serial = serial + x[i]
    assert not torch.equal(tapi.htree_reduce(x), serial)


@pytest.mark.parametrize("n", [3, 6, 100])
def test_htree_refuses_lanes_that_are_not_a_power_of_two(n):
    x = lanes((n, 8), "float32", n)
    with pytest.raises(AssertionError):
        jref.htree_reduce_ref(jnp.asarray(x))
    with pytest.raises(ValueError, match="power-of-two"):
        tapi.htree_reduce(torch.from_numpy(x))
    with pytest.raises(ValueError, match="power-of-two"):
        tref.htree_reduce_ref(torch.from_numpy(x))


@pytest.mark.parametrize("dtype", [torch.float64, torch.int8, torch.float16])
def test_htree_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="htree_reduce takes"):
        tapi.htree_reduce(torch.zeros((4, 8), dtype=dtype))


# ---------------------------------------------------------------------------
# rglru_scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 256, 512), (3, 128, 512)])
def test_rglru_plain_matches_jax_pallas_body(shape):
    a, b, h0 = gates(shape, sum(shape))
    with japi.use_backend("interpret"):
        want = np.asarray(japi.rglru_scan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0)))
    tapi.reset_launch_counts()
    got = tapi.rglru_scan(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(h0))
    assert tapi.launch_counts() == {}
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(1, 256, 512), (3, 128, 512), (2, 7, 5)])
def test_rglru_oracle_within_tolerance_of_jax_oracle_and_plain(shape):
    a, b, h0 = gates(shape, sum(shape) + 1)
    want = np.asarray(jref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0)))
    ta, tb, th = map(torch.from_numpy, (a, b, h0))
    oracle = tapi.get_kernel("rglru_scan").oracle(ta, tb, th).numpy()
    np.testing.assert_allclose(oracle, want, **TOL)
    np.testing.assert_allclose(oracle, tapi.rglru_scan(ta, tb, th).numpy(), **TOL)


def test_rglru_plain_is_not_a_multiply_then_add():
    """A multiply then an add (two roundings) drifts from the fma chain: the
    bit-equal comparison above pins the fused update."""
    a, b, h0 = gates((1, 256, 512), 9)
    ta, tb, h = map(torch.from_numpy, (a, b, h0))
    steps = []
    for t in range(ta.shape[1]):
        h = ta[:, t] * h + tb[:, t]
        steps.append(h)
    assert not torch.equal(torch.stack(steps, 1), tapi.rglru_scan(ta, tb, torch.from_numpy(h0)))


def _round_to_f32(q: Fraction) -> np.float32:
    """The float32 nearest the rational ``q``, ties to even."""
    c = np.float32(float(q))
    best = None
    for cand in (np.nextafter(c, np.float32(-np.inf)), c, np.nextafter(c, np.float32(np.inf))):
        key = (abs(Fraction(float(cand)) - q), int(np.array(cand).view(np.int32)) & 1)
        if best is None or key < best[0]:
            best = (key, cand)
    return best[1]


def test_fma_rounds_once_where_float64_double_rounds():
    """a·h + b = 1 + 3·2^-24 − 2^-60 lies just below a float32 midpoint; a
    float64 sum lands on the midpoint and then rounds to even, one ulp too
    far.  The round-to-odd fma gives the correctly rounded 1 + 2^-23."""
    a = torch.tensor([2.0**-24 * (1 + 2.0**-18)], dtype=torch.float32)
    h = torch.tensor([1 - 2.0**-18], dtype=torch.float32)
    b = torch.tensor([1 + 2.0**-23], dtype=torch.float32)
    assert (a.double() * h.double() + b.double()).float().item() == 1 + 2.0**-22
    assert trg.fma_f32(a, h, b).item() == 1 + 2.0**-23


def test_fma_is_correctly_rounded():
    rng = np.random.default_rng(11)
    a = rng.standard_normal(300).astype(np.float32)
    h = (rng.standard_normal(300) * 2.0 ** rng.integers(-30, 30, 300)).astype(np.float32)
    b = (rng.standard_normal(300) * 2.0 ** rng.integers(-30, 30, 300)).astype(np.float32)
    got = trg.fma_f32(*map(torch.from_numpy, (a, h, b))).numpy()
    want = [_round_to_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
            for x, y, z in zip(a, h, b)]
    np.testing.assert_array_equal(got, np.array(want, np.float32))


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_rglru_refuses_other_dtypes(dtype):
    a = torch.zeros((1, 4, 3), dtype=dtype)
    with pytest.raises(TypeError, match="float32"):
        tapi.rglru_scan(a, a, torch.zeros((1, 3), dtype=dtype))


def test_rglru_refuses_mismatched_shapes():
    a = torch.zeros((2, 4, 3))
    with pytest.raises(ValueError, match="h0"):
        tapi.rglru_scan(a, a, torch.zeros((2, 4)))
    with pytest.raises(ValueError, match="h0"):
        tapi.rglru_scan(a, torch.zeros((2, 5, 3)), torch.zeros((2, 3)))


# ---------------------------------------------------------------------------
# shape inference reads no values
# ---------------------------------------------------------------------------

# name → (oracle, operand avals, out aval)
META = {
    "htree_reduce-float32": (tref.htree_reduce_ref, [((256, 65536), torch.float32)], ((65536,), torch.float32)),
    "htree_reduce-bfloat16": (tref.htree_reduce_ref, [((8, 40), torch.bfloat16)], ((40,), torch.bfloat16)),
    "htree_reduce-int32": (tref.htree_reduce_ref, [((1, 3), torch.int32)], ((3,), torch.int32)),
    "rglru_scan": (tref.rglru_scan_ref, [((4, 2048, 2560), torch.float32)] * 2 + [((4, 2560), torch.float32)],
                   ((4, 2048, 2560), torch.float32)),
    "rglru_scan-odd-T": (tref.rglru_scan_ref, [((2, 7, 5), torch.float32)] * 2 + [((2, 5), torch.float32)],
                         ((2, 7, 5), torch.float32)),
}


@pytest.mark.parametrize("case", sorted(META))
def test_oracle_runs_on_meta_tensors(case):
    oracle, avals, (shape, dtype) = META[case]
    out = oracle(*(torch.empty(s, dtype=d, device="meta") for s, d in avals))
    assert out.device.type == "meta" and tuple(out.shape) == shape and out.dtype == dtype
    assert tapi.get_kernel(case.split("-")[0]).oracle is oracle
