"""The PyTorch port's kernels (``repro_torch.kernels``) against the JAX package.

Inputs are drawn with numpy from fixed seeds and handed to both packages.
Each registry kernel of the port runs on CPU tensors — its glue plus the
plain version of its CUDA kernel — and is held against the JAX Pallas body
run under ``use_backend("interpret")``; the port's oracles are held against
the JAX oracles (``"xla"``).  Integer results must be bit-exact (int32 wrap
and negative floor-divides included); float32 results within the JAX kernel
tests' tolerance (atol = rtol = 1e-4), since sums run in another order.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import api as japi  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import api as tapi  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

I32_MIN, I32_MAX = -(2**31), 2**31 - 1
TOL = dict(atol=1e-4, rtol=1e-4)


def ints(shape, lo, hi, seed, dtype=np.int32):
    return np.random.default_rng(seed).integers(lo, hi, shape, endpoint=False).astype(dtype)


def floats(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# name → (registry kernel, operands, kwargs)
CASES = {
    "conv2d-s1p1": ("conv2d", lambda: (ints((2, 4, 9, 9), -8, 8, 1), ints((8, 4, 3, 3), -4, 4, 2)),
                    dict(stride=1, padding=1)),
    "conv2d-s2p1-ragged": ("conv2d", lambda: (ints((1, 3, 11, 7), -8, 8, 3), ints((5, 3, 3, 3), -4, 4, 4)),
                           dict(stride=2, padding=1)),
    "conv2d-1x1-projection": ("conv2d", lambda: (ints((2, 6, 8, 8), -100, 100, 5), ints((4, 6, 1, 1), -4, 4, 6)),
                              dict(stride=2, padding=0)),
    "conv2d-int32-wrap": ("conv2d", lambda: (ints((1, 4, 6, 6), -2**30, 2**30, 7),
                                             ints((3, 4, 3, 3), -2**12, 2**12, 8)),
                          dict(stride=1, padding=1, x_bits=32, w_bits=13)),
    "conv2d-int8-operands": ("conv2d", lambda: (ints((1, 2, 5, 5), -100, 100, 9, np.int8),
                                                ints((3, 2, 3, 3), -100, 100, 10, np.int8)),
                             dict(stride=1, padding=1)),
    "conv2d-float32": ("conv2d", lambda: (floats((2, 3, 8, 8), 11), floats((5, 3, 3, 3), 12)),
                       dict(stride=1, padding=1)),
    "int_matmul-ragged-K27-N1000": ("int_matmul", lambda: (ints((37, 27), -8, 8, 13), ints((27, 1000), -4, 4, 14)),
                                    dict()),
    "int_matmul-int32-wrap": ("int_matmul", lambda: (ints((16, 64), -2**30, 2**30, 15),
                                                     ints((64, 24), -2**16, 2**16, 16)),
                              dict(x_bits=31, w_bits=17)),
    "int_matmul-int8-operands": ("int_matmul", lambda: (ints((10, 20), -128, 128, 17, np.int8),
                                                        ints((20, 12), -128, 128, 18, np.int8)), dict()),
    "maxpool2d-int32": ("maxpool2d", lambda: (ints((2, 3, 8, 8), -50, 10, 19),), dict(window=2)),
    "maxpool2d-overlapping-3s2": ("maxpool2d", lambda: (ints((1, 2, 9, 9), -100, 100, 20),),
                                  dict(window=3, stride=2)),
    "maxpool2d-int32-full-range": ("maxpool2d", lambda: (ints((1, 2, 4, 6), I32_MIN, I32_MAX, 21),),
                                   dict(window=2)),
    "maxpool2d-float32": ("maxpool2d", lambda: (floats((2, 3, 6, 6), 22),), dict(window=2)),
    "avgpool2d-negative-floor": ("avgpool2d", lambda: (ints((2, 3, 8, 8), -50, 10, 23),), dict(window=2)),
    "avgpool2d-int32-wrap": ("avgpool2d", lambda: (ints((1, 2, 4, 4), I32_MIN, I32_MAX, 24),), dict(window=2)),
    "avgpool2d-float32": ("avgpool2d", lambda: (floats((2, 3, 6, 6), 25),), dict(window=2)),
    "global_avgpool-negative-floor": ("global_avgpool", lambda: (ints((2, 8, 4, 4), -100, 20, 26),), dict()),
    "global_avgpool-3x5-window": ("global_avgpool", lambda: (ints((2, 3, 3, 5), -100, 100, 27),), dict()),
    "global_avgpool-int32-wrap": ("global_avgpool", lambda: (ints((1, 4, 4, 4), I32_MIN, I32_MAX, 28),), dict()),
    "global_avgpool-float32": ("global_avgpool", lambda: (floats((2, 4, 4, 4), 29),), dict()),
    "ewise_add-int32-wrap": ("ewise_add", lambda: (ints((64, 33), I32_MIN, I32_MAX, 30),
                                                   ints((64, 33), I32_MIN, I32_MAX, 31)), dict()),
    "ewise_add-cast-int8-y": ("ewise_add", lambda: (ints((5, 7), -1000, 1000, 32),
                                                    ints((5, 7), -128, 128, 33, np.int8)), dict()),
    "ewise_add-float32": ("ewise_add", lambda: (floats((64, 128), 34), floats((64, 128), 35)), dict()),
    "relu-int32": ("relu", lambda: (ints((3, 5, 7), I32_MIN, I32_MAX, 36),), dict()),
    "relu-float32": ("relu", lambda: (floats((64, 128), 37),), dict()),
}


def _compare(want, got):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    assert str(got.dtype) == str(want.dtype), (got.dtype, want.dtype)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_jax_pallas_body(case):
    """The port's registry kernel on CPU tensors (glue + the CUDA kernel's
    plain version) equals the JAX Pallas body run in interpret mode."""
    name, make, kwargs = CASES[case]
    args = make()
    with japi.use_backend("interpret"):
        want = getattr(japi, name)(*map(jnp.asarray, args), **kwargs)
    got = getattr(tapi, name)(*map(torch.from_numpy, args), **kwargs)
    _compare(want, got)


@pytest.mark.parametrize("case", sorted(CASES))
def test_oracle_matches_jax_oracle(case):
    name, make, kwargs = CASES[case]
    args = make()
    with japi.use_backend("xla"):
        want = getattr(japi, name)(*map(jnp.asarray, args), **kwargs)
    got = tapi.get_kernel(name).oracle(*map(torch.from_numpy, args), **kwargs)
    _compare(want, got)


@pytest.mark.parametrize("kh,stride,padding", [(3, 1, 1), (3, 2, 1), (1, 2, 0), (2, 2, 0)])
def test_im2col_matches_jax(kh, stride, padding):
    x = ints((2, 3, 7, 9), -100, 100, 40)
    want = jref.im2col(jnp.asarray(x), kh, kh, stride, padding)
    _compare(want, tref.im2col(torch.from_numpy(x), kh, kh, stride, padding))


@pytest.mark.parametrize("window,stride", [(2, 2), (3, 2), (3, 1)])
def test_pool_patches_matches_jax(window, stride):
    x = ints((2, 3, 7, 8), -100, 100, 41)
    want = jref.pool_patches(jnp.asarray(x), window, stride)
    _compare(want, tref.pool_patches(torch.from_numpy(x), window, stride))


@pytest.mark.parametrize("count", [4, 9, 16])
def test_pool_mean_floors_integers_like_jax(count):
    s = ints((257,), -1000, 1000, 42)
    _compare(jref._pool_mean(jnp.asarray(s), count), tref._pool_mean(torch.from_numpy(s), count))
    f = floats((257,), 43)
    _compare(jref._pool_mean(jnp.asarray(f), count), tref._pool_mean(torch.from_numpy(f), count))


def test_registry_holds_the_seven_network_kernels():
    """The port registers every kernel the JAX package does, name for name
    (the seven network kernels among them), each with an implementation and
    an oracle."""
    names = set(tapi.registered_kernels())
    assert {"conv2d", "int_matmul", "maxpool2d", "avgpool2d", "global_avgpool",
            "ewise_add", "relu"} <= names
    assert names == set(japi.registered_kernels())
    for kd in tapi.registered_kernels().values():
        assert callable(kd.impl) and callable(kd.oracle)
    with pytest.raises(KeyError, match="no kernel"):
        tapi.get_kernel("no_such_kernel")


def test_cpu_path_launches_no_kernel():
    tapi.reset_launch_counts()
    x = torch.from_numpy(ints((1, 2, 4, 4), -5, 5, 44))
    tapi.global_avgpool(tapi.relu(tapi.ewise_add(x, x)))
    tapi.conv2d(x, torch.from_numpy(ints((2, 2, 3, 3), -2, 2, 45)), padding=1)
    assert tapi.launch_counts() == {}


def test_launch_counter_counts_and_resets():
    tapi.reset_launch_counts()
    tapi.count_launch("gemm")
    tapi.count_launch("gemm")
    tapi.count_launch("relu")
    assert tapi.launch_counts() == {"gemm": 2, "relu": 1}
    tapi.reset_launch_counts()
    assert tapi.launch_counts() == {}


def test_dispatch_refuses_mixed_and_foreign_devices():
    x = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="cuda' or 'cpu"):
        tapi.relu(torch.zeros((2, 2), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="different devices"):
        tapi.ewise_add(x, torch.zeros((2, 2), dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("dtype,ok", [(torch.int32, True), (torch.float32, True),
                                      (torch.int64, False), (torch.float64, False),
                                      (torch.int8, False)])
def test_card_wrappers_take_int32_and_float32_only(dtype, ok):
    t = torch.zeros((3, 4), dtype=dtype)
    if ok:
        assert _build.entry_suffix(t, t) in ("i32", "f32")
    else:
        with pytest.raises(TypeError, match="int32 or float32"):
            _build.entry_suffix(t)
    with pytest.raises(TypeError):
        _build.entry_suffix(torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.float32))


def test_every_entry_point_is_declared_in_its_source():
    """Each C entry point the wrappers call exists in its ``.cu`` file with
    as many parameters as its ctypes signature declares."""
    for name, (source, argtypes) in _build.ENTRY_POINTS.items():
        text = (_build.CSRC / f"{source}.cu").read_text()
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
        assert m, f"{name} not found in {source}.cu"
        assert len(m.group(1).split(",")) == len(argtypes), name
    assert set(_build.SOURCES) == {p.stem for p in _build.CSRC.glob("*.cu")}


def test_build_targets_hopper_into_the_build_directory():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags and "-fPIC" in flags
    for src in _build.SOURCES:
        path = _build.library_path(src)
        assert path.parent == _build.BUILD_DIR and path.parts[-3:-1] == ("build", "repro_torch")
        assert path == _build.library_path(src)  # the hash is stable
