"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU with the CUDA toolkit (the kernels are built
at first use); without one they skip.  Run them on a card with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` holds the same kernels against their plain versions at the
RESNET18 shapes; these tests cover the edges at small sizes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import api as tapi  # noqa: E402
from repro_torch.kernels import conv, ewise  # noqa: E402
from repro_torch.models import resnet as tres  # noqa: E402

pytestmark = pytest.mark.cuda

I32_MIN, I32_MAX = -(2**31), 2**31 - 1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    return torch.device("cuda", 0)


def ints(shape, lo, hi, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(lo, hi, shape).astype(np.int32))


def floats(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


GEMM = {
    "tile-aligned": lambda: (ints((128, 64), -8, 8, 1), ints((64, 128), -4, 4, 2)),
    "ragged-K27-N1000": lambda: (ints((1000, 27), -8, 8, 3), ints((27, 1000), -4, 4, 4)),
    "ragged-M77-K4608": lambda: (ints((77, 4608), -1000, 1000, 5), ints((4608, 130), -4, 4, 6)),
    "int32-wrap": lambda: (ints((65, 300), I32_MIN, I32_MAX, 7), ints((300, 33), I32_MIN, I32_MAX, 8)),
    "one-row": lambda: (ints((1, 512), -100, 100, 9), ints((512, 1000), -4, 4, 10)),
}


@pytest.mark.parametrize("case", sorted(GEMM))
def test_gemm_kernel_matches_plain(card, case):
    a, b = GEMM[case]()
    tapi.reset_launch_counts()
    got = conv._gemm(a.to(card), b.to(card))
    torch.cuda.synchronize()
    assert tapi.launch_counts() == {"gemm": 1}
    assert torch.equal(got.cpu(), conv._gemm_plain(a, b))


def test_gemm_kernel_float32_within_tolerance(card):
    a, b = floats((129, 200), 11), floats((200, 130), 12)
    got = conv._gemm(a.to(card), b.to(card)).cpu()
    torch.testing.assert_close(got, a @ b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("k", [1, 4, 16, 49, 100])
def test_pool_kernel_matches_plain(card, op, k):
    p = ints((1000, k), I32_MIN, I32_MAX, k) if op == "max" or k == 49 else ints((1000, k), -50, 10, k)
    got = conv._pool_rows(p.to(card), op)
    assert torch.equal(got.cpu(), conv._pool_rows_plain(p, op))
    f = floats((333, k), k + 1)
    got = conv._pool_rows(f.to(card), op).cpu()
    torch.testing.assert_close(got, conv._pool_rows_plain(f, op), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("n", [1, 255, 1000003])
def test_ewise_kernels_match_plain(card, n):
    x, y = ints((n,), I32_MIN, I32_MAX, n), ints((n,), I32_MIN, I32_MAX, n + 1)
    assert torch.equal(ewise._ewise("add", x.to(card), y.to(card)).cpu(), x + y)
    assert torch.equal(ewise._ewise("relu", x.to(card)).cpu(), ewise._ewise_plain("relu", x))
    f = floats((n,), n + 2)
    assert torch.equal(ewise._ewise("relu", f.to(card)).cpu(), ewise._ewise_plain("relu", f))


def test_card_refuses_dtypes_the_kernels_do_not_take(card):
    with pytest.raises(TypeError, match="int32 or float32"):
        ewise._ewise("relu", torch.zeros(4, dtype=torch.int64, device=card))


@pytest.mark.parametrize("cfg", [tres.TINY, tres.RESNET18], ids=["TINY", "RESNET18"])
def test_resnet_on_card_equals_cpu_and_counts_launches(card, cfg):
    params = tres.init_params(cfg, device="cpu")
    x = tres.make_input(cfg, 2, device="cpu")
    model = tres.ResNet(cfg, params, device=card)
    tapi.reset_launch_counts()
    got = model(x.to(card))
    torch.cuda.synchronize()
    counts = tapi.launch_counts()
    assert torch.equal(got.cpu(), tres.forward(cfg, params, x))
    names = tres.layer_names(cfg)
    assert counts.get("gemm", 0) == names.count("conv2d") + names.count("int_matmul")
    assert counts.get("relu", 0) == names.count("relu")
    assert counts.get("ewise_add", 0) == names.count("ewise_add")
    assert counts.get("pool_max", 0) == names.count("maxpool2d")
