"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU with the CUDA toolkit (the kernels are built
at first use); without one they skip.  Run them on a card with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` holds the same kernels against their plain versions at the
main paths' shapes; these tests cover the edges at small sizes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import api as tapi  # noqa: E402
from repro_torch.kernels import attention as tatt  # noqa: E402
from repro_torch.kernels import bitslice_matmul as tbm  # noqa: E402
from repro_torch.kernels import conv, ewise  # noqa: E402
from repro_torch.kernels import htree_reduce as tht  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rglru_scan as trg  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import resnet as tres  # noqa: E402
from repro_torch.serve import pimsab_step as tps  # noqa: E402

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


POOL_K = [1, 2, 3, 4, 5, 8, 15, 16, 17, 32, 33, 49, 100, 1000]


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("k", POOL_K)
def test_pool_kernel_matches_plain(card, op, k):
    # 1000 and 333 rows: not a multiple of any lane group's rows per block
    p = ints((1000, k), I32_MIN, I32_MAX, k) if op == "max" or k == 49 else ints((1000, k), -50, 10, k)
    got = conv._pool_rows(p.to(card), op)
    assert torch.equal(got.cpu(), conv._pool_rows_plain(p, op))
    f = floats((333, k), k + 1)
    got = conv._pool_rows(f.to(card), op).cpu()
    torch.testing.assert_close(got, conv._pool_rows_plain(f, op), atol=1e-4, rtol=1e-4)


def on_card_at(t, dev, offset):
    """A copy of ``t`` on the card ``offset`` elements past a fresh
    allocation's (16-byte aligned) start."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=dev)
    return buf[offset:].view(t.shape).copy_(t)


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("k", [4, 16, 100])
def test_pool_kernel_reads_a_misaligned_view(card, op, k):
    """A window matrix 4 bytes past a 16-byte boundary takes element loads."""
    p = ints((777, k), I32_MIN, I32_MAX, 100 + k)
    view = on_card_at(p, card, 1)
    assert not conv.pool_plan(777, k, view.data_ptr())[1]
    assert torch.equal(conv._pool_rows(view, op).cpu(), conv._pool_rows_plain(p, op))


@pytest.mark.parametrize("k", [4, 16, 17])
def test_pool_kernel_int32_and_nan_edges(card, k):
    """Sums that wrap past INT32_MAX, rows of INT32_MIN for max, and float
    rows holding NaN."""
    p = torch.full((300, k), I32_MAX, dtype=torch.int32)
    p[::3] = I32_MIN
    for op in ("sum", "max"):
        assert torch.equal(conv._pool_rows(p.to(card), op).cpu(), conv._pool_rows_plain(p, op))
    f = floats((300, k), 7 + k)
    f[5, k // 2] = float("nan")
    f[17, :] = float("nan")
    for op in ("sum", "max"):
        got, want = conv._pool_rows(f.to(card), op).cpu(), conv._pool_rows_plain(f, op)
        assert torch.equal(got.isnan(), want.isnan()) and got.isnan().sum() == 2
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4, equal_nan=True)


@pytest.mark.parametrize("n", [1, 3, 4, 5, 255, 1000003])
def test_ewise_kernels_match_plain(card, n):
    x, y = ints((n,), I32_MIN, I32_MAX, n), ints((n,), I32_MIN, I32_MAX, n + 1)
    assert torch.equal(ewise._ewise("add", x.to(card), y.to(card)).cpu(), x + y)
    assert torch.equal(ewise._ewise("relu", x.to(card)).cpu(), ewise._ewise_plain("relu", x))
    f = floats((n,), n + 2)
    f[n // 2] = float("nan")
    assert torch.equal(ewise._ewise("relu", f.to(card)).cpu().isnan(), f.isnan())
    assert torch.equal(ewise._ewise("relu", f.to(card)).cpu().nan_to_num(), ewise._ewise_plain("relu", f).nan_to_num())


@pytest.mark.parametrize("n", [5, 1000003])
def test_ewise_kernels_read_misaligned_views(card, n):
    """``x[1:]``-style views, 4 bytes past a 16-byte boundary: one operand
    off, and operands and result all off, take the scalar kernel."""
    x, y = ints((n,), I32_MIN, I32_MAX, 3 * n), ints((n,), I32_MIN, I32_MAX, 3 * n + 1)
    xv, yv = on_card_at(x, card, 1), on_card_at(y, card, 1)
    assert torch.equal(ewise._ewise("add", xv, y.to(card)).cpu(), x + y)
    assert torch.equal(ewise._ewise("relu", xv).cpu(), ewise._ewise_plain("relu", x))
    out = on_card_at(torch.zeros(n, dtype=torch.int32), card, 1)
    vec, blocks = ewise.ewise_plan(n, [xv.data_ptr(), yv.data_ptr(), out.data_ptr()])
    assert not vec
    _build.launch("ewise_add_i32", card, xv.data_ptr(), yv.data_ptr(), out.data_ptr(), n, 0, blocks)
    assert torch.equal(out.cpu(), x + y)
    _build.launch("relu_i32", card, xv.data_ptr(), out.data_ptr(), n, 0, blocks)
    assert torch.equal(out.cpu(), ewise._ewise_plain("relu", x))


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_ewise_kernels_keep_channels_last_operands(card, dtype):
    """Channels-last operands (as ``conv2d`` returns them) are read where
    they lie: the result keeps their strides and equals the plain version."""
    make = (lambda s, seed: ints(s, I32_MIN, I32_MAX, seed)) if dtype == "int32" else floats
    x, y = make((4, 24, 7, 5), 31), make((4, 24, 7, 5), 32)
    xc, yc = (t.to(card).contiguous(memory_format=torch.channels_last) for t in (x, y))
    for op, args, want in (("add", (xc, yc), x + y), ("relu", (xc,), ewise._ewise_plain("relu", x))):
        got = ewise._ewise(op, *args)
        assert got.stride() == xc.stride() and torch.equal(got.cpu(), want)
    # a channels-last operand with a contiguous one: copied, and still right
    for a, b in ((xc, y.to(card)), (x.to(card), yc)):
        assert torch.equal(ewise._ewise("add", a, b).cpu(), x + y)


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


def stacks(sx, m, k, sw, n, slice_bits, seed):
    half = 1 << (slice_bits - 1)
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(-half, half, (sx, m, k)).astype(np.int8)),
            torch.from_numpy(rng.integers(-half, half, (sw, k, n)).astype(np.int8)))


# name → (sx, m, k, sw, n, slice_bits, skip)
BITSLICE = {
    "sb8-one-pair-tile-aligned": (1, 256, 128, 1, 64, 8, ()),
    "sb8-narrow-N32": (2, 300, 64, 2, 32, 8, ()),
    "sb8-ragged-M77-K27-N70": (2, 77, 27, 2, 70, 8, ()),
    "sb8-ragged-K-odd-N31": (2, 129, 1001, 1, 31, 8, ()),
    "sb8-shift48-4x4": (4, 65, 40, 4, 66, 8, ()),
    "sb8-skip": (2, 64, 64, 3, 64, 8, ((0, 1), (1, 2))),
    "sb8-all-skipped": (2, 32, 32, 2, 32, 8, ((0, 0), (0, 1), (1, 0), (1, 1))),
    "sb4-shift-up-to-40": (6, 50, 33, 5, 40, 4, ()),
    "sb1-shift-up-to-37": (20, 40, 24, 18, 33, 1, ()),
    "sb1-32x32-slices-1024-pairs": (32, 17, 8, 32, 9, 1, ()),
}


@pytest.mark.parametrize("case", sorted(BITSLICE))
def test_bitslice_kernel_matches_plain(card, case):
    sx, m, k, sw, n, sb, skip = BITSLICE[case]
    x, w = stacks(sx, m, k, sw, n, sb, len(case))
    pairs = tapi.active_pairs(sx, sw, skip)
    tapi.reset_launch_counts()
    got = tbm._bitslice_gemm(x.to(card), w.to(card), sb, pairs)
    torch.cuda.synchronize()
    assert tapi.launch_counts() == {"bitslice_matmul": 1}
    assert set(tbm.launched_pairs()) == set(pairs) and not set(skip) & set(tbm.launched_pairs())
    assert torch.equal(got.cpu(), tbm._bitslice_plain(x, w, sb, pairs))


def test_bitslice_kernel_reads_unaligned_stacks(card):
    x, w = stacks(3, 50, 64, 1, 40, 8, 3)
    xs = x.to(card).reshape(-1)
    buf = torch.empty(xs.numel() + 1, dtype=torch.int8, device=card)
    buf[1:] = xs
    shifted = buf[1:].view(3, 50, 64)  # K % 4 == 0, but the stack is 1-byte aligned
    got = tbm._bitslice_gemm(shifted, w.to(card), 8, tapi.active_pairs(3, 1))
    assert torch.equal(got.cpu(), tbm._bitslice_plain(x, w, 8, tapi.active_pairs(3, 1)))


def test_bitslice_kernel_refuses_what_it_does_not_take(card):
    x, w = stacks(1, 4, 4, 1, 4, 8, 4)
    with pytest.raises(TypeError, match="int8 slice stacks"):
        tbm._bitslice_gemm(x.to(card).to(torch.int32), w.to(card), 8, ((0, 0),))
    with pytest.raises(ValueError, match="at most"):
        tbm._bitslice_gemm(torch.zeros((65, 4, 4), dtype=torch.int8, device=card), w.to(card),
                           1, ((0, 0),))


@pytest.mark.parametrize("preset", ["int4", "int8", "int16", "w8a16"])
def test_quantized_matmul_on_card_equals_cpu(card, preset):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 70, 96)).astype(np.float32))
    w_q = torch.from_numpy(rng.integers(-100, 100, (96, 40)).astype(np.int32))
    w_scale = torch.from_numpy((rng.random(40) * 0.01 + 1e-3).astype(np.float32))
    spec = getattr(tapi.PrecisionSpec, preset)
    tapi.reset_launch_counts()
    got = tapi.quantized_matmul(x.to(card), w_q.to(card), w_scale.to(card), spec)
    torch.cuda.synchronize()
    assert tapi.launch_counts() == {"bitslice_matmul": 1}
    assert torch.equal(got.cpu(), tapi.quantized_matmul(x, w_q, w_scale, spec))


def test_zero_slice_ids_on_card_match_cpu(card):
    x = torch.from_numpy(np.random.default_rng(6).integers(-100, 100, (64, 48)).astype(np.int32))
    st_cpu, st_card = tapi.SlicedTensor.from_int(x, 24), tapi.SlicedTensor.from_int(x.to(card), 24)
    assert st_card.zero_slices == st_cpu.zero_slices == (1, 2)


@pytest.mark.parametrize("spec", ["int8", "w8a16"])
def test_quant_linear_relu_on_card_equals_cpu(card, spec):
    rng = np.random.default_rng(7)
    w = torch.from_numpy((rng.standard_normal((96, 72)) * 0.1).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 33, 96)).astype(np.float32))
    p = tcommon.quantize_weight(w, 8)
    pc = {k: v.to(card) for k, v in p.items()}
    tapi.reset_launch_counts()
    got = tcommon.quant_linear_relu(pc, x.to(card), getattr(tapi.PrecisionSpec, spec))
    torch.cuda.synchronize()
    assert tapi.launch_counts() == {"bitslice_matmul": 1, "relu": 1}
    assert torch.equal(got.cpu(), tcommon.quant_linear_relu(p, x, getattr(tapi.PrecisionSpec, spec)))


@pytest.mark.parametrize("shape", [(5, 7, 3), (40, 96, 72), (17, 8, 8)])
def test_common_int_matmul_on_card_equals_cpu(card, shape):
    m, k, n = shape
    rng = np.random.default_rng(m)
    x = torch.from_numpy(rng.integers(-128, 128, (2, m, k)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8))
    tapi.reset_launch_counts()
    got = tcommon.int_matmul(x.to(card), w.to(card))
    assert tapi.launch_counts() == {"bitslice_matmul": 1}
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), tcommon.int_matmul(x, w))


@pytest.mark.parametrize("spec", ["int8", "int4"])
def test_single_pass_quant_linear_on_card_equals_cpu(card, spec):
    rng = np.random.default_rng(8)
    p = tcommon.quantize_weight(torch.from_numpy((rng.standard_normal((64, 40)) * 0.1).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((3, 50, 64)).astype(np.float32))
    got = tcommon.quant_linear({k: v.to(card) for k, v in p.items()}, x.to(card),
                               getattr(tapi.PrecisionSpec, spec))
    assert torch.equal(got.cpu(), tcommon.quant_linear(p, x, getattr(tapi.PrecisionSpec, spec)))


def test_traced_resnet_on_card_equals_eager_and_counts_launches(card):
    cfg = tres.TINY
    params = tres.init_params(cfg, device="cpu")
    x = tres.make_input(cfg, 2, device="cpu")
    model = tres.ResNet(cfg, params, device=card)
    traced = tapi.trace(lambda p, v: tres.forward(cfg, p, v), name="tiny_card")
    tapi.reset_launch_counts()
    got = traced(model.params(), x.to(card))
    torch.cuda.synchronize()
    counts = tapi.launch_counts()
    assert torch.equal(got.cpu(), tres.forward(cfg, params, x))
    names = tres.layer_names(cfg)
    assert counts.get("gemm", 0) == names.count("conv2d") + names.count("int_matmul")
    assert counts.get("relu", 0) == names.count("relu")


def i8(shape, seed, lo=-128, hi=128):
    return torch.from_numpy(np.random.default_rng(seed).integers(lo, hi, shape).astype(np.int8))


# name → (q, k) makers
QK = {
    "int8-one-query-T32768": lambda: (i8((1, 64), 1), i8((32768, 64), 2)),
    "int8-gqa-7": lambda: (i8((7, 64), 3), i8((4096, 64), 4)),
    "int8-9-queries-two-groups": lambda: (i8((9, 64), 5), i8((1000, 64), 6)),
    "int8-D12-generic": lambda: (i8((3, 12), 7), i8((333, 12), 8)),
    "int8-D5-generic": lambda: (i8((2, 5), 9), i8((100, 5), 10)),
    "int32-wrap": lambda: (ints((3, 32), I32_MIN, I32_MAX, 11), ints((500, 32), I32_MIN, I32_MAX, 12)),
    "int8-q-int32-k": lambda: (i8((2, 16), 13), ints((70, 16), -2**20, 2**20, 14)),
}


@pytest.mark.parametrize("case", sorted(QK))
def test_qk_kernel_matches_plain(card, case):
    q, k = QK[case]()
    tapi.reset_launch_counts()
    got = tatt._qk(q.to(card), k.to(card))
    torch.cuda.synchronize()
    assert tapi.launch_counts() == {"attention_qk": 1}
    assert torch.equal(got.cpu(), tatt._qk_plain(q, k))


def test_qk_kernel_reads_an_unaligned_cache(card):
    q, k = i8((2, 64), 15), i8((200, 64), 16)
    buf = torch.empty(k.numel() + 1, dtype=torch.int8, device=card)
    buf[1:] = k.to(card).reshape(-1)
    got = tatt._qk(q.to(card), buf[1:].view(200, 64))
    assert torch.equal(got.cpu(), tatt._qk_plain(q, k))


# name → (scores, in_frac)
SOFTMAX = {
    "gqa-7-T32768-frac13": lambda: (tatt._qk_plain(i8((7, 64), 17), i8((32768, 64), 18)), 13),
    "equal-row-131072": lambda: (torch.zeros((1, 131072), dtype=torch.int32), 13),
    "in_frac-3": lambda: (ints((3, 1000), -50, 50, 19), 3),
    "in_frac-28": lambda: (ints((2, 500), -2**30, 2**30, 20), 28),
    "full-range": lambda: (ints((4, 777), I32_MIN, I32_MAX, 21), 10),
    "int8-rows": lambda: (i8((5, 300), 22), 5),
}


@pytest.mark.parametrize("case", sorted(SOFTMAX))
def test_softmax_kernel_matches_plain(card, case):
    x, in_frac = SOFTMAX[case]()
    sigma = tref.softmax_sigma(in_frac)
    tapi.reset_launch_counts()
    got = tatt._softmax(x.to(card), sigma)
    torch.cuda.synchronize()
    assert tapi.launch_counts() == {"softmax_fixedpoint": 1}
    want = tatt._softmax_plain(x, sigma)
    assert torch.equal(got.cpu(), want)
    if case == "equal-row-131072":
        assert not want.any()  # the oracle's exact divide, not the Pallas body's 64


# name → (p, v, shift)
PV = {
    "gqa-7-T32768-shift6": lambda: (ints((7, 32768), 0, 64, 23), i8((32768, 64), 24), 6),
    "one-query-T4096": lambda: (ints((1, 4096), 0, 64, 25), i8((4096, 64), 26), 6),
    "negative-shift40": lambda: (ints((3, 300), -1000, 1000, 27), ints((300, 5), -1000, 1000, 28), 40),
    "negative-shift-minus1": lambda: (ints((2, 50), -1000, 1000, 29), ints((50, 3), -1000, 1000, 30), -1),
    "int32-wrap-shift31": lambda: (ints((2, 600), I32_MIN, I32_MAX, 31), ints((600, 6), I32_MIN, I32_MAX, 32), 31),
    "int8-p-T-ragged": lambda: (i8((2, 513), 33), i8((513, 7), 34), 0),
}


@pytest.mark.parametrize("case", sorted(PV))
def test_pv_kernel_matches_plain(card, case):
    p, v, shift = PV[case]()
    tapi.reset_launch_counts()
    got = tatt._pv(p.to(card), v.to(card), shift)
    torch.cuda.synchronize()
    assert tapi.launch_counts() == {"attention_pv": 1}
    assert torch.equal(got.cpu(), tatt._pv_plain(p, v, shift))


def _selector(t, rows, dtype):
    s = torch.zeros(t, dtype=dtype)
    s[list(rows)] = 1 if dtype == torch.bool else 3
    return s


# name → (cache, new, selector)
KV = {
    "int8-T32768-one-hot": lambda: (i8((32768, 64), 35), i8((64,), 36), _selector(32768, [5000], torch.int8)),
    "int8-T32768-all-zero": lambda: (i8((32768, 64), 37), i8((64,), 38), _selector(32768, [], torch.int8)),
    "int8-T32768-two-hot": lambda: (i8((32768, 64), 39), i8((64,), 40), _selector(32768, [0, 32767], torch.int8)),
    "int32-cache": lambda: (ints((1000, 64), I32_MIN, I32_MAX, 41), ints((64,), I32_MIN, I32_MAX, 42),
                            _selector(1000, [999], torch.int8)),
    "int8-cache-int32-row": lambda: (i8((100, 64), 43), ints((64,), I32_MIN, I32_MAX, 44),
                                     _selector(100, [7, 8], torch.int32)),
    "int8-D5-bool-selector": lambda: (i8((50, 5), 45), i8((5,), 46), _selector(50, [4], torch.bool)),
}


@pytest.mark.parametrize("case", sorted(KV))
def test_kv_append_kernel_matches_plain(card, case):
    cache, new, sel = KV[case]()
    dev_cache = cache.to(card)
    tapi.reset_launch_counts()
    got = tatt._kv_append(dev_cache, new.to(card), sel.to(card))
    torch.cuda.synchronize()
    assert tapi.launch_counts() == {"kv_append": 1}
    assert got.dtype == cache.dtype and got.data_ptr() != dev_cache.data_ptr()
    assert torch.equal(got.cpu(), tatt._kv_append_plain(cache, new, sel))
    assert torch.equal(dev_cache.cpu(), cache)  # the input is left as it was


def test_attention_kernels_refuse_what_they_do_not_take(card):
    with pytest.raises(TypeError, match="attention kernels take"):
        tatt._qk(torch.zeros((1, 4), dtype=torch.int64, device=card), torch.zeros((3, 4), dtype=torch.int8, device=card))
    with pytest.raises(TypeError, match="attention kernels take"):
        tatt._kv_append(torch.zeros((3, 4), dtype=torch.float32, device=card),
                        torch.zeros(4, dtype=torch.int8, device=card), torch.zeros(3, dtype=torch.int8, device=card))


def test_decode_step_on_card_equals_cpu_and_counts_launches(card):
    cfg = tps.AttnServeConfig(head_dim=64, value_dim=64, kv_bits=8, q_bits=8, score_bits=22, score_frac=13)
    cap = 4096
    kc, vc, q = i8((cap, 64), 47), i8((cap, 64), 48), i8((1, 64), 49)
    k_new, v_new = i8((64,), 50), i8((64,), 51)
    onehot = _selector(cap, [100], torch.int8)
    ex = tapi.compile(tps.decode_program(cfg, cap))
    args = (kc, vc, q, k_new, v_new, onehot)
    tapi.reset_launch_counts()
    got = ex(*(a.to(card) for a in args))
    torch.cuda.synchronize()
    assert tapi.launch_counts() == {"kv_append": 2, "attention_qk": 1, "softmax_fixedpoint": 1, "attention_pv": 1}
    assert torch.equal(got.cpu(), ex(*args))


def test_decode_layer_on_card_equals_cpu_and_counts_launches(card):
    prog = tps.decode_layer_program(896, 64, 4864, 1024, q_bits=8, kv_bits=8, score_bits=22, score_frac=13,
                                    w_bits=8)
    args = (i8((1024, 64), 52), i8((1024, 64), 53), i8((1, 64), 54), i8((64, 896), 55),
            i8((896, 4864), 56), i8((4864, 896), 57))
    ex = tapi.compile(prog)
    tapi.reset_launch_counts()
    got = ex(*(a.to(card) for a in args))
    torch.cuda.synchronize()
    assert tapi.launch_counts() == {"attention_qk": 1, "softmax_fixedpoint": 1, "attention_pv": 1,
                                    "gemm": 3, "relu": 1}
    assert torch.equal(got.cpu(), ex(*args))


# name → (w, x) makers
GEMV = {
    "int8-qwen-down-896x4864": lambda: (i8((896, 4864), 60), i8((4864,), 61)),
    "int8-one-row": lambda: (i8((1, 896), 62), i8((896,), 63)),
    "int8-ragged-K37": lambda: (i8((300, 37), 64), i8((37,), 65)),
    "int8-K65536-x-not-staged": lambda: (i8((40, 65536), 66), i8((65536,), 67)),
    "int32-wrap": lambda: (ints((100, 64), I32_MIN, I32_MAX, 68), ints((64,), I32_MIN, I32_MAX, 69)),
    "int32-kernels-bench-512": lambda: (ints((512, 512), -1000, 1000, 70), ints((512,), -1000, 1000, 71)),
    "int32-K16384-x-not-staged": lambda: (ints((20, 16384), I32_MIN, I32_MAX, 72),
                                          ints((16384,), I32_MIN, I32_MAX, 73)),
    "int8-w-int32-x": lambda: (i8((77, 96), 74), ints((96,), -2**20, 2**20, 75)),
    "int32-w-int8-x": lambda: (ints((77, 96), -2**20, 2**20, 76), i8((96,), 77)),
    "K0": lambda: (i8((5, 0), 78), i8((0,), 79)),
}


@pytest.mark.parametrize("case", sorted(GEMV))
def test_gemv_kernel_matches_plain(card, case):
    w, x = GEMV[case]()
    tapi.reset_launch_counts()
    got = tatt._gemv(w.to(card), x.to(card))
    torch.cuda.synchronize()
    assert tapi.launch_counts() == {"decode_gemv": 1}
    assert torch.equal(got.cpu(), tatt._gemv_plain(w, x))


@pytest.mark.parametrize("k", [896, 65536])
def test_gemv_kernel_reads_misaligned_views(card, k):
    """A weight row or an activation one byte off its 16-byte alignment
    takes the element path (or stages the activation byte by byte)."""
    w, x = i8((33, k), 80), i8((k,), 81)
    wbuf = torch.empty(w.numel() + 1, dtype=torch.int8, device=card)
    wbuf[1:] = w.to(card).reshape(-1)
    xbuf = torch.empty(k + 1, dtype=torch.int8, device=card)
    xbuf[1:] = x.to(card)
    want = tatt._gemv_plain(w, x)
    assert torch.equal(tatt._gemv(wbuf[1:].view(33, k), x.to(card)).cpu(), want)
    assert torch.equal(tatt._gemv(w.to(card), xbuf[1:]).cpu(), want)


# name → (x (N, D) maker)
HTREE = {
    "float32-N256-D65536": lambda: floats((256, 65536), 82),
    "float32-N1": lambda: floats((1, 300), 83),
    "float32-N2-ragged-D": lambda: floats((2, 1000), 84),
    "float32-N8-D1": lambda: floats((8, 1), 85),
    "bfloat16-N256-D4096": lambda: floats((256, 4096), 86).to(torch.bfloat16),
    "bfloat16-N2": lambda: floats((2, 513), 87).to(torch.bfloat16),
    "int32-wrap-N256-D2048": lambda: ints((256, 2048), I32_MIN, I32_MAX, 88),
    "int32-N1": lambda: ints((1, 77), I32_MIN, I32_MAX, 89),
}


@pytest.mark.parametrize("case", sorted(HTREE))
def test_htree_kernel_matches_plain(card, case):
    x = HTREE[case]()
    tapi.reset_launch_counts()
    got = tht._htree(x.to(card))
    torch.cuda.synchronize()
    assert tapi.launch_counts() == {"htree_reduce": 1}
    want = tht._htree_plain(x)
    assert got.dtype == want.dtype and torch.equal(got.cpu(), want)


# name → (B, T, W)
RGLRU = {
    "T1": (2, 1, 5),
    "ragged-W300-T37": (2, 37, 300),
    "ragged-W513-T260": (3, 260, 513),
    "recurrentgemma-width-T2048": (1, 2048, 2560),
}


@pytest.mark.parametrize("case", sorted(RGLRU))
def test_rglru_kernel_matches_plain(card, case):
    bsz, t, w = RGLRU[case]
    a = torch.sigmoid(floats((bsz, t, w), 90))
    b, h0 = floats((bsz, t, w), 91), floats((bsz, w), 92)
    tapi.reset_launch_counts()
    got = trg._scan(a.to(card), b.to(card), h0.to(card))
    torch.cuda.synchronize()
    assert tapi.launch_counts() == {"rglru_scan": 1}
    assert torch.equal(got.cpu(), trg._scan_plain(a, b, h0))
    assert torch.allclose(got.cpu(), tref.rglru_scan_ref(a, b, h0), atol=1e-4, rtol=1e-4)


def test_gemv_htree_rglru_refuse_what_they_do_not_take(card):
    with pytest.raises(TypeError, match="htree_reduce takes"):
        tht._htree(torch.zeros((4, 8), dtype=torch.int8, device=card))
    with pytest.raises(ValueError, match="power-of-two"):
        tht._htree(torch.zeros((6, 8), dtype=torch.float32, device=card))
    with pytest.raises(TypeError, match="float32"):
        z = torch.zeros((1, 4, 3), dtype=torch.float64, device=card)
        trg._scan(z, z, torch.zeros((1, 3), dtype=torch.float64, device=card))
    with pytest.raises(TypeError, match="attention kernels take"):
        tatt._gemv(torch.zeros((3, 4), dtype=torch.int16, device=card), torch.zeros(4, dtype=torch.int8, device=card))


def test_gemv_htree_rglru_traced_on_card_equal_eager(card):
    """Each entry point through trace → compile → a held Executor launches
    its kernel once per replay and equals the eager call."""
    calls = {
        "decode_gemv": (tapi.decode_gemv, (i8((896, 896), 93), i8((896,), 94))),
        "htree_reduce": (tapi.htree_reduce, (floats((256, 512), 95).to(torch.bfloat16),)),
        "rglru_scan": (tapi.rglru_scan, (torch.sigmoid(floats((2, 64, 96), 96)), floats((2, 64, 96), 97),
                                         floats((2, 96), 98))),
    }
    for name, (fn, args) in calls.items():
        args = [a.to(card) for a in args]
        ex = tapi.compile(tapi.trace(fn, name=name).program_for(*args))
        tapi.reset_launch_counts()
        got = ex(*args)
        torch.cuda.synchronize()
        assert tapi.launch_counts() == {name: 1}
        assert torch.equal(got, fn(*args))
