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
from repro_torch.kernels import program as tprogram  # noqa: E402
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


def gemm_operand(kind, shape, seed):
    """An int32 GEMM operand: every entry INT32_MIN, -1 or INT32_MAX, or
    full-range random values."""
    if kind == "full":
        return ints(shape, I32_MIN, I32_MAX, seed)
    return torch.full(shape, {"min": I32_MIN, "minus1": -1, "max": I32_MAX}[kind], dtype=torch.int32)


def gemm_on_card(a, b, layout, card):
    """The kernel's product on the card (one launch) and its plain version."""
    tapi.reset_launch_counts()
    got = conv._gemm(a.to(card), b.to(card), layout)
    torch.cuda.synchronize()
    assert tapi.launch_counts() == {"gemm": 1}
    return got.cpu(), conv._gemm_plain(a, b, layout)


GEMM_KINDS = ["min", "minus1", "max", "full"]


@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("kinds", [(p, q) for i, p in enumerate(GEMM_KINDS) for q in GEMM_KINDS[i:]],
                         ids=lambda k: "-".join(k))
def test_gemm_kernel_int32_extremes(card, kinds, layout):
    """INT32_MIN, -1, INT32_MAX and full-range operands on both sides: every
    digit count and signedness, and sums that wrap."""
    m, k, n = 70, 100, 40
    a = gemm_operand(kinds[0], (m, k), 1)
    b = gemm_operand(kinds[1], (n, k) if layout == "nk" else (k, n), 2)
    got, want = gemm_on_card(a, b, layout, card)
    assert torch.equal(got, want)


def mixed_bytes(shape, seed):
    """Values whose byte count changes from one 32-wide K tile and 16-row
    tile to the next: 1, 2, 3 and 4 bytes."""
    rng = np.random.default_rng(seed)
    rows, cols = shape
    r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    bits = np.array([7, 15, 23, 31])[(r // 16 + c // 32) % 4]
    return torch.from_numpy(rng.integers(-(2**bits), 2**bits).astype(np.int32))


# name → (m, k, n, layout, A maker, B maker (in its layout))
GEMM_EDGES = {
    "mixed-byte-tiles-nk": (130, 200, 70, "nk", lambda s: mixed_bytes(s, 20), lambda s: mixed_bytes(s, 21)),
    "mixed-byte-tiles-kn": (130, 200, 70, "kn", lambda s: mixed_bytes(s, 22), lambda s: mixed_bytes(s, 23)),
    # all digits 255 below a top digit of 127: the largest u8 x u8 products,
    # over K past one K chunk (splits and atomics)
    "K40000-all-255-digits-tile": (40, 40000, 24, "nk", lambda s: gemm_operand("max", s, 0),
                                   lambda s: gemm_operand("max", s, 0)),
    "K40000-all-255-digits-small-M": (3, 40000, 24, "kn", lambda s: gemm_operand("max", s, 0),
                                      lambda s: gemm_operand("max", s, 0)),
    "stem-K27-nk": (2048, 27, 64, "nk", lambda s: ints(s, -8, 8, 24), lambda s: ints(s, -3, 4, 25)),
    "ragged-M129-K1001-N67-nk": (129, 1001, 67, "nk", lambda s: ints(s, I32_MIN, I32_MAX, 26),
                                 lambda s: ints(s, -3, 4, 27)),
    "ragged-M65-K33-N1000-kn": (65, 33, 1000, "kn", lambda s: ints(s, I32_MIN, I32_MAX, 28),
                                lambda s: ints(s, I32_MIN, I32_MAX, 29)),
    "stage4-split-K4608-nk": (512, 4608, 512, "nk", lambda s: ints(s, I32_MIN, I32_MAX, 30),
                              lambda s: ints(s, -3, 4, 31)),
    "head-kn": (32, 512, 1000, "kn", lambda s: ints(s, I32_MIN, I32_MAX, 32), lambda s: ints(s, -3, 4, 33)),
    "one-row-nk-tile-path": (1, 896, 300, "nk", lambda s: ints(s, I32_MIN, I32_MAX, 34),
                             lambda s: ints(s, I32_MIN, I32_MAX, 35)),
    **{f"M{m}-K4864-small-M-boundary": (m, 4864, 896, "kn", lambda s, m=m: ints(s, I32_MIN, I32_MAX, 36 + m),
                                        lambda s: ints(s, -128, 128, 60)) for m in (1, 2, 15, 16, 17)},
    "M1-ragged-N-kn": (1, 300, 1001, "kn", lambda s: ints(s, I32_MIN, I32_MAX, 61),
                       lambda s: ints(s, I32_MIN, I32_MAX, 62)),
}


@pytest.mark.parametrize("case", sorted(GEMM_EDGES))
def test_gemm_kernel_int32_edges(card, case):
    m, k, n, layout, make_a, make_b = GEMM_EDGES[case]
    a, b = make_a((m, k)), make_b((n, k) if layout == "nk" else (k, n))
    plan = conv.gemm_plan(m, n, k, layout, (0, 0))
    assert plan.path == ("small" if m <= 16 and layout == "kn" else "tile")
    got, want = gemm_on_card(a, b, layout, card)
    assert torch.equal(got, want)


def test_gemm_kernel_sums_a_whole_k_chunk_in_one_block(card):
    """Enough tiles that K is not split: one block sums GEMM_K_CHUNK rows of
    INT32_MAX (digits 255, 255, 255 and a top digit of 127) in its s32
    accumulators.  Every row of C is the same, so one row on the CPU is the
    plain version of all."""
    k = conv.GEMM_K_CHUNK
    m = conv.GEMM_TARGET_BLOCKS * conv.GEMM_TILE[0]
    a = torch.full((m, k), I32_MAX, dtype=torch.int32, device=card)
    b = torch.full((64, k), I32_MAX, dtype=torch.int32)
    plan = conv.gemm_plan(m, 64, k, "nk", (a.data_ptr(), 0))
    assert plan.path == "tile" and plan.splits == 1 and plan.k_chunk == k
    got = conv._gemm(a, b.to(card), "nk")
    want = conv._gemm_plain(a[:1].cpu(), b, "nk")
    assert torch.equal(got.cpu(), want.expand(m, 64))


@pytest.mark.parametrize("case", sorted(GEMM))
def test_gemm_kernel_reads_b_in_either_layout(card, case):
    """The five GEMM cases with B passed as (N, K), its transpose."""
    a, b = GEMM[case]()
    got, want = gemm_on_card(a, b.T.contiguous(), "nk", card)
    assert torch.equal(got, want) and torch.equal(want, conv._gemm_plain(a, b))


@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("m", [1, 100])
def test_gemm_kernel_reads_misaligned_views(card, layout, m):
    """Operands 4 bytes past a 16-byte boundary take the 4-byte copies."""
    k, n = 96, 64
    a = ints((m, k), I32_MIN, I32_MAX, 70 + m)
    b = ints((n, k) if layout == "nk" else (k, n), I32_MIN, I32_MAX, 71)
    av, bv = on_card_at(a, card, 1), on_card_at(b, card, 1)
    plan = conv.gemm_plan(m, n, k, layout, (av.data_ptr(), bv.data_ptr()))
    assert not plan.a_vec and not plan.b_vec
    assert torch.equal(conv._gemm(av, bv, layout).cpu(), conv._gemm_plain(a, b, layout))


def test_gemm_kernel_float32_reads_b_as_n_by_k(card):
    a, b = floats((129, 200), 13), floats((130, 200), 14)
    got = conv._gemm(a.to(card), b.to(card), "nk").cpu()
    torch.testing.assert_close(got, a @ b.T, atol=1e-4, rtol=1e-4)


# float32 at ragged shapes, on unsplit and split plans: the kernel within the
# float tolerance of the plain version in both layouts, exactly equal on
# integer-valued operands (every partial sum exact), the same bits twice.
# The normals are scaled by K**-0.25 so that the outputs are of unit size:
# unscaled, the order of adds alone moves a K = 4608 sum by about 1e-4.
F32_GEMM = {
    "unsplit-M129-K27-N1000": (129, 27, 1000),
    "unsplit-M300-K200-N130": (300, 200, 130),
    "split-M77-K4608-N130": (77, 4608, 130),
    "split-M2048-K2304-N256": (2048, 2304, 256),
    "split-M1000-K1001-N67": (1000, 1001, 67),
}


@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("case", sorted(F32_GEMM))
def test_gemm_kernel_float32_plans_and_layouts(card, case, layout):
    m, k, n = F32_GEMM[case]
    plan = conv.gemm_f32_plan(m, n, k, layout, (0, 0))
    assert (plan.splits > 1) == case.startswith("split")
    scale = k ** -0.25
    a, b = floats((m, k), m) * scale, floats((n, k) if layout == "nk" else (k, n), n) * scale
    ac, bc = a.to(card), b.to(card)
    tapi.reset_launch_counts()
    got = conv._gemm(ac, bc, layout)
    again = conv._gemm(ac, bc, layout)
    torch.cuda.synchronize()
    assert tapi.launch_counts() == {"gemm": 2}
    assert torch.equal(got, again)
    torch.testing.assert_close(got.cpu(), conv._gemm_plain(a, b, layout), atol=1e-4, rtol=1e-4)
    ai, bi = a.div(scale).mul(4).round(), b.div(scale).mul(2).round()
    assert torch.equal(conv._gemm(ai.to(card), bi.to(card), layout).cpu(), conv._gemm_plain(ai, bi, layout))


def test_gemm_kernel_float32_reads_a_misaligned_b(card):
    a, b = floats((100, 96), 21), floats((96, 64), 22)
    buf = torch.empty(b.numel() + 1, dtype=torch.float32, device=card)
    bv = buf[1:].view(b.shape)
    bv.copy_(b)
    assert not conv.gemm_f32_plan(100, 64, 96, "kn", (0, bv.data_ptr())).b_vec
    torch.testing.assert_close(conv._gemm(a.to(card), bv).cpu(), a @ b, atol=1e-4, rtol=1e-4)


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


# name → (sx, m, k, sw, n, skip, path): the tensor-core path at ragged M, N
# and K (K % 16 == 0 but not a multiple of its 64-byte K tile), on each tile
# and with 4-byte w copies (N % 16 != 0); the __dp4a path where K % 16 != 0,
# N % 4 != 0 or the pair set is not all pairs of its slices
BITSLICE_PATHS = {
    "mma-narrow-1x1-M130-K208-N20": (1, 130, 208, 1, 20, (), "mma"),
    "mma-narrow-2x2-M77-K48-N32": (2, 77, 48, 2, 32, (), "mma"),
    "mma-square-2x1-M77-K80-N100": (2, 77, 80, 1, 100, (), "mma"),
    "mma-square-1x2-M200-K144-N36": (1, 200, 144, 2, 36, (), "mma"),
    "mma-square-2x2-M65-K80-N132": (2, 65, 80, 2, 132, (), "mma"),
    "mma-zero-skip-M129-K64-N64": (2, 129, 64, 2, 64, ((1, 0), (1, 1)), "mma"),
    "dp4a-K40-N64": (1, 64, 40, 1, 64, (), "dp4a"),
    "dp4a-N30": (2, 64, 64, 1, 30, (), "dp4a"),
    "dp4a-3-of-4-pairs": (2, 64, 64, 2, 64, ((1, 1),), "dp4a"),
}


@pytest.mark.parametrize("case", sorted(BITSLICE_PATHS))
def test_bitslice_kernel_paths_at_ragged_shapes(card, case):
    sx, m, k, sw, n, skip, path = BITSLICE_PATHS[case]
    x, w = stacks(sx, m, k, sw, n, 8, len(case) + 40)
    pairs = tapi.active_pairs(sx, sw, skip)
    tapi.reset_launch_counts()
    got = tbm._bitslice_gemm(x.to(card), w.to(card), 8, pairs)
    torch.cuda.synchronize()
    assert tapi.launch_counts() == {"bitslice_matmul": 1} and tbm.launched_path() == path
    assert torch.equal(got.cpu(), tbm._bitslice_plain(x, w, 8, pairs))


@pytest.mark.parametrize("sx, sw", [(1, 1), (2, 2)])
def test_bitslice_mma_folds_past_the_s32_bound(card, sx, sw):
    """K = 2**17 + 32 of all -128 slices: every product is 2**14, so one
    accumulator over all of K would pass 2**31 (two pairs on the 2 × 2 middle
    diagonal sooner); the block folds at the plan's interval and the
    result wraps as the plain version's does."""
    k = 2**17 + 32
    x = torch.full((sx, 20, k), -128, dtype=torch.int8)
    w = torch.full((sw, k, 40), -128, dtype=torch.int8)
    pairs = tapi.active_pairs(sx, sw)
    xc, wc = x.to(card), w.to(card)
    plan = tbm.bitslice_plan(sx, sw, 20, 40, k, 8, pairs, (xc.data_ptr(), wc.data_ptr()))
    assert plan.path == "mma" and plan.fold_k < k
    got = tbm._bitslice_gemm(xc, wc, 8, pairs)
    torch.cuda.synchronize()
    assert tbm.launched_path() == "mma"
    assert torch.equal(got.cpu(), tbm._bitslice_plain(x, w, 8, pairs))


@pytest.mark.parametrize("offset", [1, 4])
def test_bitslice_kernel_takes_dp4a_for_a_stack_off_16_bytes(card, offset):
    x, w = stacks(2, 50, 64, 1, 40, 8, 30 + offset)
    buf = torch.empty(x.numel() + offset, dtype=torch.int8, device=card)
    shifted = buf[offset:].view(x.shape)
    shifted.copy_(x)
    pairs = tapi.active_pairs(2, 1)
    got = tbm._bitslice_gemm(shifted, w.to(card), 8, pairs)
    torch.cuda.synchronize()
    assert tbm.launched_path() == "dp4a"
    assert torch.equal(got.cpu(), tbm._bitslice_plain(x, w, 8, pairs))


@pytest.mark.parametrize("preset", ["int4", "int8", "int12", "int16", "w4a8", "w8a16"])
def test_quantized_matmul_presets_take_the_tensor_cores(card, preset):
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((2, 100, 128)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((128, 48)) * 0.1).astype(np.float32))
    spec = getattr(tapi.PrecisionSpec, preset)
    w_st = tapi.SlicedTensor.quantize(w, spec, weight=True)
    wq, ws = w_st.to_int(), w_st.scale.reshape(-1)
    got = tapi.quantized_matmul(x.to(card), wq.to(card), ws.to(card), spec)
    torch.cuda.synchronize()
    assert tbm.launched_path() == "mma"
    assert torch.equal(got.cpu(), tapi.quantized_matmul(x, wq, ws, spec))


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
    # the cluster path's edges (attention.softmax_plan)
    "one-query-T32768-frac13": lambda: (tatt._qk_plain(i8((1, 64), 120), i8((32768, 64), 121)), 13),
    "T1": lambda: (ints((1, 1), -50, 50, 122), 13),
    "T-below-a-warp": lambda: (ints((3, 20), -2**20, 2**20, 123), 13),
    "64-rows-of-T8": lambda: (ints((64, 8), -2**16, 2**16, 124), 13),
    "rows-path-widest-512": lambda: (ints((9, 512), -2**18, 2**18, 125), 13),
    "cluster-of-one-T513": lambda: (ints((3, 513), -2**18, 2**18, 126), 13),
    "cluster-ragged-T4099": lambda: (ints((3, 4099), -2**20, 2**20, 127), 13),
    "registers-full-T65536": lambda: (ints((1, 65536), -2**20, 2**20, 128), 13),
    "past-registers-T70000": lambda: (ints((2, 70000), -2**20, 2**20, 129), 13),
    "row-2^20": lambda: (ints((1, 2**20), -2**20, 2**20, 130), 13),
    "int8-long-rows": lambda: (i8((2, 32768), 131), 5),
    "int8-past-registers": lambda: (i8((1, 70000), 132), 5),
    "int8-ragged-long-row": lambda: (i8((2, 4097), 133), 5),
    "full-range-long-rows": lambda: (ints((2, 32768), I32_MIN, I32_MAX, 134), 10),
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


@pytest.mark.parametrize("dtype", [torch.int32, torch.int8])
def test_softmax_kernel_reads_a_misaligned_row(card, dtype):
    """A view 4 bytes (int32) or 1 byte (int8) off 16-byte alignment takes
    the cluster path's element loads."""
    x = ints((2, 8192), -2**20, 2**20, 135) if dtype == torch.int32 else i8((2, 8192), 136)
    buf = torch.empty(x.numel() + 1, dtype=dtype, device=card)
    buf[1:] = x.to(card).reshape(-1)
    view = buf[1:].view(2, 8192)
    assert not tatt.softmax_plan(2, 8192, view.element_size(), view.data_ptr()).vec
    sigma = tref.softmax_sigma(13)
    assert torch.equal(tatt._softmax(view, sigma).cpu(), tatt._softmax_plain(x, sigma))


# name → (p, v, shift)
PV = {
    "gqa-7-T32768-shift6": lambda: (ints((7, 32768), 0, 64, 23), i8((32768, 64), 24), 6),
    "one-query-T4096": lambda: (ints((1, 4096), 0, 64, 25), i8((4096, 64), 26), 6),
    "negative-shift40": lambda: (ints((3, 300), -1000, 1000, 27), ints((300, 5), -1000, 1000, 28), 40),
    "negative-shift-minus1": lambda: (ints((2, 50), -1000, 1000, 29), ints((50, 3), -1000, 1000, 30), -1),
    "int32-wrap-shift31": lambda: (ints((2, 600), I32_MIN, I32_MAX, 31), ints((600, 6), I32_MIN, I32_MAX, 32), 31),
    "int8-p-T-ragged": lambda: (i8((2, 513), 33), i8((513, 7), 34), 0),
    # the packed path (attention.pv_plan) and its edges
    "one-query-T32768-shift6": lambda: (ints((1, 32768), 0, 64, 140), i8((32768, 64), 141), 6),
    "two-queries-T32768": lambda: (ints((2, 32768), 0, 64, 142), i8((32768, 64), 143), 6),
    "9-queries-three-groups": lambda: (ints((9, 1000), 0, 64, 144), i8((1000, 64), 145), 6),
    "T1": lambda: (ints((1, 1), 0, 64, 146), i8((1, 64), 147), 6),
    "T-below-a-warp": lambda: (ints((2, 5), 0, 64, 148), i8((5, 64), 149), 6),
    "T-ragged-1000": lambda: (ints((1, 1000), 0, 64, 150), i8((1000, 64), 151), 6),
    "T-ragged-32767": lambda: (ints((1, 32767), 0, 64, 152), i8((32767, 64), 153), 6),
    "int32-wrap-packed-shift0": lambda: (ints((2, 3000), I32_MIN, I32_MAX, 154), i8((3000, 64), 155), 0),
    "int32-wrap-packed-shift31": lambda: (ints((2, 3000), I32_MIN, I32_MAX, 156), i8((3000, 64), 157), 31),
    "int32-wrap-packed-shift40": lambda: (ints((2, 3000), I32_MIN, I32_MAX, 158), i8((3000, 64), 159), 40),
    "Dv16-packed": lambda: (ints((3, 777), 0, 64, 160), i8((777, 16), 161), 6),
    "Dv32-packed": lambda: (ints((1, 2048), 0, 64, 162), i8((2048, 32), 163), 6),
    "Dv128-packed": lambda: (ints((5, 2048), 0, 64, 164), i8((2048, 128), 165), 6),
    "Dv256-packed": lambda: (ints((4, 999), 0, 64, 166), i8((999, 256), 167), 6),
    "Dv48-generic": lambda: (ints((2, 700), 0, 64, 168), i8((700, 48), 169), 6),
    "Dv300-generic": lambda: (ints((2, 400), 0, 64, 170), i8((400, 300), 171), 6),
    "int32-v-T32768": lambda: (ints((1, 32768), 0, 64, 172), ints((32768, 64), -2**20, 2**20, 173), 6),
    "int8-p-int8-v-Dv64": lambda: (i8((3, 4096), 174), i8((4096, 64), 175), 2),
}


@pytest.mark.parametrize("case", sorted(PV))
def test_pv_kernel_matches_plain(card, case):
    p, v, shift = PV[case]()
    tapi.reset_launch_counts()
    got = tatt._pv(p.to(card), v.to(card), shift)
    torch.cuda.synchronize()
    assert tapi.launch_counts() == {"attention_pv": 1}
    assert torch.equal(got.cpu(), tatt._pv_plain(p, v, shift))


def test_pv_kernel_reads_a_value_cache_off_by_one_byte(card):
    """A v view one byte off 16-byte alignment takes the generic kernel."""
    p, v = ints((1, 4096), 0, 64, 176), i8((4096, 64), 177)
    buf = torch.empty(v.numel() + 1, dtype=torch.int8, device=card)
    buf[1:] = v.to(card).reshape(-1)
    view = buf[1:].view(4096, 64)
    dp = p.to(card)
    assert not tatt.pv_plan(1, 4096, 64, 4, 1, (dp.data_ptr(), view.data_ptr())).packed
    assert torch.equal(tatt._pv(dp, view, 6).cpu(), tatt._pv_plain(p, v, 6))


def test_pv_ticket_returns_to_zero_between_calls_and_graph_replays(card):
    """Two calls of different shapes back to back on one stream, then three
    replays of a captured call, each equal to the plain version: every
    launch finds the device's ticket at zero and leaves it there."""
    cases = [(ints((1, 32768), 0, 64, 178), i8((32768, 64), 179)), (ints((7, 999), 0, 64, 180), i8((999, 64), 181))]
    dev_cases = [(p.to(card), v.to(card)) for p, v in cases]
    outs = [tatt._pv(p, v, 6) for p, v in dev_cases]  # no synchronize between them
    for (p, v), got in zip(cases, outs):
        assert torch.equal(got.cpu(), tatt._pv_plain(p, v, 6))
    assert int(tatt._pv_ticket(card).item()) == 0
    (p, v), (dp, dv_) = cases[0], dev_cases[0]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tatt._pv(dp, dv_, 6)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = tatt._pv(dp, dv_, 6)
    want = tatt._pv_plain(p, v, 6)
    for _ in range(3):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured.cpu(), want)
        assert int(tatt._pv_ticket(card).item()) == 0


def test_pv_call_is_one_device_kernel(card):
    """The packed path's call at the decode shape is one kernel on the
    device: no finalize pass, no memset, no copy."""
    from torch.profiler import ProfilerActivity, profile

    p, v = ints((1, 32768), 0, 64, 182).to(card), i8((32768, 64), 183).to(card)
    assert tatt.pv_plan(1, 32768, 64, 4, 1, (p.data_ptr(), v.data_ptr())).packed
    tatt._pv(p, v, 6)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tatt._pv(p, v, 6)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    kernels = [ev.name for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and "pv_packed" in kernels[0], kernels


def _selector(t, rows, dtype):
    s = torch.zeros(t, dtype=dtype)
    s[list(rows)] = 1 if dtype == torch.bool else 3
    return s


# name → (cache, new, selector, whether attention.kv_plan takes the vector
# kernel, cache off 16 bytes)
KV = {
    "int8-T32768-one-hot": lambda: (i8((32768, 64), 35), i8((64,), 36), _selector(32768, [5000], torch.int8),
                                    True, False),
    "int8-T32768-all-zero": lambda: (i8((32768, 64), 37), i8((64,), 38), _selector(32768, [], torch.int8),
                                     True, False),
    "int8-T32768-two-hot": lambda: (i8((32768, 64), 39), i8((64,), 40),
                                    _selector(32768, [0, 32767], torch.int8), True, False),
    "int32-cache": lambda: (ints((1000, 64), I32_MIN, I32_MAX, 41), ints((64,), I32_MIN, I32_MAX, 42),
                            _selector(1000, [999], torch.int8), False, False),
    "int8-cache-int32-row": lambda: (i8((100, 64), 43), ints((64,), I32_MIN, I32_MAX, 44),
                                     _selector(100, [7, 8], torch.int32), False, False),
    "int8-D5-bool-selector": lambda: (i8((50, 5), 45), i8((5,), 46), _selector(50, [4], torch.bool), False,
                                      False),
    # the vector kernel's edges: rows at the first and last row of a block
    # (64 rows at D = 64), every row, a T that is not a multiple of a block's
    # rows, D 16 and 48, an int32 selector, and a cache off 16 bytes (generic)
    "int8-block-edges": lambda: (i8((32768, 64), 184), i8((64,), 185),
                                 _selector(32768, [0, 63, 64, 127, 32704, 32767], torch.int8), True, False),
    "int8-every-row": lambda: (i8((4096, 64), 186), i8((64,), 187), _selector(4096, range(4096), torch.int8),
                               True, False),
    "int8-T-ragged-1000": lambda: (i8((1000, 64), 188), i8((64,), 189), _selector(1000, [0, 959, 960, 999],
                                                                                    torch.int8), True, False),
    "int8-D16": lambda: (i8((5000, 16), 190), i8((16,), 191), _selector(5000, [0, 255, 256, 4999], torch.int8),
                         True, False),
    "int8-D48": lambda: (i8((3000, 48), 192), i8((48,), 193), _selector(3000, [0, 84, 85, 2999], torch.int8),
                         True, False),
    "int8-int32-selector": lambda: (i8((32768, 64), 194), i8((64,), 195),
                                    _selector(32768, [1, 30000], torch.int32), True, False),
    "int8-cache-off-16-bytes": lambda: (i8((4096, 64), 196), i8((64,), 197), _selector(4096, [0, 4095], torch.int8),
                                        False, True),
}


@pytest.mark.parametrize("case", sorted(KV))
def test_kv_append_kernel_matches_plain(card, case):
    cache, new, sel, vec, off = KV[case]()
    dev_cache = on_card_at(cache, card, 1) if off else cache.to(card)
    dev_new, dev_sel = new.to(card), sel.to(card)
    plan = tatt.kv_plan(*cache.shape, cache.element_size(), new.element_size(),
                        (dev_cache.data_ptr(), dev_new.data_ptr(), 0))
    assert plan.vec == vec
    tapi.reset_launch_counts()
    got = tatt._kv_append(dev_cache, dev_new, dev_sel)
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


def _rowdot_cases():
    """name → (wrapper, a (nq, K), w (rows, K), element offsets of (a, w) on
    the card, the plan's (lanes, split) or None for the generic kernel)."""
    cases = {}
    for lanes, split in ((1, 1), (2, 1), (4, 1), (8, 1), (16, 1), (32, 1), (32, 2), (32, 4), (32, 8)):
        for nq in (1, 9):
            # split: a lane's target of chunks on every thread of the row, one
            # row past ROWDOT_TARGET_BLOCKS blocks' rows (a block's 8 warps
            # take any rows)
            target = min(tatt.ROWDOT_TARGET_ITERS, tatt.ROWDOT_XREG_CHUNKS // (1 if nq == 1 else tatt.ROWDOT_GROUP))
            span = lanes * split
            rows = 37 if split == tatt.ROWDOT_MAX_WARPS else tatt.ROWDOT_TARGET_BLOCKS * 256 // span + 3
            rows, k = (1001, 16 * lanes) if split == 1 else (rows, 16 * target * span)  # unsplit: whole rows
            kernel = "qk" if nq > 1 or split == 1 else "gemv"
            cases[f"{kernel}-lanes-{lanes}-split-{split}-M{nq}"] = lambda nq=nq, k=k, rows=rows, lanes=lanes, split=split, \
                kernel=kernel: (kernel, i8((nq, k), 200 + lanes + split), i8((rows, k), 210 + lanes + split), (0, 0),
                                (lanes, split))
    for m in range(1, 10):
        cases[f"qk-M{m}-T1001"] = lambda m=m: ("qk", i8((m, 64), 260 + m), i8((1001, 64), 270 + m), (0, 0), (4, 1))
    cases.update({
        "qk-queries-streamed": lambda: ("qk", i8((3, 16384), 280), i8((100, 16384), 281), (0, 0), (32, 8)),
        "gemv-grid-stride-1100000x16": lambda: ("gemv", i8((1, 16), 282), i8((1100000, 16), 283), (0, 0), (1, 1)),
        "gemv-int32-wrap-300x64": lambda: ("gemv", ints((1, 64), I32_MIN, I32_MAX, 284),
                                           ints((300, 64), I32_MIN, I32_MAX, 285), (0, 0), (16, 1)),
        "qk-int32-wrap": lambda: ("qk", ints((3, 32), I32_MIN, I32_MAX, 286), ints((500, 32), I32_MIN, I32_MAX, 287),
                                  (0, 0), (8, 1)),
        "gemv-int32-kernels-bench-512": lambda: ("gemv", ints((1, 512), -1000, 1000, 288),
                                                 ints((512, 512), -1000, 1000, 289), (0, 0), (32, 4)),
        "gemv-unroll-8-37x20000": lambda: ("gemv", i8((1, 20000), 300), i8((37, 20000), 301), (0, 0), (32, 8)),
        "gemv-unroll-2-2000x1024": lambda: ("gemv", i8((1, 1024), 310), i8((2000, 1024), 311), (0, 0), (32, 1)),
        "gemv-int32-unroll-2-2000x256": lambda: ("gemv", ints((1, 256), I32_MIN, I32_MAX, 302),
                                                 ints((2000, 256), I32_MIN, I32_MAX, 303), (0, 0), (32, 1)),
        "gemv-int32-unroll-4-5000x256": lambda: ("gemv", ints((1, 256), I32_MIN, I32_MAX, 304),
                                                 ints((5000, 256), I32_MIN, I32_MAX, 305), (0, 0), (16, 1)),
        "gemv-int32-unroll-8-40x8192": lambda: ("gemv", ints((1, 8192), I32_MIN, I32_MAX, 306),
                                                ints((40, 8192), I32_MIN, I32_MAX, 307), (0, 0), (32, 8)),
        "gemv-int32-streamed-40x16384": lambda: ("gemv", ints((1, 16384), I32_MIN, I32_MAX, 308),
                                                 ints((40, 16384), I32_MIN, I32_MAX, 309), (0, 0), (32, 8)),
        "gemv-weight-byte-off": lambda: ("gemv", i8((1, 896), 290), i8((128, 896), 291), (0, 1), None),
        "gemv-activation-byte-off": lambda: ("gemv", i8((1, 896), 292), i8((896, 896), 293), (1, 0), None),
        "qk-cache-byte-off": lambda: ("qk", i8((2, 64), 294), i8((1001, 64), 295), (0, 1), None),
        "qk-queries-byte-off": lambda: ("qk", i8((7, 64), 296), i8((1001, 64), 297), (1, 0), None),
        "gemv-int32-weight-4-bytes-off": lambda: ("gemv", ints((1, 64), I32_MIN, I32_MAX, 298),
                                                  ints((300, 64), I32_MIN, I32_MAX, 299), (0, 1), None),
    })
    return cases


ROWDOT = _rowdot_cases()


def _rowdot_call(case, card):
    """The case's operands on the card, its plan and its wrapper call."""
    kernel, a, w, (oa, ow), want = ROWDOT[case]()
    da, dw = on_card_at(a, card, oa), on_card_at(w, card, ow)
    plan = tatt.rowdot_plan(w.shape[0], w.shape[1], a.shape[0], dw.element_size(), da.element_size(),
                            (dw.data_ptr(), da.data_ptr()))
    assert ((plan.lanes, plan.split) if plan.vec else None) == want
    if kernel == "qk":
        return plan, "attention_qk", (lambda: tatt._qk(da, dw)), tatt._qk_plain(a, w)
    return plan, "decode_gemv", (lambda: tatt._gemv(dw, da[0])), tatt._gemv_plain(w, a[0])


@pytest.mark.parametrize("case", sorted(ROWDOT))
def test_rowdot_kernel_at_its_plan_edges(card, case):
    """q·Kᵀ and the decode GEMV at the edges of attention.rowdot_plan: each
    call takes the path its case names and equals the plain version."""
    plan, name, call, want = _rowdot_call(case, card)
    tapi.reset_launch_counts()
    got = call()
    torch.cuda.synchronize()
    assert tapi.launch_counts() == {name: 1}
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("case", ["qk-M1-T1001", "gemv-lanes-32-split-2-M1", "qk-cache-byte-off",
                                  "gemv-weight-byte-off"])
def test_rowdot_call_is_one_device_kernel_named_by_its_plan(card, case):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    plan, name, call, _ = _rowdot_call(case, card)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    names = [ev.name for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    want = "rowdot" if plan.vec else {"attention_qk": "qk_generic", "decode_gemv": "gemv_generic"}[name]
    assert len(names) == 1 and want in names[0], names


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
    # every chunk count of the int32 plan: N = 1, 2, 4, ..., 65536
    **{f"int32-N{2**e}": lambda e=e: ints((2**e, 2**(16 - e) * 4 if e < 14 else 16), I32_MIN, I32_MAX, 90 + e)
       for e in range(17)},
    "int32-D-odd": lambda: ints((64, 1001), I32_MIN, I32_MAX, 110),
    "int32-D-2-mod-4": lambda: ints((32, 4098), I32_MIN, I32_MAX, 111),
    "int32-INT32_MIN-columns-wrap": lambda: torch.full((256, 1024), I32_MIN, dtype=torch.int32),
}


@pytest.mark.parametrize("d", [4096, 4098])
def test_htree_kernel_int32_reads_a_misaligned_view(card, d):
    x = ints((128, d), I32_MIN, I32_MAX, 112)
    view = on_card_at(x, card, 1)
    assert not tht.htree_plan(128, d, view.data_ptr())[1]
    assert torch.equal(tht._htree(view).cpu(), tht._htree_plain(x))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n, d, offset", [(1, 4096, 0), (8, 4096, 0), (64, 4100, 0), (256, 4096, 1),
                                          (2048, 40, 0), (65536, 16, 0)])
def test_htree_kernel_floats_in_tree_order(card, dtype, n, d, offset):
    """float32 and bfloat16 take the chunked kernel too: every chunk count,
    a D that is not a multiple of a 16-byte pack, a view one element off its
    allocation's alignment; bit-equal to the plain version's tree order."""
    x = floats((n, d), 120 + n + d).to(getattr(torch, dtype))
    view = on_card_at(x, card, offset)
    vec = tht.htree_plan(n, d, view.data_ptr(), x.element_size())[1]
    assert vec == (offset == 0 and d % (16 // x.element_size()) == 0)
    got = tht._htree(view)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), tht._htree_plain(x))


@pytest.mark.parametrize("case", sorted(HTREE))
def test_htree_kernel_matches_plain(card, case):
    x = HTREE[case]()
    tapi.reset_launch_counts()
    got = tht._htree(x.to(card))
    torch.cuda.synchronize()
    assert tapi.launch_counts() == {"htree_reduce": 1}
    want = tht._htree_plain(x)
    assert got.dtype == want.dtype and torch.equal(got.cpu(), want)


def _subnormal_gates(shape, seed):
    """a, b and h0 drawn from ±0, float32 subnormals and small normals: a
    build that flushed subnormals to zero would differ."""
    rng = np.random.default_rng(seed)

    def draw(shp, scale):
        kind = rng.integers(0, 4, shp)
        vals = np.where(kind == 0, 0.0, np.where(kind == 1, -0.0, rng.standard_normal(shp) * scale))
        return torch.from_numpy(vals.astype(np.float32))

    bsz, _, w = shape
    return draw(shape, 0.5).abs(), draw(shape, 2.0**-135), draw((bsz, w), 2.0**-130)


# name → ((B, T, W), whether the plan takes 16-byte copies, a and b 4 bytes
# off 16-byte alignment, ±0 and subnormal operands); a stage is 32 steps, a
# group 32 channels (rglru_scan.rglru_plan)
RGLRU = {
    "T1": ((2, 1, 5), False, False, False),
    "ragged-W300-T37": ((2, 37, 300), True, False, False),
    "ragged-W513-T260": ((3, 260, 513), False, False, False),
    "recurrentgemma-width-T2048": ((1, 2048, 2560), True, False, False),
    "T-one-short-of-a-stage": ((2, 31, 64), True, False, False),
    "T-one-past-a-stage": ((2, 33, 64), True, False, False),
    "T8192": ((1, 8192, 40), True, False, False),
    "W1": ((3, 50, 1), False, False, False),
    "W3": ((2, 50, 3), False, False, False),
    "W4": ((2, 50, 4), True, False, False),
    "ragged-last-group-W40": ((2, 40, 40), True, False, False),
    "B-times-W-below-a-group": ((3, 33, 4), True, False, False),
    "off-16-bytes-W64": ((2, 100, 64), False, True, False),
    "off-16-bytes-W300": ((2, 37, 300), False, True, False),
    "zeros-and-subnormals": ((2, 70, 48), True, False, True),
    "zeros-and-subnormals-4-byte-copies": ((2, 70, 50), False, False, True),
}


@pytest.mark.parametrize("case", sorted(RGLRU))
def test_rglru_kernel_matches_plain(card, case):
    (bsz, t, w), vec, off, subnormal = RGLRU[case]
    if subnormal:
        a, b, h0 = _subnormal_gates((bsz, t, w), 99)
        assert (b.abs() < torch.finfo(torch.float32).tiny).logical_and(b != 0).any()
    else:
        a = torch.sigmoid(floats((bsz, t, w), 90))
        b, h0 = floats((bsz, t, w), 91), floats((bsz, w), 92)
    da, db = (on_card_at(a, card, 1), on_card_at(b, card, 1)) if off else (a.to(card), b.to(card))
    assert trg.rglru_plan(bsz, t, w, (da.data_ptr(), db.data_ptr())).vec == vec
    tapi.reset_launch_counts()
    got = trg._scan(da, db, h0.to(card))
    torch.cuda.synchronize()
    assert tapi.launch_counts() == {"rglru_scan": 1}
    want = trg._scan_plain(a, b, h0)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))  # ±0 too
    if subnormal:
        assert (want.abs() < torch.finfo(torch.float32).tiny).logical_and(want != 0).any()
    assert torch.allclose(got.cpu(), tref.rglru_scan_ref(a, b, h0), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("need_h0", [True, False], ids=["dh0", "no-dh0"])
@pytest.mark.parametrize("case", sorted(RGLRU))
def test_rglru_backward_kernel_matches_plain(card, case, need_h0):
    """K11's gradient kernel (``rglru_scan_bwd_f32``) at the forward's edges:
    ragged T and W, 16-byte-aligned widths and views 4 bytes off them (4-byte
    copies), ±0 and subnormals; ∂a, ∂b and ∂h0 bit-equal to the plain
    reverse recurrence (±0 too), one launch, the copies its plan names."""
    (bsz, t, w), vec, off, subnormal = RGLRU[case]
    if subnormal:
        a, b, h0 = _subnormal_gates((bsz, t, w), 199)
        zeros = _subnormal_gates((bsz, t, w), 198)[1]
        g = torch.where(zeros == 0, zeros, floats((bsz, t, w), 193))  # ±0 and normals
    else:
        a = torch.sigmoid(floats((bsz, t, w), 190))
        b, h0, g = floats((bsz, t, w), 191), floats((bsz, w), 192), floats((bsz, t, w), 193)
    hs = trg._scan_plain(a, b, h0)
    on = (lambda x: on_card_at(x, card, 1)) if off else (lambda x: x.to(card))
    da_, hs_, g_, h0_ = on(a), on(hs), on(g), h0.to(card)
    assert trg.rglru_plan(bsz, t, w, (da_.data_ptr(), hs_.data_ptr(), h0_.data_ptr(), g_.data_ptr())).vec == vec
    tapi.reset_launch_counts()
    got = trg._scan_bwd(da_, h0_, hs_, g_, need_h0)
    torch.cuda.synchronize()
    assert tapi.launch_counts() == {"rglru_scan_bwd": 1}
    want = trg._scan_bwd_plain(a, h0, hs, g, need_h0)
    for x, y in zip(got, want):
        if y is None:
            assert x is None
            continue
        assert torch.equal(x.cpu().view(torch.int32), y.view(torch.int32))


@pytest.mark.parametrize("shape", [(8, 64, 2560), (2, 37, 300), (1, 512, 2560)])
def test_rglru_scan_autograd_on_card_equals_cpu(card, shape):
    """``api.rglru_scan`` under autograd on the card: the forward and the
    backward kernel once each, hs and every gradient bit-equal to the same
    autograd on CPU copies (the plain versions)."""
    bsz, _, w = shape
    a, b, h0, g = torch.sigmoid(floats(shape, 194)), floats(shape, 195), floats((bsz, w), 196), floats(shape, 197)
    leaves = {dev: [x.detach().clone().to(dev).requires_grad_() for x in (a, b, h0)] for dev in ("cpu", card)}
    outs = {}
    for dev, (xa, xb, xh) in leaves.items():
        tapi.reset_launch_counts()
        hs = tapi.rglru_scan(xa, xb, xh)
        hs.backward(g.to(dev))
        if dev != "cpu":
            torch.cuda.synchronize()
            assert tapi.launch_counts() == {"rglru_scan": 1, "rglru_scan_bwd": 1}
        outs[dev] = [hs.detach().cpu(), xa.grad.cpu(), xb.grad.cpu(), xh.grad.cpu()]
    for x, y in zip(outs[card], outs["cpu"]):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def test_recurrentgemma_train_step_on_card_equals_cpu(card):
    """One ``make_train_step`` of RecurrentGemma at ``reduced_config`` in
    float32 on the card against the same step on CPU copies: K11 twice a
    RG-LRU layer in the forward (its remat recompute) and its backward once;
    the loss within 1e-5 relative, the moments within 1e-4 of their largest
    (cuBLAS adds in another order than the CPU's BLAS), each master weight
    within half a step of the CPU's."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import transformer as tt
    from repro_torch.models.runtime import RunFlags
    from repro_torch.train import optimizer as topt
    from repro_torch.train import steps as tsteps

    cfg = dataclasses.replace(reduced_config(get_config("recurrentgemma-2b")), dtype="float32")
    flags = RunFlags(attn_chunk=8, flash_threshold=64)
    params = tt.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(2, 256, (2, 12)).astype(np.int32)),
             "labels": torch.from_numpy(rng.integers(0, 256, (2, 12)).astype(np.int32))}
    step = tsteps.make_train_step(cfg, flags)
    cpu_new, cpu_m = step(tsteps.make_train_state(params, topt.AdamWConfig()), batch)
    card_state = tsteps.make_train_state(tt._tree_map(lambda x: x.to(card), params), topt.AdamWConfig())
    tapi.reset_launch_counts()
    new, metrics = step(card_state, {k: v.to(card) for k, v in batch.items()})
    torch.cuda.synchronize()
    n = sum(kind == "rglru" for kind in cfg.layer_kinds())
    assert tapi.launch_counts() == {"rglru_scan": 2 * n, "rglru_scan_bwd": n}
    assert abs(float(metrics["loss"]) - float(cpu_m["loss"])) <= 1e-5 * abs(float(cpu_m["loss"]))
    lr = float(cpu_m["lr"])
    for name in ("m", "v"):
        ref = topt.tree_leaves(cpu_new["opt"][name])
        top = max(float(x.abs().max()) for x in ref)
        for x, y in zip(topt.tree_leaves(new["opt"][name]), ref):
            assert float((x.cpu() - y).abs().max()) <= 1e-4 * top
    for x, y in zip(topt.tree_leaves(new["opt"]["master"]), topt.tree_leaves(cpu_new["opt"]["master"])):
        assert float((x.cpu() - y).abs().max()) <= lr / 2


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


# ---------------------------------------------------------------------------
# the Executor's CUDA graph replay
# ---------------------------------------------------------------------------

DECODE_CFG = dict(head_dim=64, value_dim=64, kv_bits=8, q_bits=8, score_bits=22, score_frac=13)


def _tiny_resnet_call(seed):
    cfg = tres.TINY
    params = tres.init_params(cfg, device="cpu")
    x = tres.make_input(cfg, 2, seed=seed, device="cpu")
    traced = tapi.trace(lambda p, v: tres.forward(cfg, p, v), name="tiny_replay")
    return traced, (params, x)


def _decode_step_call(seed, cap=64):
    onehot = _selector(cap, [cap // 2], torch.int8)
    args = (i8((cap, 64), seed), i8((cap, 64), seed + 1), i8((1, 64), seed + 2), i8((64,), seed + 3),
            i8((64,), seed + 4), onehot)
    return tps.decode_program(tps.AttnServeConfig(**DECODE_CFG), cap), args


def _decode_layer_call(seed):
    prog = tps.decode_layer_program(128, 64, 256, 256, q_bits=8, kv_bits=8, score_bits=22, score_frac=13, w_bits=8)
    args = (i8((256, 64), seed), i8((256, 64), seed + 1), i8((1, 64), seed + 2), i8((64, 128), seed + 3),
            i8((128, 256), seed + 4), i8((256, 128), seed + 5))
    return prog, args


def eager_call_output(ex, args):
    """The Executor's eager replay of ``ex(*args)``."""
    leaves, _ = tprogram.tree_flatten((args, {}))
    return tprogram.tree_unflatten(ex.program.out_tree, ex._eager(leaves))


def _to(tree, dev):
    leaves, td = tprogram.tree_flatten(tree)
    return tprogram.tree_unflatten(td, [a.to(dev) for a in leaves])


@pytest.mark.parametrize("path", ["tiny-resnet", "decode-step-64", "decode-layer"])
def test_executor_graph_replay_equals_eager_and_cpu_and_counts_launches(card, path):
    tapi.clear_compile_cache()
    if path == "tiny-resnet":
        traced, cpu_args = _tiny_resnet_call(100)
        prog = traced.program_for(*cpu_args)
    else:
        prog, cpu_args = (_decode_step_call if path == "decode-step-64" else _decode_layer_call)(101)
    ex = tapi.compile(prog)
    want = ex(*cpu_args)
    assert ex.replay == "eager" and "CPU" in ex.replay_reason
    args = _to(cpu_args, card)
    tapi.reset_launch_counts()
    first = ex(*args)  # eagerly, then captured
    torch.cuda.synchronize()
    eager_counts = tapi.launch_counts()
    assert ex.replay == "graph", ex.replay_reason
    for _ in range(3):
        tapi.reset_launch_counts()
        got = ex(*args)
        torch.cuda.synchronize()
        assert tapi.launch_counts() == eager_counts
        assert torch.equal(got.cpu(), want) and torch.equal(first.cpu(), want)
    assert torch.equal(eager_call_output(ex, args).cpu(), want)


def test_executor_inside_an_outer_capture_replays_eagerly(card):
    tapi.clear_compile_cache()
    prog, cpu_args = _decode_step_call(110, cap=256)
    ex = tapi.compile(prog)
    want = ex(*cpu_args)
    args = [a.to(card) for a in cpu_args]
    ex(*args)  # the first call: builds the plans and the p·V ticket, then captures
    outer = torch.cuda.CUDAGraph()
    with torch.cuda.graph(outer):
        inside = ex(*args)
        route = ex.replay, ex.replay_reason
    assert route[0] == "eager" and "being captured" in route[1]
    for _ in range(2):
        outer.replay()
        torch.cuda.synchronize()
        assert torch.equal(inside.cpu(), want)
    ex(*args)
    assert ex.replay == "graph"


def test_executor_on_views_off_16_bytes_equals_its_aligned_replay(card):
    """The eager call's views are off 16 bytes (generic kernels), the graph's
    static buffers aligned (vector kernels): the outputs are equal."""
    tapi.clear_compile_cache()
    prog, cpu_args = _decode_step_call(120, cap=1024)
    ex = tapi.compile(prog)
    want = ex(*cpu_args)

    def off16(t):
        return torch.empty(t.numel() + 8, dtype=t.dtype, device=card)[8:].view(t.shape).copy_(t.to(card))

    views = [off16(a) for a in cpu_args]
    assert not tatt.kv_plan(1024, 64, 1, 1, (views[0].data_ptr(), views[3].data_ptr(), 0)).vec
    first = ex(*views)
    (replay,) = ex._graphs.values()
    assert all(b.data_ptr() % 16 == 0 for b in replay.inputs)
    second = ex(*views)
    torch.cuda.synchronize()
    assert ex.replay == "graph"
    assert torch.equal(first.cpu(), want) and torch.equal(second.cpu(), want)


def test_executor_outputs_are_fresh_and_threads_may_share_it(card):
    import threading

    tapi.clear_compile_cache()
    sets = [_decode_step_call(130 + 10 * i, cap=512) for i in range(4)]
    ex = tapi.compile(sets[0][0])
    wants = [ex(*a) for _, a in sets]
    card_sets = [[a.to(card) for a in args] for _, args in sets]
    ex(*card_sets[0])
    kept = ex(*card_sets[1])
    later = ex(*card_sets[2])
    torch.cuda.synchronize()
    assert torch.equal(kept.cpu(), wants[1]) and torch.equal(later.cpu(), wants[2])
    outs, errors = {0: [], 1: []}, []

    def worker(i):
        try:
            s = torch.cuda.Stream(card)
            s.wait_stream(torch.cuda.current_stream(card))
            with torch.cuda.stream(s):
                for _ in range(10):
                    outs[i].append(ex(*card_sets[2 + i]))
            s.synchronize()
        except Exception as exc:  # asserted below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads) and errors == []
    for i in (0, 1):
        assert len(outs[i]) == 10 and all(torch.equal(o.cpu(), wants[2 + i]) for o in outs[i])


def test_executor_graph_survives_a_profiler_session(card):
    """A graph captured before a torch.profiler session replays after it,
    on the graph route and bit-equal to the CPU path."""
    from torch.profiler import ProfilerActivity, profile

    tapi.clear_compile_cache()
    prog, cpu_args = _decode_step_call(140, cap=256)
    ex = tapi.compile(prog)
    want = ex(*cpu_args)
    args = [a.to(card) for a in cpu_args]
    ex(*args)  # eagerly, then captured
    y = torch.zeros(1000, device=card)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        y.add_(1)
        torch.cuda.synchronize()
    for _ in range(2):
        got = ex(*args)
        torch.cuda.synchronize()
        assert ex.replay == "graph" and torch.equal(got.cpu(), want)


# ---------------------------------------------------------------------------
# the eager pimsab backend with operands on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", ["conv2d", "relu", "htree_reduce", "kv_append"])
def test_pimsab_takes_card_operands_and_returns_to_the_card(card, kernel):
    """Under ``use_backend("pimsab")`` card operands go to the simulator on
    the host and the result comes back to the card, equal to the card
    kernel's (integers bit for bit, the fixed-point H-tree within the
    conformance tolerance), with no launch counted."""
    cases = {
        "conv2d": ((ints((2, 3, 8, 8), -8, 8, 20), ints((4, 3, 3, 3), -100, 100, 21)),
                   lambda x, w: tapi.conv2d(x, w, stride=2, padding=1)),
        "relu": ((ints((8, 32), -500, 500, 8),), tapi.relu),
        "htree_reduce": ((floats((16, 32), 2),), tapi.htree_reduce),
        "kv_append": ((ints((8, 4), -100, 100, 34), ints((4,), -100, 100, 35),
                       torch.eye(8, dtype=torch.int32)[5]), tapi.kv_append),
    }
    cpu_ops, fn = cases[kernel]
    ops = [o.to(card) for o in cpu_ops]
    tapi.reset_launch_counts()
    with tapi.use_backend("pimsab"):
        got = fn(*ops)
    assert tapi.launch_counts() == {}
    assert got.device == card and got.is_contiguous()
    assert tapi.last_sim_report().kernel == kernel
    want = fn(*ops)
    torch.cuda.synchronize()
    if got.is_floating_point():
        torch.testing.assert_close(got, want, atol=5e-3, rtol=5e-3)
    else:
        assert torch.equal(got, want)
    with tapi.use_backend("pimsab"):
        assert torch.equal(fn(*cpu_ops), got.cpu())  # the same on CPU operands


def test_pimsab_call_during_a_cuda_graph_capture_is_refused(card):
    x = ints((8, 32), -500, 500, 8).to(card)
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream(card)
    with pytest.raises(tapi.PimsabTracerError, match="CUDA graph capture"):
        with torch.cuda.graph(graph, stream=stream), tapi.use_backend("pimsab"):
            tapi.relu(x)
    torch.cuda.synchronize()
    with tapi.use_backend("pimsab"):
        assert torch.equal(tapi.relu(x).cpu(), torch.clamp_min(x.cpu(), 0))


# ---------------------------------------------------------------------------
# the pimsab Program lowering with operands on the card
# ---------------------------------------------------------------------------


def _pimsab_chain(xs, ws, y):
    return tapi.relu(tapi.ewise_add(tapi.matmul(xs, ws), y))


def test_pimsab_executor_takes_card_leaves_and_returns_card_tensors(card):
    """A pimsab Executor copies card leaves to the host, runs the fused
    stream on the simulator and returns card tensors bit-equal to the card
    Executor's graph replay of the same Program, with no launch counted."""
    x, w, y = ints((16, 8), -100, 100, 0), ints((8, 16), -100, 100, 1), ints((16, 16), -100, 100, 2)
    ops = (tapi.SlicedTensor.from_int(x.to(card), 8), tapi.SlicedTensor.from_int(w.to(card), 8), y.to(card))
    prog = tapi.trace(_pimsab_chain, name="card_pimsab_chain").program_for(*ops)
    pim, dev = tapi.compile(prog, "pimsab"), tapi.compile(prog)
    tapi.reset_launch_counts()
    with tapi.use_backend("pimsab"):
        got = pim(*ops)
        assert tapi.launch_counts() == {}
        again = tapi.trace(_pimsab_chain, name="card_pimsab_chain")(*ops)
    assert tapi.launch_counts() == {} and pim.replay == "pimsab"
    assert got.device == card and got.dtype == torch.int32 and torch.equal(again, got)
    dev(*ops)
    want = dev(*ops)
    torch.cuda.synchronize()
    assert dev.replay == "graph" and torch.equal(got, want)


def test_pimsab_executor_call_during_a_cuda_graph_capture_is_refused(card):
    x = ints((8, 32), -500, 500, 8).to(card)
    pim = tapi.compile(tapi.trace(tapi.relu, name="card_pimsab_relu").program_for(x), "pimsab")
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream(card)
    with pytest.raises(tapi.PimsabTracerError, match="capture"):
        with torch.cuda.graph(graph, stream=stream):
            pim(x)
    torch.cuda.synchronize()
    assert torch.equal(pim(x).cpu(), torch.clamp_min(x.cpu(), 0))


# ---------------------------------------------------------------------------
# multi-chip scale-out and the continuous-batching scheduler on card operands
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chips", [2, 4, 8])
def test_cluster_executor_takes_card_operands_and_equals_the_card_executor(card, chips):
    """The decode layer sharded over a cluster (``plan == "tp"``) takes card
    operands and returns a card tensor bit-equal to the card device
    Executor's graph replay of the same Program; no launch counted; a call
    during a CUDA graph capture refused."""
    rng = np.random.default_rng(7)
    args = [torch.from_numpy(rng.integers(lo, hi, s).astype(np.int8)).to(card)
            for lo, hi, s in ((-3, 4, (8, 16)), (-3, 4, (8, 16)), (-3, 4, (1, 16)), (-7, 8, (16, 256)),
                              (-7, 8, (256, 512)), (-7, 8, (512, 256)))]
    prog = tps.decode_layer_program()
    ex, dev = tapi.compile(prog, "pimsab", chips=chips), tapi.compile(prog)
    tapi.reset_launch_counts()
    got = ex(*args)
    assert tapi.launch_counts() == {} and ex.plan == "tp"
    assert got.device == card and got.dtype == torch.int32
    dev(*args)
    want = dev(*args)
    torch.cuda.synchronize()
    assert dev.replay == "graph" and torch.equal(got, want)
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream(card)
    with pytest.raises(tapi.PimsabTracerError, match="capture"):
        with torch.cuda.graph(graph, stream=stream):
            ex(*args)
    torch.cuda.synchronize()


def test_continuous_batcher_on_the_card_returns_card_contexts(card, monkeypatch):
    """``ContinuousBatcher(device="cuda")``: every step's context lies on the
    card, the generations equal a CPU batcher's, no launch counted."""
    from repro_torch.serve import scheduler as tsched

    ctxs = []
    real = tsched.run_decode_step

    def spy(*a, **k):
        ctxs.append(real(*a, **k))
        return ctxs[-1]

    monkeypatch.setattr(tsched, "run_decode_step", spy)
    gens = {}
    for device in ("cuda", "cpu"):
        sched = tsched.ContinuousBatcher(max_active=2, buckets=(4, 8), device=device)
        assert sched.device.type == device
        sched.submit([1], max_new_tokens=5)
        sched.submit([2, 3], max_new_tokens=2)
        tapi.reset_launch_counts()
        gens[device] = [(r.prompt, r.generated) for r in sched.run()]
        assert tapi.launch_counts() == {}
        assert ctxs and all(c.device.type == device and c.dtype == torch.int32 for c in ctxs)
        ctxs.clear()
    assert gens["cuda"] == gens["cpu"]


# ---------------------------------------------------------------------------
# the LLM serving path (models/transformer.py, serve/engine.py)
# ---------------------------------------------------------------------------

# Qwen2-0.5B's quantized linears (src/repro/configs/qwen2_0_5b.py): (K, N) of
# q/o, k/v, gate/up and down, at the path's M (one decode token, a 4-request
# decode step, 4 × 8 prompt tokens, one 512-token prompt)
LLM_KN = [(896, 896), (896, 128), (896, 4864), (4864, 896)]


@pytest.mark.parametrize("m", [1, 4, 32, 512])
@pytest.mark.parametrize("k,n", LLM_KN)
def test_bitslice_kernel_at_the_llm_shapes(card, m, k, n):
    """K4 as a quantized linear launches it: one int8 slice pair, the weight a
    group's view of a (G, K, N) stack, on the tensor cores, bit-equal."""
    rng = np.random.default_rng(m * 7 + k + n)
    x = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (3, k, n)).astype(np.int8))
    tapi.reset_launch_counts()
    got = tcommon.int_matmul(x.to(card), w.to(card)[1])
    torch.cuda.synchronize()
    assert tapi.launch_counts() == {"bitslice_matmul": 1} and tbm.launched_path() == "mma"
    assert torch.equal(got.cpu(), tcommon.int_matmul(x, w[1]))


@pytest.mark.parametrize("b,t,calls", [(4, 128, 1), (1, 1024, 1), (3, 17, 1), (16, 1024, 1), (64, 1024, 4),
                                       (33, 4096, 5)])
def test_int8_scores_on_the_cache_view(card, b, t, calls):
    """K6 over a (B, T, Hkv, hd) int8 cache read in place (Qwen2-0.5B: 2 KV
    heads of 64, a GQA group of 7): one launch for each group of batch rows
    (64 × 1024 in 4 calls of 16 rows, 33 × 4096 in 5 of at most 7), the
    scores taken as diagonal views equal to the CPU's."""
    from repro_torch.models import attention as tmattn

    rng = np.random.default_rng(b * t)
    kq = torch.from_numpy(rng.integers(-127, 128, (2, b, t, 2, 64)).astype(np.int8))
    qq = torch.from_numpy(rng.integers(-127, 128, (b, 2, 7, 64)).astype(np.int8))
    tapi.reset_launch_counts()
    got = tmattn.int8_scores(qq.to(card), kq.to(card)[1])
    torch.cuda.synchronize()
    assert tapi.launch_counts() == {"attention_qk": calls}
    assert torch.equal(got.cpu(), tmattn.int8_scores(qq, kq[1]))


@pytest.mark.parametrize("quant_kv", [False, True])
def test_reduced_decode_step_on_card_equals_cpu(card, quant_kv):
    """A Qwen2-0.5B ``reduced_config`` prefill and two decode steps on the
    card against the same port on CPU copies (float32: 2**-6 of the largest
    logit, the tolerance of tests/_torch_lm_ref.py with int8 activations);
    K4 launches 7 a layer a step, each behind one activation quantize, K6
    one a layer a decode step under quant_kv."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import common as tc
    from repro_torch.models import transformer as tt
    from repro_torch.models.runtime import RunFlags

    cfg = dataclasses.replace(reduced_config(get_config("qwen2-0.5b")), dtype="float32")
    flags = RunFlags(attn_chunk=8, flash_threshold=64, quant_kv=quant_kv)
    cpu_p = tc.maybe_quantize_tree(tt.init_params(cfg, 0, device="cpu"), cfg)
    card_p = tt._tree_map(lambda a: a.to(card), cpu_p)
    toks = torch.from_numpy(np.random.default_rng(1).integers(2, 256, (2, 12)).astype(np.int32))
    tapi.reset_launch_counts()
    cache_d, got = tt.prefill(card_p, cfg, {"tokens": toks.to(card)}, flags, max_len=16)
    linears = {"bitslice_matmul": 7 * cfg.n_layers, "act_quant": 7 * cfg.n_layers}
    assert tapi.launch_counts() == linears
    cache_c, want = tt.prefill(cpu_p, cfg, {"tokens": toks}, flags, max_len=16)
    for step in range(3):
        atol = 2.0 ** -6 * float(want.abs().max())
        assert float((got.cpu() - want).abs().max()) <= atol, step
        nt = torch.argmax(want, -1).to(torch.int32)[:, None]
        tapi.reset_launch_counts()
        cache_d, got = tt.decode_step(card_p, cfg, cache_d, nt.to(card), flags)
        torch.cuda.synchronize()
        assert tapi.launch_counts() == (dict(linears, attention_qk=cfg.n_layers) if quant_kv else linears)
        cache_c, want = tt.decode_step(cpu_p, cfg, cache_c, nt, flags)


# ---------------------------------------------------------------------------
# the model families beyond decoder-only attention (models/recurrent.py,
# models/moe.py, the encoder-decoder of models/transformer.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h0_zero", [True, False], ids=["zeros", "carried"])
@pytest.mark.parametrize("shape", [(4, 8, 2560), (1, 512, 2560)], ids=["prefill-4x8", "prefill-1x512"])
def test_rglru_kernel_at_the_model_shapes(card, shape, h0_zero):
    """K11 as RecurrentGemma-2B's RG-LRU prefill launches it: a = exp(log a)
    in (0, 1), b the gated input, h0 zeros or a carried state; bit-equal to
    its plain version, one launch."""
    bsz, _, w = shape
    a = torch.exp(-8.0 * torch.nn.functional.softplus(torch.tensor(2.0)) * torch.sigmoid(floats(shape, 93)))
    b, h0 = floats(shape, 94), (torch.zeros((bsz, w)) if h0_zero else floats((bsz, w), 95))
    tapi.reset_launch_counts()
    got = tapi.rglru_scan(a.to(card), b.to(card), h0.to(card))
    torch.cuda.synchronize()
    assert tapi.launch_counts() == {"rglru_scan": 1}
    assert torch.equal(got.cpu(), trg._scan_plain(a, b, h0))


FAMILY_K11 = {"recurrentgemma-2b": 2, "xlstm-1.3b": 0, "dbrx-132b": 0, "kimi-k2-1t-a32b": 0, "whisper-medium": 0}


@pytest.mark.parametrize("arch", sorted(FAMILY_K11))
def test_reduced_family_on_card_equals_cpu(card, arch):
    """Each family's ``reduced_config`` in float32 with int8 weights: a
    prefill and three decode steps on the card against the same port on CPU
    copies, within 2**-6 of the largest logit (tests/_torch_lm_ref.py's
    tolerance with int8 activations; the MoE combine adds in another order
    on the card); K11 once for each RG-LRU layer of the prefill and never in
    a decode step; loss_fn finite."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import common as tc
    from repro_torch.models import transformer as tt
    from repro_torch.models.runtime import RunFlags

    cfg = dataclasses.replace(reduced_config(get_config(arch)), dtype="float32")
    flags = RunFlags(attn_chunk=8, flash_threshold=64)
    cpu_p = tc.maybe_quantize_tree(tt.init_params(cfg, 0, device="cpu"), cfg)
    card_p = tt._tree_map(lambda a: a.to(card), cpu_p)
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.from_numpy(rng.integers(2, 256, (2, 12)).astype(np.int32))}
    if cfg.is_encdec:
        batch["enc_embeds"] = torch.from_numpy(rng.standard_normal((2, cfg.enc_seq_len, cfg.d_model)).astype(np.float32))
    on_card = {k: v.to(card) for k, v in batch.items()}
    tapi.reset_launch_counts()
    cache_d, got = tt.prefill(card_p, cfg, on_card, flags, max_len=16)
    torch.cuda.synchronize()
    assert tapi.launch_counts().get("rglru_scan", 0) == FAMILY_K11[arch]
    cache_c, want = tt.prefill(cpu_p, cfg, batch, flags, max_len=16)
    for step in range(4):
        assert float((got.cpu() - want).abs().max()) <= 2.0 ** -6 * float(want.abs().max()), step
        if step == 3:
            break
        nt = torch.argmax(want, -1).to(torch.int32)[:, None]
        tapi.reset_launch_counts()
        cache_d, got = tt.decode_step(card_p, cfg, cache_d, nt.to(card), flags)
        torch.cuda.synchronize()
        assert "rglru_scan" not in tapi.launch_counts() and tapi.launch_counts()["bitslice_matmul"] > 0
        cache_c, want = tt.decode_step(cpu_p, cfg, cache_c, nt, flags)
    labels = torch.from_numpy(rng.integers(0, 256, (2, 12)).astype(np.int32))
    loss, parts = tt.loss_fn(card_p, cfg, dict(on_card, labels=labels.to(card)), flags)
    assert torch.isfinite(loss) and (float(parts["aux"]) > 0) == cfg.is_moe


def test_nccl_world_one_collectives_and_train_step(card, tmp_path):
    """An NCCL process group of one rank on the card: the ("data", "model")
    host mesh, the four collectives bit-equal to their CPU copies (integer-
    valued floats for the ring matmul), a CPU tensor refused by the NCCL
    group, and a reduced train step under the rules with ZeRO-1 bit-equal
    to the rules-free step on the card."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.dist import collectives as tc
    from repro_torch.dist.sharding import MeshRules
    from repro_torch.launch.mesh import MeshDescription, make_host_mesh
    from repro_torch.models import transformer as tt
    from repro_torch.models.runtime import RunFlags
    from repro_torch.train import optimizer as topt
    from repro_torch.train import steps as tsteps

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rdzv'}", world_size=1, rank=0)
    try:
        mesh = make_host_mesh()
        assert str(dist.get_backend(mesh.group("data"))) == "nccl"
        cpu = MeshDescription((1, 1), ("data", "model"))
        x, xi = floats((4, 64), 1), ints((4, 64), I32_MIN, I32_MAX, 2)
        a, w = ints((16, 64), -8, 8, 3).float(), ints((64, 24), -8, 8, 4).float()
        g, e = floats((4096,), 5), 0.01 * floats((4096,), 6)
        tc.reset_call_counts()
        for fn, args in ((lambda m, t: tc.htree_allreduce(t, m, "model"), (x,)),
                         (lambda m, t: tc.htree_allreduce(t, m, "data"), (xi,)),
                         (lambda m, p, q: tc.ring_allgather_matmul(p, q, m, "model"), (a, w)),
                         (lambda m, t: tc.shuffle(t, m, "data"), (xi,)),
                         (lambda m, p, q: torch.cat(tc.compressed_psum_with_feedback(p, q, m, ("data", "model"))),
                          (g, e))):
            got = fn(mesh, *[t.to(card) for t in args])
            assert got.device.type == "cuda" and torch.equal(got.cpu(), fn(cpu, *args))
        assert tc.call_counts() == {"all_to_all_single": 1, "all_reduce": 2}
        with pytest.raises(RuntimeError, match="nccl"):
            tc.all_reduce_(torch.zeros(2), mesh.group("data"))

        rules = MeshRules.from_mesh(mesh)
        cfg = reduced_config(get_config("recurrentgemma-2b"))
        flags = RunFlags(attn_chunk=8, flash_threshold=64)
        batch = {k: ints((2, 12), 0, cfg.vocab_size, 7 + i).to(card) for i, k in enumerate(("tokens", "labels"))}
        params = tt.init_params(cfg, 0, device=card)
        plain, _ = tsteps.make_train_step(cfg, flags)(
            tsteps.make_train_state(topt.tree_map(torch.clone, params), topt.AdamWConfig()), batch)
        z1 = dataclasses.replace(flags, zero1=True)
        specs = tsteps.train_state_specs(cfg, rules, topt.AdamWConfig(), z1)
        state = tsteps.shard_train_state(tsteps.make_train_state(params, topt.AdamWConfig()), specs, rules)
        new, _ = tsteps.make_train_step(cfg, z1, rules)(state, batch)
        new = tsteps.gather_train_state(new, specs, rules)
        for p, q in zip(topt.tree_leaves(plain), topt.tree_leaves(new)):
            assert torch.equal(p, q)
    finally:
        torch.cuda.synchronize()
        dist.destroy_process_group()
