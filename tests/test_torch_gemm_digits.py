"""The algebra and the launch plans of the port's int32 GEMM and H-tree
kernels (``csrc/int_gemm.cu``, ``csrc/htree_reduce.cu``), on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``), but what they compute can be modelled here:

* a numpy model of the GEMM's tensor-core path (votes on the bytes a 32 × 32
  tile's values need, u8/s8 byte digits, the digit pairs whose shift stays
  below 32 bits, s32 accumulators per shift over K ranges of at most
  ``conv.GEMM_K_CHUNK``, the shifted uint32 combine) must equal the JAX
  package's int32 matmul oracle bit for bit, and never leave the s32 range;
* ``conv.gemm_plan`` and ``htree_reduce.htree_plan``, plain Python, are held
  to the kernels' constants and to the shapes the main paths give them;
* ``conv2d``, which now hands the GEMM its weight as ``(OC, C·KH·KW)``,
  equals JAX's ``conv2d`` under ``"xla"`` and ``"interpret"``.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import api as japi  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _build, conv  # noqa: E402
from repro_torch.kernels import api as tapi  # noqa: E402
from repro_torch.kernels import htree_reduce as tht  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import resnet as tres  # noqa: E402

I32_MIN, I32_MAX = -(2**31), 2**31 - 1
TILE = 32  # a warp's rows of A, columns of B and K step: the vote's reach


# ---------------------------------------------------------------------------
# a numpy model of the tensor-core path
# ---------------------------------------------------------------------------


def bytes_needed(x):
    """Fewest signed bytes that hold every value of the int64 array ``x``
    (int32 values): the OR of ``x ^ (x >> 31)`` over the tile, thresholded."""
    y = np.bitwise_or.reduce((x ^ (x >> 31)).ravel() & 0xFFFFFFFF) if x.size else 0
    return 1 if y < 0x80 else 2 if y < 0x8000 else 3 if y < 0x800000 else 4


def digits(x, nb):
    """The ``nb`` byte digits of ``x``: raw bytes read unsigned below the
    top digit; the top digit signed (``x`` fits in ``nb`` bytes, so the
    arithmetic shift leaves it in [-128, 127])."""
    return [(x >> (8 * i)) & 0xFF for i in range(nb - 1)] + [x >> (8 * (nb - 1))]


def digit_gemm_model(a, b, k_chunk, stats=None):
    """``a (M, K) @ b (K, N)`` mod 2**32 the way the tile kernel computes it:
    K in ranges of ``k_chunk`` (one block each, added together in uint32),
    each range in 32-wide steps; per step and 32 × 32 warp tile, a vote on
    the bytes of A's rows and of B's columns, the digit pairs with
    ``i + j <= 3`` into one accumulator per shift, then Σ acc_s << 8s.
    ``stats`` collects the largest accumulator magnitude."""
    a, b = a.astype(np.int64), b.astype(np.int64)
    (m, k), n = a.shape, b.shape[1]
    out = np.zeros((m, n), dtype=np.uint64)
    for kb in range(0, max(k, 1), k_chunk):
        ke = min(k, kb + k_chunk)
        for r0 in range(0, m, TILE):
            for c0 in range(0, n, TILE):
                acc = np.zeros((4, min(TILE, m - r0), min(TILE, n - c0)), dtype=np.int64)
                for k0 in range(kb, ke, TILE):
                    at, bt = a[r0:r0 + TILE, k0:min(k0 + TILE, ke)], b[k0:min(k0 + TILE, ke), c0:c0 + TILE]
                    na, nb = bytes_needed(at), bytes_needed(bt)
                    da, db = digits(at, na), digits(bt, nb)
                    for i in range(na):
                        for j in range(nb):
                            if i + j <= 3:
                                acc[i + j] += da[i] @ db[j]
                if stats is not None:
                    stats["max_abs_acc"] = max(stats.get("max_abs_acc", 0), int(np.abs(acc).max()))
                assert np.abs(acc).max() < 2**31, "an s32 accumulator would overflow"
                combined = sum((acc[s] % 2**32) << (8 * s) for s in range(4)) % 2**32
                out[r0:r0 + TILE, c0:c0 + TILE] += combined.astype(np.uint64)
    return (out % 2**32).astype(np.uint32).view(np.int32)


def jax_matmul(a, b):
    return np.asarray(jref.int_matmul_ref(jnp.asarray(a), jnp.asarray(b)))


def rng_ints(shape, lo, hi, seed):
    return np.random.default_rng(seed).integers(lo, hi, shape, endpoint=True).astype(np.int32)


def mixed_bytes(shape, seed, period=TILE):
    """Values whose byte count (1 or 4) changes from one 32-wide tile to
    the next along both axes."""
    rng = np.random.default_rng(seed)
    r, c = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]), indexing="ij")
    wide = ((r // period + c // period) % 2).astype(bool)
    return np.where(wide, rng.integers(I32_MIN, I32_MAX, shape, endpoint=True),
                    rng.integers(-128, 128, shape)).astype(np.int32)


def extreme_rows(shape, seed):
    """Rows of INT32_MIN, -1 and INT32_MAX between full-range rows."""
    x = rng_ints(shape, I32_MIN, I32_MAX, seed)
    x[0::4], x[1::4], x[2::4] = I32_MIN, -1, I32_MAX
    return x


DIGIT_CASES = {
    "extreme-rows-both-sides": lambda: (extreme_rows((37, 70), 1), extreme_rows((70, 45), 2).T.copy().T),
    "extreme-A-full-B": lambda: (extreme_rows((40, 64), 3), rng_ints((64, 33), I32_MIN, I32_MAX, 4)),
    "full-range-both": lambda: (rng_ints((65, 100), I32_MIN, I32_MAX, 5), rng_ints((100, 40), I32_MIN, I32_MAX, 6)),
    "B-tiles-mix-1-and-4-bytes": lambda: (rng_ints((64, 128), -2**20, 2**20, 7), mixed_bytes((128, 64), 8)),
    "both-mix-1-and-4-bytes": lambda: (mixed_bytes((64, 96), 9), mixed_bytes((96, 64), 10)),
    "3-bit-weights-ResNet-like": lambda: (rng_ints((33, 288), I32_MIN, I32_MAX, 11), rng_ints((288, 40), -3, 3, 12)),
    "stem-K27-4-bit-inputs": lambda: (rng_ints((50, 27), -8, 7, 13), rng_ints((27, 20), -3, 3, 14)),
    "2-and-3-byte-values": lambda: (rng_ints((32, 64), -2**15, 2**15 - 1, 15), rng_ints((64, 32), -2**23, 2**23 - 1, 16)),
}


@pytest.mark.parametrize("case", sorted(DIGIT_CASES))
def test_digit_model_equals_jax_int32_matmul(case):
    a, b = DIGIT_CASES[case]()
    got = digit_gemm_model(a, b, conv.GEMM_K_CHUNK)
    np.testing.assert_array_equal(got, jax_matmul(a, b))


def test_digit_model_at_k40000_with_all_255_digits():
    """K = 40000 of INT32_MAX (digits 255, 255, 255, top 127) and of -129
    (digits 127, top -1): five K ranges, four of them a full GEMM_K_CHUNK,
    whose accumulators come within reach of the s32 limit and stay under it."""
    k = 40000
    a = np.full((4, k), I32_MAX, dtype=np.int32)
    a[1] = -129
    b = np.full((k, 3), I32_MAX, dtype=np.int32)
    b[:, 1] = -1
    stats = {}
    got = digit_gemm_model(a, b, conv.GEMM_K_CHUNK, stats)
    np.testing.assert_array_equal(got, jax_matmul(a, b))
    assert 2**30 < stats["max_abs_acc"] < 2**31


def test_k_chunk_keeps_four_pairs_of_the_largest_digit_products_exact():
    assert 4 * conv.GEMM_K_CHUNK * 255 * 255 < 2**31
    assert conv.GEMM_K_CHUNK % conv.GEMM_TILE[2] == 0


@pytest.mark.parametrize("x", [I32_MIN, -129, -128, -1, 0, 127, 128, 2**15 - 1, 2**15, -(2**23), 2**23, I32_MAX])
def test_digits_rebuild_the_value(x):
    v = np.array([x], dtype=np.int64)
    nb = bytes_needed(v)
    assert sum(int(d[0]) << (8 * i) for i, d in enumerate(digits(v, nb))) == x
    assert nb == min(n for n in (1, 2, 3, 4) if -(2 ** (8 * n - 1)) <= x < 2 ** (8 * n - 1))


# ---------------------------------------------------------------------------
# gemm_plan
# ---------------------------------------------------------------------------


def test_gemm_plan_mirrors_the_kernels_constants():
    text = (_build.CSRC / "int_gemm.cu").read_text()
    tm, tn, tk = conv.GEMM_TILE
    for name, value in (("TBM", tm), ("TBN", tn), ("TBK", tk), ("SMALL_THREADS", conv.GEMM_SMALL_THREADS),
                        ("SMALL_MAX_K", conv.GEMM_SMALL_MAX_K)):
        assert re.search(rf"\b{name} = {value}\b", text), name


def resnet_gemm_shapes(cfg, batch):
    """(M, K, N, B's layout) of every GEMM of ``resnet.forward``: the stem,
    two convs a block and a projection where the shape changes (all with the
    weight as (OC, C·KH·KW)), and the head (B as (K, N))."""
    hw, c_in = cfg.input_hw, cfg.stem_channels
    shapes = [(batch * hw * hw, cfg.in_channels * 9, c_in, "nk")]
    if cfg.stem_pool:
        hw //= 2
    for si, (c_out, blocks) in enumerate(zip(cfg.stage_channels, cfg.blocks_per_stage)):
        for bi in range(blocks):
            stride = 2 if si > 0 and bi == 0 else 1
            oh = (hw - 1) // stride + 1
            shapes += [(batch * oh * oh, c_in * 9, c_out, "nk"), (batch * oh * oh, c_out * 9, c_out, "nk")]
            if stride != 1 or c_in != c_out:
                shapes.append((batch * oh * oh, c_in, c_out, "nk"))
            hw, c_in = oh, c_out
    return shapes + [(batch, c_in, cfg.num_classes, "kn")]


# the decode layer at Qwen2-0.5B's width (chip_smoke.py's LAYER_DIMS): the
# context through the output projection, the FFN up and down projections
DECODE_GEMMS = [(1, 64, 896), (1, 896, 4864), (1, 4864, 896)]


def check_plan(plan, m, n, k):
    assert 1 <= plan.splits and (plan.splits - 1) * plan.k_chunk < max(k, 1) <= plan.splits * plan.k_chunk
    if plan.path == "tile":
        assert plan.k_chunk <= conv.GEMM_K_CHUNK and plan.k_chunk % conv.GEMM_TILE[2] == 0
    else:
        assert plan.k_chunk <= conv.GEMM_SMALL_MAX_K


def test_gemm_plan_sends_resnet18_to_the_tile_path():
    shapes = resnet_gemm_shapes(tres.RESNET18, 32)
    names = tres.layer_names(tres.RESNET18)
    assert len(shapes) == names.count("conv2d") + names.count("int_matmul") == 21
    assert shapes[0] == (32768, 27, 64, "nk") and shapes[-1] == (32, 512, 1000, "kn")
    for m, k, n, layout in shapes:
        plan = conv.gemm_plan(m, n, k, layout, (0, 0))
        assert plan.path == "tile", (m, k, n)
        assert plan.a_vec == (k % 4 == 0) and plan.b_vec == (layout == "nk" and k % 4 == 0)
        check_plan(plan, m, n, k)
        # the tiles and the K ranges hold at least GEMM_TARGET_BLOCKS blocks,
        # or every range is as short as a split may be
        tiles = -(-m // conv.GEMM_TILE[0]) * -(-n // conv.GEMM_TILE[1])
        assert tiles * plan.splits >= min(conv.GEMM_TARGET_BLOCKS // 2, tiles * -(-k // conv.GEMM_MIN_SPLIT_K))


@pytest.mark.parametrize("m, k, n", DECODE_GEMMS)
def test_gemm_plan_sends_the_decode_layer_to_the_small_m_path(m, k, n):
    plan = conv.gemm_plan(m, n, k, "kn", (0, 256))
    assert plan.path == "small" and plan.b_vec
    check_plan(plan, m, n, k)


@pytest.mark.parametrize("m, k, n, layout, path", [
    (16, 4864, 896, "kn", "small"), (17, 4864, 896, "kn", "tile"), (1, 4864, 896, "nk", "tile"),
    (3, 40000, 24, "kn", "small"), (40, 40000, 24, "nk", "tile"), (2112, 40000, 64, "nk", "tile"),
    (16896, 8192, 64, "nk", "tile"), (5, 0, 7, "kn", "small"), (5, 0, 7, "nk", "tile"), (1, 1, 1, "kn", "small"),
])
def test_gemm_plan_edges(m, k, n, layout, path):
    plan = conv.gemm_plan(m, n, k, layout, (0, 0))
    assert plan.path == path
    check_plan(plan, m, n, k)


@pytest.mark.parametrize("ptrs, k, a_vec, b_vec", [
    ((0, 0), 64, True, True), ((4, 0), 64, False, True), ((0, 8), 64, True, False), ((0, 0), 27, False, False),
])
def test_gemm_plan_takes_16_byte_copies_only_of_aligned_rows(ptrs, k, a_vec, b_vec):
    plan = conv.gemm_plan(100, 64, k, "nk", ptrs)
    assert (plan.a_vec, plan.b_vec) == (a_vec, b_vec)


def test_gemm_plan_refuses_an_unknown_layout():
    with pytest.raises(ValueError, match="layout"):
        conv.gemm_plan(4, 4, 4, "kk", (0, 0))


# ---------------------------------------------------------------------------
# htree_plan
# ---------------------------------------------------------------------------


def test_htree_plan_mirrors_the_kernels_constants():
    text = (_build.CSRC / "htree_reduce.cu").read_text()
    assert re.search(rf"CHUNK_THREADS = {tht.HTREE_THREADS};", text)
    assert re.search(rf"MAX_CHUNKS = {tht.HTREE_MAX_CHUNKS};", text)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("n", [2**e for e in range(17)])
@pytest.mark.parametrize("d, ptr", [(65536, 0), (4, 0), (1000, 0), (1001, 0), (4096, 4), (1, 0)])
def test_htree_plan_chunks_are_aligned_subtrees_covering_n_once(n, d, ptr, itemsize):
    chunks, vec, blocks = tht.htree_plan(n, d, ptr, itemsize)
    assert chunks & (chunks - 1) == 0 and 1 <= chunks <= min(n, tht.HTREE_MAX_CHUNKS)
    rows = n // chunks
    spans = [(s * rows, (s + 1) * rows) for s in range(chunks)]
    assert spans[0][0] == 0 and spans[-1][1] == n and all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    # a subtree of the tree: a power-of-two span starting at a multiple of it
    assert rows & (rows - 1) == 0 and all(lo % rows == 0 for lo, _ in spans)
    lanes = 16 // itemsize  # columns in a 16-byte pack
    assert vec == (d % lanes == 0 and ptr % 16 == 0)
    groups = d // lanes if vec else d
    assert blocks * (tht.HTREE_THREADS // chunks) >= groups > (blocks - 1) * (tht.HTREE_THREADS // chunks)


def test_htree_plan_at_the_pimsab_tile():
    chunks, vec, blocks = tht.htree_plan(256, 65536, 0)
    assert vec and chunks * 16384 <= tht.HTREE_TARGET_THREADS < 2 * chunks * 16384


def chunked_tree(x, chunks):
    """The int32 kernel's order, in float32 numpy: each chunk's rows summed as
    their subtree (adjacent pairs first), then the chunk sums, adjacent chunks
    first."""
    def tree(rows):
        while rows.shape[0] > 1:
            rows = rows[0::2] + rows[1::2]
        return rows[0]
    n = x.shape[0]
    return tree(np.stack([tree(x[s * (n // chunks):(s + 1) * (n // chunks)]) for s in range(chunks)]))


@pytest.mark.parametrize("n, d", [(256, 64), (64, 1001), (2, 8), (1, 5)])
def test_chunked_order_is_the_tree_order_bit_for_bit_in_float32(n, d):
    """The chunked design keeps the H-tree's order, so float32 sums are the
    same bits as the plain version's (and so could take the design too)."""
    x = np.random.default_rng(n + d).standard_normal((n, d)).astype(np.float32)
    chunks = tht.htree_plan(n, d, 0)[0]
    want = tref.htree_reduce_ref(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(chunked_tree(x, chunks), want)


# ---------------------------------------------------------------------------
# conv2d with the weight as (OC, C·KH·KW)
# ---------------------------------------------------------------------------


def tiny_conv_cases():
    """(x shape, w shape, stride, padding) of TINY's convs at batch 2."""
    return [((2, 3, 8, 8), (8, 3, 3, 3), 1, 1), ((2, 8, 4, 4), (8, 8, 3, 3), 1, 1),
            ((2, 8, 4, 4), (16, 8, 3, 3), 2, 1), ((2, 16, 2, 2), (16, 16, 3, 3), 1, 1),
            ((2, 8, 4, 4), (16, 8, 1, 1), 2, 0)]


@pytest.mark.parametrize("backend", ["xla", "interpret"])
@pytest.mark.parametrize("case", range(5))
@pytest.mark.parametrize("channels_last", [False, True], ids=["contiguous", "channels-last"])
def test_conv2d_with_nk_weight_equals_jax(backend, case, channels_last):
    xs, ws, stride, padding = tiny_conv_cases()[case]
    x = rng_ints(xs, I32_MIN, I32_MAX, case)
    w = rng_ints(ws, -3, 3, 10 + case)
    with japi.use_backend(backend):
        want = np.asarray(japi.conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride, padding=padding))
    xt = torch.from_numpy(x)
    if channels_last:
        xt = xt.contiguous(memory_format=torch.channels_last)
    calls = []
    orig = conv._gemm

    def rec(a, b, layout="kn"):
        calls.append((tuple(b.shape), layout, b.is_contiguous()))
        return orig(a, b, layout)

    conv._gemm = rec
    try:
        got = tapi.conv2d(xt, torch.from_numpy(w), stride=stride, padding=padding)
    finally:
        conv._gemm = orig
    assert calls == [((ws[0], ws[1] * ws[2] * ws[3]), "nk", True)]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("backend", ["xla", "interpret"])
def test_tiny_forward_with_nk_weights_equals_jax(backend):
    from repro.models import resnet as jres

    with japi.use_backend(backend):
        want = np.asarray(jres.forward(jres.TINY, jres.init_params(jres.TINY, 0), jres.make_input(jres.TINY, 2)))
    got = tres.forward(tres.TINY, tres.init_params(tres.TINY, 0, device="cpu"),
                       tres.make_input(tres.TINY, 2, device="cpu"))
    np.testing.assert_array_equal(got.numpy(), want)
