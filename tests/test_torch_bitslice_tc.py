"""The schedules and launch plans of the bit-sliced GEMM's tensor-core path
(``csrc/bitslice_gemm.cu``) and of K1's float32 GEMM (``csrc/int_gemm.cu``),
on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``), but what they compute can be modelled here:

* a numpy model of the tensor-core schedule (the plan's tiles; the staged
  slices; one s32 accumulator per local diagonal, fed 32 K at a time as
  ``mma.sync`` m16n8k32 does, folded into the uint32 output tile every
  ``fold_k``) must equal JAX's ``bitslice_matmul`` (its Pallas body under
  ``"interpret"``, its oracle under ``"xla"``) bit for bit, and asserts
  that no accumulator ever leaves the s32 range;
* ``bitslice_matmul.bitslice_plan`` sends every preset at the card's main
  shapes to the tensor cores and the rest to ``__dp4a``;
* a numpy model of the float32 kernel's tiling and its ordered split-K sum,
  and ``conv.gemm_f32_plan``, held to JAX's float32 ``_blocked_matmul``.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import api as japi  # noqa: E402
from repro.kernels import conv as jconv  # noqa: E402
from repro_torch.kernels import _build, conv  # noqa: E402
from repro_torch.kernels import api as tapi  # noqa: E402
from repro_torch.kernels import bitslice_matmul as tbm  # noqa: E402

I32_MIN, I32_MAX = -(2**31), 2**31 - 1
MMA_K = 32  # K of one mma.sync m16n8k32 step


# ---------------------------------------------------------------------------
# a numpy model of the tensor-core schedule
# ---------------------------------------------------------------------------


def mma_model(x, w, slice_bits, pairs, plan, stats=None):
    """``Σ_{(s,t) in pairs} (x[s] @ w[t]) << slice_bits·(s+t)`` mod 2**32 of
    int8 stacks ``x (Sx, M, K)`` and ``w (Sw, K, N)`` the way the tensor-core
    path computes it under ``plan``: per output tile, the staged slices' pairs
    summed per local diagonal i + j in an accumulator that must stay in s32
    after every 32-wide K step, folded (shifted, added in uint32) into the
    tile after every ``plan.fold_k`` of K and at the end.  ``stats`` collects
    the largest accumulator magnitude."""
    assert plan.path == "mma"
    bm, bn, _ = tbm.BITSLICE_MMA_TILES[plan.tile]
    xs, ws = list(plan.x_slices), list(plan.w_slices)
    assert {(s, t) for s in xs for t in ws} == {p for p in pairs if slice_bits * sum(p) < 32}
    _, m, k = x.shape
    n = w.shape[2]
    out = np.zeros((m, n), np.uint64)
    for r0 in range(0, m, bm):
        for c0 in range(0, n, bn):
            xt = [x[s, r0:r0 + bm].astype(np.int64) for s in xs]
            wt = [w[t, :, c0:c0 + bn].astype(np.int64) for t in ws]
            tile = np.zeros((xt[0].shape[0], wt[0].shape[1]), np.uint64)
            for kb in range(0, max(k, 1), plan.fold_k):
                acc = np.zeros((len(plan.shifts),) + tile.shape, np.int64)
                for k0 in range(kb, min(k, kb + plan.fold_k), MMA_K):
                    for i, xi in enumerate(xt):
                        for j, wj in enumerate(wt):
                            acc[i + j] += xi[:, k0:k0 + MMA_K] @ wj[k0:k0 + MMA_K]
                    assert acc.min(initial=0) >= I32_MIN and acc.max(initial=0) <= I32_MAX, "s32 overflow"
                    if stats is not None:
                        stats["max_abs"] = max(stats.get("max_abs", 0), int(np.abs(acc).max(initial=0)))
                for e, shift in enumerate(plan.shifts):
                    tile += (acc[e].astype(np.uint64) & 0xFFFFFFFF) << np.uint64(shift)
                tile &= 0xFFFFFFFF
            out[r0:r0 + bm, c0:c0 + bn] = tile
    return out.astype(np.uint32).view(np.int32)


def stacks(sx, m, k, sw, n, slice_bits, seed):
    half = 1 << (slice_bits - 1)
    rng = np.random.default_rng(seed)
    return (rng.integers(-half, half, (sx, m, k)).astype(np.int8),
            rng.integers(-half, half, (sw, k, n)).astype(np.int8))


def plan_of(x, w, slice_bits, pairs, ptrs=(0, 0)):
    (sx, m, k), (sw, _, n) = x.shape, w.shape
    return tbm.bitslice_plan(sx, sw, m, n, k, slice_bits, pairs, ptrs)


# (sx, sw) of each preset's stacks (slice_bits 8); zero-skip: int16 stacks
# whose high activation slice is all zero, so its two pairs are skipped
PRESET_SLICES = {name: (getattr(tapi.PrecisionSpec, name).act_slices, getattr(tapi.PrecisionSpec, name).weight_slices)
                 for name in ("int4", "int8", "int12", "int16", "w4a8", "w8a16")}

# name → (sx, m, k, sw, n, slice_bits, skip); shapes divide the (64, 64, 64)
# block of the Pallas body
INTERPRET_CASES = {
    **{f"{name}-M128-K128-N64": (sx, 128, 128, sw, 64, 8, ()) for name, (sx, sw) in PRESET_SLICES.items()},
    "zero-skip-M64-K192-N128": (2, 64, 192, 2, 128, 8, ((1, 0), (1, 1))),
    "narrow-w8a16-M256-K64-N32": (2, 256, 64, 1, 32, 8, ()),
}


@pytest.mark.parametrize("case", sorted(INTERPRET_CASES))
def test_mma_model_equals_jax_pallas_body(case):
    sx, m, k, sw, n, sb, skip = INTERPRET_CASES[case]
    x, w = stacks(sx, m, k, sw, n, sb, len(case))
    pairs = japi.active_pairs(sx, sw, skip)
    with japi.use_backend("interpret"):
        want = japi.dispatch("bitslice_matmul", jnp.asarray(x), jnp.asarray(w), slice_bits=sb, skip=skip,
                             pallas_kwargs={"block": (64, 64, 64)})
    plan = plan_of(x, w, sb, pairs)
    assert plan.path == "mma"
    np.testing.assert_array_equal(mma_model(x, w, sb, pairs, plan), np.asarray(want))


# ragged shapes, shifts of 32 or more and wrapping products, against JAX's
# oracle: name → (sx, m, k, sw, n, slice_bits, skip)
ORACLE_CASES = {
    "int8-ragged-M37-K48-N44": (1, 37, 48, 1, 44, 8, ()),
    "int16-ragged-M130-K80-N36": (2, 130, 80, 2, 36, 8, ()),
    "w8a16-narrow-M200-K208-N20": (2, 200, 208, 1, 20, 8, ()),
    "zero-skip-ragged-M70-K32-N100": (2, 70, 32, 2, 100, 8, ((1, 0), (1, 1))),
    # sb 4, 6 x 5 slices: only x slices 4-5 and w slices 3-4 left, whose
    # shifts are 28, 32, 32 and 36: one pair computed, shifted by 28
    "sb4-shifts-past-32": (6, 40, 48, 5, 24, 4,
                           tuple((s, t) for s in range(6) for t in range(5) if s < 4 or t < 3)),
    # sb 1, 20 x 18 slices: x slices 14-15 and w slices 15-16 left, shifts
    # 29, 30, 30 and 31: a 2 x 2 schedule whose top diagonal wraps
    "sb1-shifts-29-to-31": (20, 33, 64, 18, 12, 1,
                            tuple((s, t) for s in range(20) for t in range(18)
                                  if s not in (14, 15) or t not in (15, 16))),
}


@pytest.mark.parametrize("case", sorted(ORACLE_CASES))
def test_mma_model_equals_jax_oracle(case):
    sx, m, k, sw, n, sb, skip = ORACLE_CASES[case]
    x, w = stacks(sx, m, k, sw, n, sb, len(case) + 3)
    pairs = japi.active_pairs(sx, sw, skip)
    with japi.use_backend("xla"):
        want = japi.dispatch("bitslice_matmul", jnp.asarray(x), jnp.asarray(w), slice_bits=sb, skip=skip)
    plan = plan_of(x, w, sb, pairs)
    assert plan.path == "mma", plan
    got = mma_model(x, w, sb, pairs, plan)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, tbm._bitslice_plain(torch.from_numpy(x), torch.from_numpy(w), sb,
                                                           pairs).numpy())


@pytest.mark.parametrize("sx, sw", [(1, 1), (2, 1), (2, 2)])
def test_mma_model_all_minus_128_products_wrap(sx, sw):
    """All -128 slices: every product is 2**14 and the shifted sums wrap
    mod 2**32; the model equals the oracle."""
    x = np.full((sx, 40, 1024), -128, np.int8)
    w = np.full((sw, 1024, 36), -128, np.int8)
    pairs = japi.active_pairs(sx, sw)
    with japi.use_backend("xla"):
        want = np.asarray(japi.dispatch("bitslice_matmul", jnp.asarray(x), jnp.asarray(w), slice_bits=8))
    np.testing.assert_array_equal(mma_model(x, w, 8, pairs, plan_of(x, w, 8, pairs)), want)


@pytest.mark.parametrize("sx, sw", [(1, 1), (2, 2)])
def test_mma_accumulators_stay_in_s32_at_k_past_2_to_the_17(sx, sw):
    """K = 2**17 + 32 of all -128 slices (the worst case: every product
    +2**14, two pairs on the 2 × 2 middle diagonal): under the plan's fold
    interval every accumulator stays in s32 and the result equals the
    plain version; one K range over all of K would leave it."""
    k = 2**17 + 32
    x = np.full((sx, 2, k), -128, np.int8)
    w = np.full((sw, k, 4), -128, np.int8)
    pairs = tapi.active_pairs(sx, sw)
    plan = plan_of(x, w, 8, pairs)
    assert plan.path == "mma" and plan.fold_k < k
    stats = {}
    got = mma_model(x, w, 8, pairs, plan, stats)
    np.testing.assert_array_equal(got, tbm._bitslice_plain(torch.from_numpy(x), torch.from_numpy(w), 8,
                                                           pairs).numpy())
    per_diagonal = 2 if sx == sw == 2 else 1
    assert stats["max_abs"] == plan.fold_k * per_diagonal * 2**14 <= I32_MAX
    with pytest.raises(AssertionError, match="s32 overflow"):
        mma_model(x, w, 8, pairs, plan._replace(fold_k=k))


def test_fold_interval_is_the_largest_exact_one():
    for sx, sw, per_diagonal in ((1, 1, 1), (2, 1, 1), (1, 2, 1), (2, 2, 2)):
        plan = tbm.bitslice_plan(sx, sw, 64, 64, 64, 8, tapi.active_pairs(sx, sw), (0, 0))
        bk = tbm.BITSLICE_MMA_BK
        assert plan.fold_k % bk == 0
        assert plan.fold_k * per_diagonal <= tbm.BITSLICE_FOLD_LP < (plan.fold_k + bk) * per_diagonal
        assert tbm.BITSLICE_FOLD_LP * 2**14 < 2**31 <= (tbm.BITSLICE_FOLD_LP + 1) * 2**14


# ---------------------------------------------------------------------------
# bitslice_plan
# ---------------------------------------------------------------------------


def test_bitslice_plan_mirrors_the_kernels_constants():
    text = (_build.CSRC / "bitslice_gemm.cu").read_text()
    for name, value in (("BK", tbm.BITSLICE_MMA_BK), ("STAGES", tbm.BITSLICE_MMA_STAGES)):
        assert re.search(rf"constexpr int {name} = {value};", text), name
    assert "constexpr int FOLD_LP = (1 << 17) - 1;" in text and tbm.BITSLICE_FOLD_LP == (1 << 17) - 1
    bm, bn, wm = tbm.BITSLICE_MMA_TILES["narrow"]
    assert f"if (narrow) return launch_mma<Out, NX, NW, {bm}, {bn}, {wm}>" in text
    bm, bn, wm = tbm.BITSLICE_MMA_TILES["square_2x2"]
    assert f"if constexpr (NX * NW == 4) return launch_mma<Out, NX, NW, {bm}, {bn}, {wm}>" in text
    bm, bn, wm = tbm.BITSLICE_MMA_TILES["square"]
    assert f"else return launch_mma<Out, NX, NW, {bm}, {bn}, {wm}>" in text
    assert re.search(r"constexpr int MAX_PAIRS = 1024;", text) and tbm.MAX_PAIRS == 1024
    codes = {torch.float32: "F32", torch.bfloat16: "BF16", torch.float16: "F16"}
    assert "constexpr int DT_NONE = 0, " + ", ".join(
        f"DT_{codes[dt]} = {c}" for dt, c in sorted(tbm.DTYPE_CODES.items(), key=lambda i: i[1])) + ";" in text
    assert tbm.ONE_PAIR_FOLD_K == tbm.bitslice_plan(1, 1, 1, 4, 16, 8, tbm.ONE_PAIR, (0, 0)).fold_k


TABLE3 = (61440, 2048, 32)  # chip_smoke.py phase 3c: (M, K, N)
QLR = (4096, 896, 4864)     # phase 3d: quant_linear_relu at Qwen2-0.5B's MLP width


@pytest.mark.parametrize("name", ["int4", "int8", "int16", "w8a16", "zero-skip", "quant_linear_relu"])
def test_bitslice_plan_sends_the_card_paths_to_the_tensor_cores(name):
    m, k, n = QLR if name == "quant_linear_relu" else TABLE3
    sx, sw = {"zero-skip": (2, 2), "quant_linear_relu": PRESET_SLICES["w8a16"]}.get(name) or PRESET_SLICES[name]
    skip = ((1, 0), (1, 1)) if name == "zero-skip" else ()
    plan = tbm.bitslice_plan(sx, sw, m, n, k, 8, tapi.active_pairs(sx, sw, skip), (0, 512))
    assert plan.path == "mma" and plan.w_vec and tbm.BITSLICE_MMA_STAGES >= 3
    assert plan.tile == ("square" if name == "quant_linear_relu" else "narrow")
    assert plan.x_slices == ((0,) if name in ("int4", "int8", "zero-skip") else (0, 1))
    assert plan.shifts == tuple(8 * d for d in range(len(plan.x_slices) + len(plan.w_slices) - 1))
    bm, bn, _ = tbm.BITSLICE_MMA_TILES[plan.tile]
    blocks = -(-m // bm) * -(-n // bn)
    assert blocks == (1216 if name == "quant_linear_relu" else 480)


# name → (sx, sw, m, n, k, slice_bits, skip, ptrs)
DP4A_CASES = {
    "ragged-K40": (1, 1, 64, 64, 40, 8, (), (0, 0)),
    "ragged-K27": (2, 2, 77, 70, 27, 8, (), (0, 0)),
    "x-off-16-bytes": (2, 1, 64, 64, 64, 8, (), (4, 0)),
    "x-off-4-bytes": (2, 1, 64, 64, 64, 8, (), (1, 0)),
    "w-off-4-bytes": (1, 1, 64, 64, 64, 8, (), (0, 2)),
    "N-not-a-multiple-of-4": (2, 1, 64, 30, 64, 8, (), (0, 0)),
    "sb1-1024-pairs": (32, 32, 17, 9, 64, 1, (), (0, 0)),
    "sb4-6x5-slices": (6, 5, 50, 40, 64, 4, (), (0, 0)),
    "3-of-4-pairs": (2, 2, 64, 64, 64, 8, ((1, 1),), (0, 0)),
    "2x2-unequal-gaps": (3, 2, 64, 64, 64, 8, tuple((1, t) for t in range(2)), (0, 0)),
    "all-skipped": (2, 2, 32, 32, 32, 8, ((0, 0), (0, 1), (1, 0), (1, 1)), (0, 0)),
}


@pytest.mark.parametrize("case", sorted(DP4A_CASES))
def test_bitslice_plan_sends_the_rest_to_dp4a(case):
    sx, sw, m, n, k, sb, skip, ptrs = DP4A_CASES[case]
    plan = tbm.bitslice_plan(sx, sw, m, n, k, sb, tapi.active_pairs(sx, sw, skip), ptrs)
    assert plan.path == "dp4a"
    assert plan.x_words == (k % 4 == 0 and ptrs[0] % 4 == 0)


def test_bitslice_plan_copies_w_by_16_bytes_only_where_aligned():
    pairs = tapi.active_pairs(1, 1)
    assert tbm.bitslice_plan(1, 1, 64, 64, 64, 8, pairs, (0, 16)).w_vec
    assert not tbm.bitslice_plan(1, 1, 64, 64, 64, 8, pairs, (0, 4)).w_vec
    plan = tbm.bitslice_plan(1, 1, 64, 36, 64, 8, pairs, (0, 0))
    assert plan.path == "mma" and not plan.w_vec


# ---------------------------------------------------------------------------
# K1 float32: gemm_f32_plan and a model of its tiles and ordered split-K
# ---------------------------------------------------------------------------


def f32_model(a, b, layout, plan):
    """``a @ B`` in float32 the way the kernel's grid computes it: each
    128 × 64 tile over each K range of ``plan`` (every row, column and K
    index covered exactly once), the ranges' partial tiles added in split
    order."""
    bt = b.T if layout == "nk" else b
    (m, k), n = a.shape, bt.shape[1]
    tm, tn, _ = conv.GEMM_F32_TILE
    parts = np.zeros((plan.splits, m, n), np.float32)
    seen = np.zeros((plan.splits, m, n), np.int64)
    for z in range(plan.splits):
        kb, ke = z * plan.k_chunk, min(k, (z + 1) * plan.k_chunk)
        for r0 in range(0, m, tm):
            for c0 in range(0, n, tn):
                parts[z, r0:r0 + tm, c0:c0 + tn] = a[r0:r0 + tm, kb:ke] @ bt[kb:ke, c0:c0 + tn]
                seen[z, r0:r0 + tm, c0:c0 + tn] += max(ke - kb, 0)
    assert (seen.sum(0) == k).all()  # the tiles cover C, the ranges partition K
    out = parts[0].copy()
    for z in range(1, plan.splits):
        out += parts[z]
    return out


def test_gemm_f32_plan_mirrors_the_kernels_constants():
    text = (_build.CSRC / "int_gemm.cu").read_text()
    tm, tn, tk = conv.GEMM_F32_TILE
    assert f"constexpr int FBM = {tm}, FBN = {tn}, FBK = {tk};" in text
    assert f"constexpr int F_STAGES = {conv.GEMM_F32_STAGES};" in text


F32_SHAPES = [(2048, 2304, 256), (129, 27, 1000), (77, 4608, 130), (1000, 1001, 67), (5, 0, 7), (1, 1, 1)]


@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("m, k, n", F32_SHAPES)
def test_gemm_f32_plan_partitions_k_and_covers_c(m, k, n, layout):
    plan = conv.gemm_f32_plan(m, n, k, layout, (0, 0))
    assert plan.k_chunk % conv.GEMM_F32_TILE[2] == 0 and plan.splits >= 1
    assert (plan.splits - 1) * plan.k_chunk < max(k, 1) <= plan.splits * plan.k_chunk
    assert plan.b_vec == (layout == "kn" and n % 4 == 0)
    rng = np.random.default_rng(m + k + n)
    a = rng.integers(-8, 8, (m, k)).astype(np.float32)
    b = rng.integers(-3, 4, (n, k) if layout == "nk" else (k, n)).astype(np.float32)
    want = a @ (b.T if layout == "nk" else b)
    np.testing.assert_array_equal(f32_model(a, b, layout, plan), want)  # integer values: every sum exact


@pytest.mark.parametrize("layout", ["kn", "nk"])
def test_gemm_f32_plan_fills_the_card_at_resnet18_stage_3(layout):
    m, k, n = 2048, 2304, 256
    plan = conv.gemm_f32_plan(m, n, k, layout, (0, 0))
    tm, tn, _ = conv.GEMM_F32_TILE
    assert -(-m // tm) * -(-n // tn) * plan.splits >= 132
    assert plan.splits > 1 and plan.k_chunk >= conv.GEMM_F32_MIN_SPLIT_K


@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("m, k, n", [(256, 576, 128), (128, 4608, 64)])
def test_gemm_f32_model_equals_jax_blocked_matmul(m, k, n, layout):
    """The split-K model (the kernel's order of adds by ranges) against JAX's
    float32 ``_blocked_matmul`` run through its Pallas body, within the float
    tolerance of the JAX tests (normals scaled so outputs are of unit size)."""
    rng = np.random.default_rng(k)
    a = (rng.standard_normal((m, k)) * k ** -0.25).astype(np.float32)
    b = (rng.standard_normal((k, n)) * k ** -0.25).astype(np.float32)
    plan = conv.gemm_f32_plan(m, n, k, layout, (0, 0))
    assert plan.splits > 1
    want = np.array(jconv._blocked_matmul(jnp.asarray(a), jnp.asarray(b), (128, 64), interpret=True))
    got = f32_model(a, b.T.copy() if layout == "nk" else b, layout, plan)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(conv._gemm(torch.from_numpy(a), torch.from_numpy(b)), torch.from_numpy(want),
                               atol=1e-4, rtol=1e-4)


def test_gemm_f32_plan_refuses_an_unknown_layout():
    with pytest.raises(ValueError, match="layout"):
        conv.gemm_f32_plan(4, 4, 4, "kk", (0, 0))
