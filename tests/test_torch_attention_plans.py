"""The launch plans of the port's softmax (K7) and p·V (K8) kernels
(``attention.softmax_plan``, ``attention.pv_plan``, ``csrc/attention.cu``),
on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``), but the way they split the work is plain Python and is
modelled here in numpy, in the kernels' order:

* p·V: each block's rows of T, each thread's rows within them (16 columns a
  thread on the packed path, a column a thread on the generic one), summed
  per warp, then across warps into the block's uint32 partial sums; the last
  block adds the blocks' partials in the lane groups it reads them in, and
  applies the shift once, to the full sum;
* softmax: each cluster block's slice of 16-byte chunks, its max and its
  uint32 sum of exponentials combined across the cluster, then the exact
  floor divide, or the rows kernel's whole-row passes.

The models must equal the JAX package's ``attention_pv`` and
``softmax_fixedpoint`` bit for bit, under ``use_backend("interpret")`` (the
Pallas bodies) and ``"xla"`` (the oracles), on inputs drawn with numpy from
fixed seeds; and the plans must cover every row of T and every score exactly
once, keep every thread of a packed block busy at the decode shape, and keep
the cluster within 16 blocks.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import api as japi  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import attention as tatt  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

I32_MIN, I32_MAX = -(2**31), 2**31 - 1
F, KK, FI = tref.SOFTMAX_F, tref.SOFTMAX_K, tref.SOFTMAX_FI
ALIGNED = 1 << 20  # an address on every boundary the plans ask about


def ints(shape, lo, hi, seed, dtype=np.int32):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(dtype)


def u32(a):
    return np.asarray(a).astype(np.int64).astype(np.uint32)


def i32(a):
    return np.asarray(a, dtype=np.uint32).view(np.int32)


# ---------------------------------------------------------------------------
# p·V: the plan's partition in numpy
# ---------------------------------------------------------------------------


def pv_model(p, v, shift, plan, coverage=None):
    """``(p @ v) >> shift`` the way ``csrc/attention.cu`` computes it under
    ``plan``: uint32 products, per-thread rows, warps, blocks, then the last
    block's lane groups.  ``coverage`` (length T) counts each row's visits."""
    m, t = p.shape
    dv = v.shape[1]
    groups = -(-m // plan.group)  # grid y
    pu, vu = u32(p), u32(v)
    partial = np.zeros((plan.blocks, plan.npad), np.uint32)
    if plan.packed:
        lanes = dv // 16
        warp_rows = 32 // lanes  # thread rows s of one warp: s // warp_rows is its warp
        warps = tatt.PV_THREADS // 32
    else:
        lanes = tatt.PV_THREADS // min(dv, tatt.PV_THREADS)  # threads on a column
        warp_rows, warps = 1, lanes  # a column's threads, added in shared memory in order
    step = plan.rows_per_step
    for b in range(plan.blocks):
        r0, r1 = b * plan.rows_per_block, min(t, (b + 1) * plan.rows_per_block)
        rows = np.arange(r0, max(r0, r1))
        if coverage is not None:
            np.add.at(coverage, rows, groups)
        s = (rows - r0) % step  # the thread row that reads each row
        for g0 in range(0, m, plan.group):
            mg = min(plan.group, m - g0)
            prod = pu[g0:g0 + mg, rows][:, :, None] * vu[rows][None, :, :]  # (mg, rows, dv) uint32
            block = np.zeros((mg, dv), np.uint32)
            for w in range(warps):
                mine = (s // warp_rows) == w
                block += prod[:, mine].sum(axis=1, dtype=np.uint32)
            partial[b, g0 * dv:(g0 + mg) * dv] = block.reshape(-1)
    nq = plan.npad // 4
    quads = partial.reshape(plan.blocks, nq, 4)
    groups = tatt.PV_THREADS // nq if nq < tatt.PV_THREADS else 1
    total = np.zeros((nq, 4), np.uint32)
    for g in range(groups):  # lane group g adds blocks g, g + groups, ...; then groups in order
        total += quads[g::groups].sum(axis=0, dtype=np.uint32)
    sh = shift if 0 <= shift <= 31 else 31
    return i32(total.reshape(-1)[:m * dv]).reshape(m, dv) >> sh


def plan_for(p, v, v_ptr=ALIGNED):
    return tatt.pv_plan(p.shape[0], p.shape[1], v.shape[1], p.dtype.itemsize, v.dtype.itemsize, (ALIGNED, v_ptr))


def softmax_scores(m, seed, t=32768, d=64):
    """int32 scores of m int8 queries against a t-row int8 key cache."""
    q = ints((m, d), -128, 128, seed).astype(np.int64)
    k = ints((t, d), -128, 128, seed + 1).astype(np.int64)
    return (q @ k.T).astype(np.int32)


def decode_probs(m, seed):
    """The decode step's probabilities: the JAX oracle's softmax of its scores."""
    return np.array(jref.softmax_fixedpoint_ref(jnp.asarray(softmax_scores(m, seed)), in_frac=13))


# name → (p, v, shift, whether the packed kernel takes it)
PV = {
    "decode-M1-T32768": lambda: (decode_probs(1, 300), ints((32768, 64), -128, 128, 302, np.int8), 6, True),
    "decode-gqa-M7-T32768": lambda: (decode_probs(7, 303), ints((32768, 64), -128, 128, 305, np.int8), 6, True),
    "T-ragged-1000": lambda: (ints((1, 1000), 0, 64, 306), ints((1000, 64), -128, 128, 307, np.int8), 6, True),
    "T1": lambda: (ints((1, 1), 0, 64, 308), ints((1, 64), -128, 128, 309, np.int8), 6, True),
    "T-below-a-warp-5": lambda: (ints((2, 5), 0, 64, 310), ints((5, 64), -128, 128, 311, np.int8), 6, True),
    "M9-three-groups": lambda: (ints((9, 1000), 0, 64, 312), ints((1000, 64), -128, 128, 313, np.int8), 6, True),
    "int32-wrap-shift0": lambda: (ints((2, 3000), I32_MIN, I32_MAX, 314), ints((3000, 64), -128, 128, 315, np.int8),
                                  0, True),
    "int32-wrap-shift31": lambda: (ints((2, 3000), I32_MIN, I32_MAX, 316), ints((3000, 64), -128, 128, 317, np.int8),
                                   31, True),
    "int32-wrap-shift40": lambda: (ints((2, 3000), I32_MIN, I32_MAX, 318), ints((3000, 64), -128, 128, 319, np.int8),
                                   40, True),
    "int32-v-wrap-shift31": lambda: (ints((2, 600), I32_MIN, I32_MAX, 320), ints((600, 6), I32_MIN, I32_MAX, 321),
                                     31, False),
    "int8-p": lambda: (ints((3, 4096), -128, 128, 322, np.int8), ints((4096, 64), -128, 128, 323, np.int8), 2, False),
    "Dv16-packed": lambda: (ints((3, 777), 0, 64, 324), ints((777, 16), -128, 128, 325, np.int8), 6, True),
    "Dv48-generic": lambda: (ints((2, 700), 0, 64, 326), ints((700, 48), -128, 128, 327, np.int8), 6, False),
    "Dv300-generic": lambda: (ints((2, 400), 0, 64, 328), ints((400, 300), -128, 128, 329, np.int8), 6, False),
}


@pytest.mark.parametrize("case", sorted(PV))
def test_pv_model_equals_jax_pallas_body_and_oracle(case):
    p, v, shift, packed = PV[case]()
    plan = plan_for(p, v)
    assert plan.packed == packed
    got = pv_model(p, v, shift, plan)
    with japi.use_backend("interpret"):
        body = np.asarray(japi.attention_pv(jnp.asarray(p), jnp.asarray(v), shift=shift))
    with japi.use_backend("xla"):
        oracle = np.asarray(japi.attention_pv(jnp.asarray(p), jnp.asarray(v), shift=shift))
    np.testing.assert_array_equal(got, body)
    np.testing.assert_array_equal(got, oracle)
    # and the port's wrapper on CPU tensors (the kernel's plain version)
    np.testing.assert_array_equal(tatt._pv(torch.from_numpy(p), torch.from_numpy(v), shift).numpy(), oracle)


def test_pv_model_with_a_value_cache_off_16_bytes_takes_the_generic_kernel():
    p, v = ints((1, 4096), 0, 64, 330), ints((4096, 64), -128, 128, 331, np.int8)
    plan = plan_for(p, v, v_ptr=ALIGNED + 1)
    assert not plan.packed
    with japi.use_backend("xla"):
        oracle = np.asarray(japi.attention_pv(jnp.asarray(p), jnp.asarray(v), shift=6))
    np.testing.assert_array_equal(pv_model(p, v, 6, plan), oracle)


@pytest.mark.parametrize("m,t,dv,p_bytes,v_bytes", [
    (1, 32768, 64, 4, 1), (7, 32768, 64, 4, 1), (9, 1000, 64, 4, 1), (1, 1, 64, 4, 1), (2, 5, 64, 4, 1),
    (1, 32767, 64, 4, 1), (3, 777, 16, 4, 1), (4, 999, 256, 4, 1), (2, 700, 48, 4, 1), (2, 400, 300, 4, 1),
    (1, 32768, 64, 4, 4), (3, 4096, 64, 1, 1), (1, 100000, 128, 4, 1),
])
def test_pv_plan_covers_every_row_once(m, t, dv, p_bytes, v_bytes):
    plan = tatt.pv_plan(m, t, dv, p_bytes, v_bytes, (ALIGNED, ALIGNED))
    assert plan.rows_per_block % plan.rows_per_step == 0
    assert plan.blocks * plan.rows_per_block >= t > (plan.blocks - 1) * plan.rows_per_block
    assert plan.group == (m if m <= 2 else tatt.PV_MAX_GROUP)
    assert plan.npad % 4 == 0 and m * dv <= plan.npad < m * dv + 4
    p = np.zeros((m, t), np.int32 if p_bytes == 4 else np.int8)
    v = np.zeros((t, dv), np.int32 if v_bytes == 4 else np.int8)
    coverage = np.zeros(t, np.int64)
    pv_model(p, v, 0, plan, coverage)
    assert (coverage == -(-m // plan.group)).all()  # each group of queries reads each row once


@pytest.mark.parametrize("t", [32768, 4096])
def test_pv_packed_blocks_keep_every_thread_busy_at_the_decode_shape(t):
    plan = tatt.pv_plan(1, t, 64, 4, 1, (ALIGNED, ALIGNED))
    assert plan.packed and plan.group == 1
    assert plan.rows_per_step * (64 // 16) == tatt.PV_THREADS  # a thread for every 16 columns of a step's rows
    assert t % plan.rows_per_block == 0  # every block has whole steps: no thread idles
    assert plan.blocks <= tatt.PV_TARGET_BLOCKS  # one wave on the card's SMs


@pytest.mark.parametrize("why,args", [
    ("int8 p", (1, 4096, 64, 1, 1, (ALIGNED, ALIGNED))),
    ("int32 v", (1, 4096, 64, 4, 4, (ALIGNED, ALIGNED))),
    ("Dv 48: three 16-byte pieces a row do not divide a warp", (1, 4096, 48, 4, 1, (ALIGNED, ALIGNED))),
    ("Dv 8", (1, 4096, 8, 4, 1, (ALIGNED, ALIGNED))),
    ("Dv 512: past the packed kernel's shared memory", (1, 4096, 512, 4, 1, (ALIGNED, ALIGNED))),
    ("v off 16 bytes", (1, 4096, 64, 4, 1, (ALIGNED, ALIGNED + 8))),
])
def test_pv_plan_sends_the_rest_to_the_generic_kernel(why, args):
    plan = tatt.pv_plan(*args)
    assert not plan.packed, why
    assert plan.rows_per_step == tatt.PV_THREADS // min(args[2], tatt.PV_THREADS)


# ---------------------------------------------------------------------------
# softmax: the plan's partition in numpy
# ---------------------------------------------------------------------------


def softmax_w(x, mx, sigma):
    """The kernel's exponential of int32 scores ``x`` against row max ``mx``."""
    lo = -(1 << (F + sigma))
    tt = i32(u32(x) - u32(mx))
    u = np.maximum(tt, lo) >> sigma
    sq = i32(u32(u) * u32(u)) >> (F + 1)
    w = i32(u32(u) + np.uint32(1 << F) + u32(sq))
    for _ in range(KK):
        w = i32(u32(w) * u32(w)) >> F
    return w


def floor_div(n, s):
    """The kernel's exact floor division (0 for a zero sum)."""
    return 0 if s == 0 else n // s


def softmax_model(x, in_frac, plan, coverage=None):
    """The fixed-point softmax the way ``csrc/attention.cu`` computes it
    under ``plan``; ``coverage`` (shape of x) counts each score's reads into
    a block's slice."""
    sigma = tref.softmax_sigma(in_frac)
    r, t = x.shape
    if plan.cluster == 0:  # the rows kernel: a warp a whole row
        slices = [(0, t)]
    else:  # a cluster block's 16-byte chunks of the row, as scores
        per_chunk = 16 // x.dtype.itemsize
        chunks = -(-t // per_chunk)
        slices = [(min(t, b * plan.chunks_per_block * per_chunk),
                   min(t, min(chunks, (b + 1) * plan.chunks_per_block) * per_chunk)) for b in range(plan.cluster)]
    x = x.astype(np.int32)
    out = np.zeros((r, t), np.int32)
    for row in range(r):
        maxes = [x[row, a:b].max() if b > a else I32_MIN for a, b in slices]
        mx = np.int32(max(maxes))
        w = softmax_w(x[row], mx, sigma)
        sums = np.array([u32(w[a:b]).sum(dtype=np.uint32) for a, b in slices], np.uint32)
        qn = floor_div(1 << (FI + F), int(i32(sums.sum(dtype=np.uint32, keepdims=True))[0]))
        out[row] = i32(u32(w) * np.uint32(qn & 0xFFFFFFFF)) >> FI
        if coverage is not None:
            for a, b in slices:
                coverage[row, a:b] += 1
    return out


def sm_plan(x, ptr=ALIGNED):
    return tatt.softmax_plan(x.shape[0], x.shape[1], x.dtype.itemsize, ptr)


# name → (scores, in_frac, path: rows / registers / loop)
SOFTMAX = {
    "decode-M1-T32768": lambda: (softmax_scores(1, 340), 13, "registers"),
    "decode-gqa-M7-T32768": lambda: (softmax_scores(7, 342), 13, "registers"),
    "short-rows-3x100": lambda: (ints((3, 100), -50, 50, 344), 3, "rows"),
    "short-rows-5x300": lambda: (ints((5, 300), -2**20, 2**20, 345), 13, "rows"),
    "64-rows-of-T8": lambda: (ints((64, 8), -2**16, 2**16, 346), 13, "rows"),
    "T1": lambda: (ints((1, 1), -50, 50, 347), 13, "rows"),
    "T-below-a-warp-20": lambda: (ints((3, 20), -2**20, 2**20, 348), 13, "rows"),
    "cluster-of-one-T513": lambda: (ints((3, 513), -2**18, 2**18, 349), 13, "registers"),
    "ragged-T4099": lambda: (ints((3, 4099), -2**20, 2**20, 350), 13, "registers"),
    "past-the-registers-T70000": lambda: (ints((1, 70000), -2**20, 2**20, 351), 13, "loop"),
    "int8-scores-T32768": lambda: (ints((2, 32768), -128, 128, 352, np.int8), 5, "registers"),
    "int8-past-the-registers-T70000": lambda: (ints((1, 70000), -128, 128, 353, np.int8), 5, "loop"),
}

# Rows where the Pallas body's restoring division wraps (2^17 near-equal
# scores) or x − max leaves int32: the port follows the oracle.
SOFTMAX_ORACLE_ONLY = {
    "equal-row-131072": lambda: (np.zeros((1, 131072), np.int32), 13, "loop"),
    "full-range-T32768": lambda: (ints((2, 32768), I32_MIN, I32_MAX, 354), 10, "registers"),
}


def _plan_path(plan):
    return "rows" if plan.cluster == 0 else "registers" if plan.regs else "loop"


@pytest.mark.parametrize("case", sorted(SOFTMAX))
def test_softmax_model_equals_jax_pallas_body_and_oracle(case):
    x, in_frac, path = SOFTMAX[case]()
    plan = sm_plan(x)
    assert _plan_path(plan) == path
    got = softmax_model(x, in_frac, plan)
    with japi.use_backend("interpret"):
        body = np.asarray(japi.softmax_fixedpoint(jnp.asarray(x), in_frac=in_frac))
    with japi.use_backend("xla"):
        oracle = np.asarray(japi.softmax_fixedpoint(jnp.asarray(x), in_frac=in_frac))
    np.testing.assert_array_equal(got, body)
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(tatt._softmax(torch.from_numpy(x), tref.softmax_sigma(in_frac)).numpy(), oracle)


@pytest.mark.parametrize("case", sorted(SOFTMAX_ORACLE_ONLY))
def test_softmax_model_equals_jax_oracle_where_the_pallas_body_wraps(case):
    x, in_frac, path = SOFTMAX_ORACLE_ONLY[case]()
    plan = sm_plan(x)
    assert _plan_path(plan) == path
    got = softmax_model(x, in_frac, plan)
    with japi.use_backend("xla"):
        oracle = np.asarray(japi.softmax_fixedpoint(jnp.asarray(x), in_frac=in_frac))
    np.testing.assert_array_equal(got, oracle)
    if case == "equal-row-131072":
        assert not got.any()  # 2^14 // 2^23: the exact divide gives 0


def test_softmax_model_on_a_row_of_2_to_the_20():
    """The loop path at 2^20 columns, against the oracle (the Pallas body's
    division wraps once the row sum passes 2^23)."""
    x = ints((1, 2**20), -2**20, 2**20, 355)
    plan = sm_plan(x)
    assert _plan_path(plan) == "loop" and plan.cluster == tatt.SOFTMAX_MAX_CLUSTER
    want = tref.softmax_fixedpoint_ref(torch.from_numpy(x), in_frac=13).numpy()
    np.testing.assert_array_equal(softmax_model(x, 13, plan), want)


@pytest.mark.parametrize("r,t,x_bytes", [
    (1, 32768, 4), (7, 32768, 4), (3, 100, 4), (64, 8, 4), (1, 1, 4), (3, 513, 4), (3, 4099, 4), (1, 65536, 4),
    (1, 65537, 4), (2, 70000, 4), (1, 2**20, 4), (1, 2**25 - 1, 4), (2, 32768, 1), (1, 70000, 1), (2, 4097, 1),
    (70000, 600, 4),
])
def test_softmax_plan_covers_every_score_once_in_at_most_16_blocks(r, t, x_bytes):
    plan = tatt.softmax_plan(r, t, x_bytes, ALIGNED)
    if t <= tatt.SOFTMAX_ROW_MAX_COLS:
        assert plan.cluster == 0 and plan.blocks * tatt.SOFTMAX_ROW_WARPS >= r
        return
    per_chunk = 16 // x_bytes
    chunks = -(-t // per_chunk)
    assert 1 <= plan.cluster <= tatt.SOFTMAX_MAX_CLUSTER
    assert plan.cluster * plan.chunks_per_block >= chunks > (plan.cluster - 1) * plan.chunks_per_block
    assert plan.blocks == min(r, tatt.SOFTMAX_MAX_GRID_Y)
    # a thread keeps its chunks in registers only when they fit
    per_thread = -(-plan.chunks_per_block // tatt.SOFTMAX_CLUSTER_THREADS) * per_chunk
    assert plan.regs == (per_thread <= tatt.SOFTMAX_CLUSTER_ELEMS)
    if t <= 70000:
        coverage = np.zeros((1, t), np.int64)
        softmax_model(np.zeros((1, t), np.int32 if x_bytes == 4 else np.int8), 13, plan, coverage)
        assert (coverage == 1).all()


def test_softmax_plan_spreads_the_decode_row_over_16_sms():
    plan = tatt.softmax_plan(1, 32768, 4, ALIGNED)
    assert plan == tatt.SoftmaxPlan(16, 512, True, True, 1)
    assert plan.chunks_per_block * 4 // tatt.SOFTMAX_CLUSTER_THREADS == tatt.SOFTMAX_TARGET_ELEMS


@pytest.mark.parametrize("t,x_bytes,ptr,vec", [
    (32768, 4, ALIGNED, True), (32768, 4, ALIGNED + 4, False), (4099, 4, ALIGNED, False),
    (4096, 1, ALIGNED, True), (4097, 1, ALIGNED, False), (4096, 1, ALIGNED + 1, False),
])
def test_softmax_plan_reads_16_bytes_only_where_aligned(t, x_bytes, ptr, vec):
    assert tatt.softmax_plan(2, t, x_bytes, ptr).vec is vec


# ---------------------------------------------------------------------------
# the plans against the kernels' constants and the C entry points
# ---------------------------------------------------------------------------


def test_plans_mirror_the_kernels_constants():
    src = (Path(_build.CSRC) / "attention.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("PV_THREADS") == tatt.PV_THREADS
    assert const("PV_UNROLL") == tatt.PV_UNROLL
    assert const("PV_MAX_GROUP") == tatt.PV_MAX_GROUP
    assert const("PV_PACKED_MAX_DV") == tatt.PV_PACKED_MAX_DV
    assert const("SM_ROW_WARPS") == tatt.SOFTMAX_ROW_WARPS
    assert const("SMC_THREADS") == tatt.SOFTMAX_CLUSTER_THREADS
    assert const("SMC_ELEMS") == tatt.SOFTMAX_CLUSTER_ELEMS
    assert const("SMC_MAX_CLUSTER") == tatt.SOFTMAX_MAX_CLUSTER


class _CardLike(str):
    """A device that allocates on the CPU but is not ``"cpu"`` to the
    wrappers, so that they take their kernel path (with a recorded launch)."""

    type = "cuda"


@pytest.mark.parametrize("call", ["softmax-rows", "softmax-cluster", "pv-packed", "pv-generic"])
def test_wrappers_pass_what_the_entry_points_declare(monkeypatch, call):
    launched = []
    monkeypatch.setattr(tatt, "kernel_device", lambda *ts: _CardLike("cpu"))
    monkeypatch.setattr(tatt, "_pv_ticket", lambda dev: torch.zeros(1, dtype=torch.int32))
    monkeypatch.setattr(tatt._build, "launch", lambda name, dev, *args: launched.append((name, args)))
    sigma = tref.softmax_sigma(13)
    if call == "softmax-rows":
        tatt._softmax(torch.zeros((3, 100), dtype=torch.int32), sigma)
    elif call == "softmax-cluster":
        tatt._softmax(torch.zeros((1, 32768), dtype=torch.int32), sigma)
    elif call == "pv-packed":
        tatt._pv(torch.zeros((1, 4096), dtype=torch.int32), torch.zeros((4096, 64), dtype=torch.int8), 6)
    else:
        tatt._pv(torch.zeros((1, 4096), dtype=torch.int8), torch.zeros((4096, 64), dtype=torch.int8), 6)
    ((name, args),) = launched
    assert len(args) + 1 == len(_build.ENTRY_POINTS[name][1])  # + the stream
    if name == "attention_pv":
        packed = args[11]
        assert packed == int(call == "pv-packed")
    else:
        cluster = args[6]
        assert (cluster == 0) == (call == "softmax-rows")
