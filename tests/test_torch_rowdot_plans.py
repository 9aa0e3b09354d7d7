"""The launch plan of the port's row-dot kernel (``attention.rowdot_plan``,
``csrc/attention.cu`` ``rowdot``), which computes both q·Kᵀ (K6,
``attention_qk``) and the decode GEMV (K9, ``decode_gemv``), on the CPU.

The CUDA kernel runs only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``), but the way it splits the work is plain Python and is
modelled here in numpy, in the kernel's order: ``lanes · split`` threads a
row, each on the 16-byte chunks ``slot + i · span`` in batches of
``unroll``, ``group`` queries a block (grid y over the groups), a grid-stride
loop over the rows' steps; the lanes of a row added by the butterfly of
``__shfl_xor_sync``, split warps through shared memory, and each warp's rows
stored by the lanes that take them.  Sums are kept mod 2^32, as the card's
uint32 and ``__dp4a`` arithmetic keeps them.  The generic kernels (mixed
types, ragged rows, misaligned bases) are modelled by their grids.

The models must equal the JAX package's ``attention_qk`` and ``decode_gemv``
under ``use_backend("interpret")`` (the Pallas body) and ``"xla"`` (the
oracle) bit for bit, on inputs drawn with numpy from fixed seeds, and every
plan must write every output exactly once.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import api as japi  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import attention as tatt  # noqa: E402

ALIGNED = 1 << 20  # an address on every boundary the plan asks about
I32_MIN, I32_MAX = -(2**31), 2**31 - 1
SMS = 132
GENERIC_MAX_GRID = 132 * 32  # csrc/common.cuh repro_grid's cap
QK_THREADS, QK_GROUP, GEMV_WARPS = 128, 8, 8  # csrc/attention.cu's generic kernels


def _u64(x):
    """int8 or int32 values as uint64, whose products and sums wrap mod
    2^64 and so keep every sum mod 2^32."""
    return x.astype(np.int64).astype(np.uint64)


def _i32(x):
    return (x % np.uint64(2**32)).astype(np.uint32).view(np.int32)


def rowdot_model(a, w, plan, coverage):
    """``a (nq, K) · w (rows, K)ᵀ`` the way ``rowdot`` computes it under
    ``plan``; ``coverage`` (nq, rows) counts the writes of each output."""
    nq, k = a.shape
    rows = w.shape[0]
    per = 16 // a.dtype.itemsize
    chunks = k // per
    av, wv = _u64(a).reshape(nq, chunks, per), _u64(w).reshape(rows, chunks, per)
    span, threads, g = plan.span, 32 * plan.warps, plan.group
    per_step = threads // span
    iters = -(-chunks // span)
    xreg = iters <= plan.unroll and g * plan.unroll <= tatt.ROWDOT_XREG_CHUNKS
    assert xreg or plan.unroll == tatt.ROWDOT_UNROLL  # the instances csrc/attention.cu builds
    tid = np.arange(threads)
    slot = tid % span
    out = np.zeros((nq, rows), np.uint64)
    for by in range(-(-nq // g)):
        m0 = by * g
        mg = min(g, nq - m0)
        for bx in range(plan.blocks):
            for base in range(bx * per_step, rows, plan.blocks * per_step):
                row = base + tid // span
                live = row < rows
                acc = np.zeros((g, threads), np.uint64)
                for it in range(0, iters, plan.unroll):
                    for u in range(plan.unroll):
                        c = slot + (it + u) * span
                        ok = live & (c < chunks)
                        for i in range(mg):
                            acc[i, ok] += (wv[row[ok], c[ok]] * av[m0 + i, c[ok]]).sum(-1)
                if plan.split == 1:
                    o = 1
                    while o < plan.lanes:  # the butterfly: lane t adds lane t ^ o
                        acc = acc + acc[:, tid ^ o]
                        o *= 2
                    wrows = 32 // plan.lanes
                    for wp in range(plan.warps):
                        for lane in range(wrows):  # lane r stores row r, taken from lane r · lanes
                            r = base + wp * wrows + lane
                            if r < rows:
                                out[m0:m0 + mg, r] = acc[:mg, wp * 32 + lane * plan.lanes]
                                coverage[m0:m0 + mg, r] += 1
                else:
                    part = acc.reshape(g, plan.warps, 32).sum(-1)  # each warp's sum
                    for t in range(g * per_step):  # one thread a (query, row)
                        i, r = divmod(t, per_step)
                        if i < mg and base + r < rows:
                            out[m0 + i, base + r] = part[i, r * plan.split:(r + 1) * plan.split].sum()
                            coverage[m0 + i, base + r] += 1
    return _i32(out)


def generic_model(a, w, kernel, coverage):
    """The generic kernels by their grids: ``qk`` a thread a row (QK_THREADS
    a block, QK_GROUP queries on grid y), ``gemv`` a warp a row (GEMV_WARPS
    rows a block), grid-stride over at most GENERIC_MAX_GRID blocks."""
    nq, rows = a.shape[0], w.shape[0]
    per_block = QK_THREADS if kernel == "qk" else GEMV_WARPS
    blocks = max(1, min(-(-rows // per_block), GENERIC_MAX_GRID))
    groups = -(-nq // QK_GROUP) if kernel == "qk" else 1
    full = (_u64(a)[:, None, :] * _u64(w)[None, :, :]).sum(-1)
    out = np.zeros((nq, rows), np.uint64)
    for by in range(groups):
        qs = slice(by * QK_GROUP, min(nq, (by + 1) * QK_GROUP)) if kernel == "qk" else slice(0, nq)
        for start in range(0, rows, blocks * per_block):
            r = np.arange(start, min(rows, start + blocks * per_block))
            out[qs, r] = full[qs, r]
            coverage[qs, r] += 1
    return _i32(out)


def model(kernel, a, w, coverage):
    plan = tatt.rowdot_plan(w.shape[0], w.shape[1], a.shape[0], w.dtype.itemsize, a.dtype.itemsize,
                            (ALIGNED, ALIGNED))
    if plan.vec:
        return rowdot_model(a, w, plan, coverage), plan
    return generic_model(a, w, kernel, coverage), plan


def i8(shape, seed):
    return np.random.default_rng(seed).integers(-128, 128, shape).astype(np.int8)


def i32(shape, seed, lo=I32_MIN, hi=I32_MAX):
    x = np.random.default_rng(seed).integers(lo, hi, shape, endpoint=True).astype(np.int32)
    x.flat[:4] = [I32_MIN, I32_MAX, I32_MIN, -1][:x.size]  # the extremes, in every case
    return x


# name → (kernel, (a, w) maker: a the queries or the activation as (nq, K),
# w the cache or the weight, whether the plan takes the row-dot kernel)
CASES = {
    "qk-serving-T32768": ("qk", lambda: (i8((1, 64), 1), i8((32768, 64), 2)), True),
    "qk-gqa-7-T32768": ("qk", lambda: (i8((7, 64), 3), i8((32768, 64), 4)), True),
    "qk-9-queries": ("qk", lambda: (i8((9, 64), 5), i8((1001, 64), 6)), True),
    "qk-int32-wrap": ("qk", lambda: (i32((3, 32), 7), i32((500, 32), 8)), True),
    "qk-streams-the-queries": ("qk", lambda: (i8((3, 16384), 9), i8((100, 16384), 10)), True),
    "qk-ragged-D5": ("qk", lambda: (i8((2, 5), 11), i8((100, 5), 12)), False),
    "qk-int8-q-int32-k": ("qk", lambda: (i8((2, 16), 13), i32((70, 16), 14, -2**20, 2**20)), False),
    "gemv-q-o-896": ("gemv", lambda: (i8((1, 896), 15), i8((896, 896), 16)), True),
    "gemv-k-v-128x896": ("gemv", lambda: (i8((1, 896), 17), i8((128, 896), 18)), True),
    "gemv-gate-up-4864x896": ("gemv", lambda: (i8((1, 896), 19), i8((4864, 896), 20)), True),
    "gemv-down-896x4864": ("gemv", lambda: (i8((1, 4864), 21), i8((896, 4864), 22)), True),
    "gemv-int32-kernels-bench-512": ("gemv", lambda: (i32((1, 512), 23, -50, 50), i32((512, 512), 24, -50, 50)),
                                     True),
    "gemv-int32-wrap-300x64": ("gemv", lambda: (i32((1, 64), 25), i32((300, 64), 26)), True),
    "gemv-K65536-split-8": ("gemv", lambda: (i8((1, 65536), 27), i8((40, 65536), 28)), True),
    "gemv-one-row": ("gemv", lambda: (i8((1, 896), 29), i8((1, 896), 30)), True),
    "gemv-unroll-8-37x20000": ("gemv", lambda: (i8((1, 20000), 35), i8((37, 20000), 36)), True),
    "gemv-int32-unroll-2-2000x256": ("gemv", lambda: (i32((1, 256), 37), i32((2000, 256), 38)), True),
    "gemv-int32-unroll-4-5000x256": ("gemv", lambda: (i32((1, 256), 39), i32((5000, 256), 40)), True),
    "gemv-int32-unroll-8-40x8192": ("gemv", lambda: (i32((1, 8192), 41), i32((40, 8192), 42)), True),
    "gemv-int32-streamed-40x16384": ("gemv", lambda: (i32((1, 16384), 43), i32((40, 16384), 44)), True),
    "gemv-unroll-2-2000x1024": ("gemv", lambda: (i8((1, 1024), 47), i8((2000, 1024), 48)), True),
    "qk-group-unroll-2": ("qk", lambda: (i8((3, 1024), 49), i8((1100, 1024), 50)), True),
    "gemv-ragged-K37": ("gemv", lambda: (i8((1, 37), 31), i8((500, 37), 32)), False),
    "gemv-int8-w-int32-x": ("gemv", lambda: (i32((1, 96), 33, -2**20, 2**20), i8((77, 96), 34)), False),
}


def _jax(kernel, a, w, backend):
    with japi.use_backend(backend):
        if kernel == "qk":
            return np.asarray(japi.attention_qk(jnp.asarray(a), jnp.asarray(w)))
        return np.asarray(japi.decode_gemv(jnp.asarray(w), jnp.asarray(a[0])))[None, :]


def test_cases_reach_every_kernel_instance():
    """Each instance ``csrc/attention.cu`` builds (int8 and int32; one query
    with unroll 1, 2, 4, 8 in registers or 8 streamed; a group with unroll 1
    or 2 in registers or 8 streamed) is taken by some case above."""
    took = set()
    for kernel, make, vec in CASES.values():
        a, w = make()
        plan = tatt.rowdot_plan(w.shape[0], w.shape[1], a.shape[0], w.dtype.itemsize, a.dtype.itemsize,
                                (ALIGNED, ALIGNED))
        if plan.vec:
            iters = -(-(w.shape[1] * w.dtype.itemsize // 16) // plan.span)
            xreg = iters <= plan.unroll and plan.group * plan.unroll <= tatt.ROWDOT_XREG_CHUNKS
            took.add((w.dtype.itemsize, plan.group, plan.unroll, xreg))
    want = {(b, 1, u, True) for b in (1, 4) for u in (1, 2, 4, 8)} | {(b, 1, 8, False) for b in (1, 4)}
    want |= {(1, tatt.ROWDOT_GROUP, u, True) for u in (1, 2)} | {(1, tatt.ROWDOT_GROUP, 8, False)}
    assert want <= took, sorted(want - took)


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_equals_jax_pallas_body_and_oracle(case):
    kernel, make, vec = CASES[case]
    a, w = make()
    coverage = np.zeros((a.shape[0], w.shape[0]), np.int64)
    got, plan = model(kernel, a, w, coverage)
    assert plan.vec == vec
    assert (coverage == 1).all()  # every output written exactly once
    body, oracle = _jax(kernel, a, w, "interpret"), _jax(kernel, a, w, "xla")
    np.testing.assert_array_equal(body, oracle)
    np.testing.assert_array_equal(got, oracle)
    # and the port's wrappers on CPU tensors (the kernel's plain version)
    ta, tw = torch.from_numpy(a), torch.from_numpy(w)
    port = tatt._qk(ta, tw) if kernel == "qk" else tatt._gemv(tw, ta[0])[None, :]
    np.testing.assert_array_equal(port.numpy(), oracle)


def lane_case(lanes, split, nq):
    """(rows, K) of int8 at which the plan takes ``lanes`` and ``split``
    with ``nq`` queries.  Unsplit: a row of ``lanes`` chunks, which the plan
    reads whole, a lane a chunk, at a row count off a warp's rows.  Split: a
    lane's target of chunks (4, or 2 with a group) on every thread of the
    row, and rows enough that the grid needs no more threads a row (one past
    the rows of ROWDOT_TARGET_BLOCKS blocks, so the last warp's rows are
    ragged), except at a block's 8 warps, which take any rows."""
    if split == 1:
        return 1001, 16 * lanes
    target = min(tatt.ROWDOT_TARGET_ITERS, tatt.ROWDOT_XREG_CHUNKS // (1 if nq == 1 else tatt.ROWDOT_GROUP))
    span = lanes * split
    rows = 37 if split == tatt.ROWDOT_MAX_WARPS else tatt.ROWDOT_TARGET_BLOCKS * 256 // span + 3
    return rows, 16 * target * span


# every lanes from 1 to 32, unsplit; then rows split over 2, 4 and 8 warps;
# each at one query and at 9 (two groups, one of a single query)
@pytest.mark.parametrize("lanes, split", [(1, 1), (2, 1), (4, 1), (8, 1), (16, 1), (32, 1), (32, 2), (32, 4), (32, 8)])
@pytest.mark.parametrize("nq", [1, 9])
def test_model_at_every_lane_count_and_split(lanes, split, nq):
    rows, k = lane_case(lanes, split, nq)
    a, w = i8((nq, k), lanes + nq), i8((rows, k), 100 + lanes)
    plan = tatt.rowdot_plan(rows, k, nq, 1, 1, (ALIGNED, ALIGNED))
    assert (plan.vec, plan.lanes, plan.split) == (True, lanes, split)
    coverage = np.zeros((nq, rows), np.int64)
    got = rowdot_model(a, w, plan, coverage)
    assert (coverage == 1).all()
    np.testing.assert_array_equal(got, _jax("qk", a, w, "xla"))


@pytest.mark.parametrize("blocks", [1, 2, 5])
def test_model_through_the_grid_stride_loop(blocks):
    """A grid below the rows' steps (the LM head's case, at a size the CPU
    can model): each block walks several steps, every row once."""
    assert tatt.rowdot_plan(151936, 896, 1, 1, 1, (ALIGNED, ALIGNED)).blocks < 151936 // 16
    a, w = i8((1, 896), 40), i8((2000, 896), 41)
    plan = tatt.rowdot_plan(2000, 896, 1, 1, 1, (ALIGNED, ALIGNED))._replace(blocks=blocks)
    assert plan.blocks * plan.rows_per_step < 2000
    coverage = np.zeros((1, 2000), np.int64)
    got = rowdot_model(a, w, plan, coverage)
    assert (coverage == 1).all()
    np.testing.assert_array_equal(got, _jax("gemv", a, w, "xla"))


# (rows, K, nq, bytes) → (lanes, split, warps, unroll, group, blocks)
PATH_PLANS = {
    "qk-serving-T32768": ((32768, 64, 1, 1), (4, 1, 8, 1, 1, 512)),
    "qk-gqa-7-T32768": ((32768, 64, 7, 1), (4, 1, 8, 1, 8, 512)),
    "qk-decode-layer-T4096": ((4096, 64, 1, 1), (4, 1, 2, 1, 1, 256)),
    "gemv-q-o-896x896": ((896, 896, 1, 1), (32, 2, 8, 1, 1, 224)),
    "gemv-k-v-128x896": ((128, 896, 1, 1), (32, 2, 2, 1, 1, 128)),
    "gemv-gate-up-4864x896": ((4864, 896, 1, 1), (16, 1, 8, 4, 1, 304)),
    "gemv-down-896x4864": ((896, 4864, 1, 1), (32, 4, 8, 4, 1, 448)),
    "gemv-lm-head-151936x896": ((151936, 896, 1, 1), (16, 1, 8, 4, 1, 3166)),
    "gemv-int32-512x512": ((512, 512, 1, 4), (32, 4, 8, 1, 1, 256)),
}


@pytest.mark.parametrize("case", sorted(PATH_PLANS))
def test_plan_puts_work_on_every_sm_at_the_path_shapes(case):
    """At the serving call, the GQA group, the decode layer's cache and the
    six phase-3g GEMV shapes: every SM gets a block, or, with fewer rows than
    SMs (the k/v projection's 128), every row its own block (a row's partial
    sums stay in one block, so a row is the finest a block takes); every
    lane's loads in flight at once, its activation chunks in registers, and
    whole sectors a warp load."""
    (rows, k, nq, nbytes), want = PATH_PLANS[case]
    plan = tatt.rowdot_plan(rows, k, nq, nbytes, nbytes, (ALIGNED, ALIGNED))
    assert plan.vec and (plan.lanes, plan.split, plan.warps, plan.unroll, plan.group, plan.blocks) == want
    assert plan.blocks >= min(SMS, rows)
    chunks = k * nbytes // 16
    iters = -(-chunks // plan.span)
    assert iters <= plan.unroll  # every load of a lane's row in flight at once
    assert plan.group * plan.unroll <= tatt.ROWDOT_XREG_CHUNKS  # the activation in registers
    # a warp load reads whole rows (one contiguous run) or 128-byte runs of a row
    assert plan.span >= chunks or plan.lanes * 16 >= 128


@pytest.mark.parametrize("rows", [1, 7, 64, 131, 1000, 20000])
@pytest.mark.parametrize("k", [16, 48, 64, 896, 4864, 16 * 1000, 65536])
@pytest.mark.parametrize("nbytes, nq", [(1, 1), (1, 7), (4, 1), (4, 9)])
def test_plan_is_one_the_kernel_takes(rows, k, nbytes, nq):
    """The conditions ``launch_rowdot`` checks, and a lane's loads bounded."""
    plan = tatt.rowdot_plan(rows, k, nq, nbytes, nbytes, (ALIGNED, ALIGNED))
    assert plan.vec
    pow2 = [1 << i for i in range(9)]
    assert plan.lanes in pow2[:6] and plan.split in pow2 and plan.warps in pow2[:4] and plan.unroll in pow2[:4]
    assert plan.split == 1 or plan.lanes == 32
    assert plan.split <= plan.warps <= tatt.ROWDOT_MAX_WARPS and plan.rows_per_step >= 1
    assert plan.group == (1 if nq == 1 else tatt.ROWDOT_GROUP)
    chunks = k * nbytes // 16
    iters = -(-chunks // plan.span)
    xreg = iters <= plan.unroll and plan.group * plan.unroll <= tatt.ROWDOT_XREG_CHUNKS
    assert xreg or plan.unroll == tatt.ROWDOT_UNROLL
    assert iters <= tatt.ROWDOT_TARGET_ITERS or plan.span == 32 * tatt.ROWDOT_MAX_WARPS
    # the grid: one step of rows a block, or at most ROWDOT_MAX_BLOCKS, each
    # block walking an equal number of steps (the last block at most one fewer)
    steps = -(-rows // plan.rows_per_step)
    assert 1 <= plan.blocks <= min(steps, tatt.ROWDOT_MAX_BLOCKS)
    per_block = -(-steps // plan.blocks)
    assert (per_block - 1) * plan.blocks < steps <= per_block * plan.blocks


@pytest.mark.parametrize("why, args", [
    ("int8 w, int32 a", (77, 96, 1, 1, 4, (ALIGNED, ALIGNED))),
    ("int32 w, int8 a", (77, 96, 1, 4, 1, (ALIGNED, ALIGNED))),
    ("ragged K", (500, 37, 1, 1, 1, (ALIGNED, ALIGNED))),
    ("ragged D (K6)", (100, 12, 3, 1, 1, (ALIGNED, ALIGNED))),
    ("K = 0", (5, 0, 1, 1, 1, (ALIGNED, ALIGNED))),
    ("weight one byte off", (128, 896, 1, 1, 1, (ALIGNED + 1, ALIGNED))),
    ("activation one byte off", (40, 65536, 1, 1, 1, (ALIGNED, ALIGNED + 1))),
    ("cache 8 bytes off", (200, 64, 2, 1, 1, (ALIGNED + 8, ALIGNED))),
    ("int32 rows off 16 bytes", (300, 64, 1, 4, 4, (ALIGNED + 4, ALIGNED))),
])
def test_plan_sends_the_rest_to_the_generic_kernels(why, args):
    assert not tatt.rowdot_plan(*args).vec, why


# ---------------------------------------------------------------------------
# the wrappers against the C entry points
# ---------------------------------------------------------------------------


class _CardLike(str):
    """A device that allocates on the CPU but is not ``"cpu"`` to the
    wrappers, so that they take their kernel path (with a recorded launch)."""

    type = "cuda"


@pytest.mark.parametrize("call", ["qk-rowdot", "qk-gqa-rowdot", "qk-generic", "gemv-rowdot", "gemv-int32-rowdot",
                                  "gemv-generic"])
def test_wrappers_pass_the_plans_the_entry_points_declare(monkeypatch, call):
    launched = []
    monkeypatch.setattr(tatt, "kernel_device", lambda *ts: _CardLike("cpu"))
    monkeypatch.setattr(tatt._build, "launch", lambda name, dev, *args: launched.append((name, args)))
    dtype = torch.int32 if "int32" in call else torch.int8
    if call.startswith("qk"):
        m, d = (7 if "gqa" in call else 1), (64 if "rowdot" in call else 12)
        q, k = torch.zeros((m, d), dtype=dtype), torch.zeros((4096, d), dtype=dtype)
        tatt._qk(q, k)
        rows, kk, nq, ptrs = 4096, d, m, (k.data_ptr(), q.data_ptr())
    else:
        k = 896 if "rowdot" in call else 37
        w, x = torch.zeros((896, k), dtype=dtype), torch.zeros(k, dtype=dtype)
        tatt._gemv(w, x)
        rows, kk, nq, ptrs = 896, k, 1, (w.data_ptr(), x.data_ptr())
    ((name, args),) = launched
    assert name == ("attention_qk" if call.startswith("qk") else "decode_gemv")
    assert len(args) + 1 == len(_build.ENTRY_POINTS[name][1])  # + the stream
    nbytes = torch.empty((), dtype=dtype).element_size()
    assert args[-9:-7] == (nbytes, nbytes)  # the element sizes, then the plan
    plan = tatt.rowdot_plan(rows, kk, nq, nbytes, nbytes, ptrs)
    assert plan.vec == ("rowdot" in call)
    assert args[-7:] == (int(plan.vec), plan.lanes, plan.split, plan.warps, plan.unroll, plan.group, plan.blocks)
