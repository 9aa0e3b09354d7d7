"""The launch plans of the port's RG-LRU scan (K11, ``rglru_scan.rglru_plan``,
``csrc/rglru_scan.cu``) and KV-cache append (K10, ``attention.kv_plan``,
``csrc/attention.cu``), on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``), but the way they split the work is plain Python and is
modelled here in numpy, in the kernels' order:

* the scan: one warp a channel group (one row of B, ``group`` contiguous
  channels), T walked in stages of ``steps`` steps, each stage's copies
  masked past T and past W (zeros), each channel's chain one fma a step;
* the append: the vector kernel's 16-byte chunks (one a thread, each with
  its row's selector byte and the row's chunk), the generic kernel's
  grid-stride elements.

The models must equal the JAX package's ``rglru_scan`` (under
``use_backend("interpret")``, the Pallas body) and ``kv_append`` (under
``"interpret"`` and ``"xla"``) bit for bit, on inputs drawn with numpy from
fixed seeds, and every plan must write every output element exactly once.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import api as japi  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import attention as tatt  # noqa: E402
from repro_torch.kernels import rglru_scan as trg  # noqa: E402

ALIGNED = 1 << 20  # an address on every boundary the plans ask about
I32_MIN, I32_MAX = -(2**31), 2**31 - 1


# ---------------------------------------------------------------------------
# the RG-LRU scan
# ---------------------------------------------------------------------------


def fma32(a, h, b):
    """``a·h + b`` of float32 arrays rounded once, as ``__fmaf_rn``: the
    product is exact in float64, the sum rounded to odd there (its TwoSum
    error moves an even result one ulp towards the exact sum), then rounded
    to float32."""
    p = a.astype(np.float64) * h.astype(np.float64)
    bd = b.astype(np.float64)
    s = p + bd
    bv = s - p
    e = (p - (s - bv)) + (bd - bv)
    even = (s.view(np.int64) & 1) == 0
    s = np.where((e != 0) & even, np.nextafter(s, np.where(e > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def scan_model(a, b, h0, plan, coverage=None):
    """The scan the way ``csrc/rglru_scan.cu`` computes it under ``plan``:
    a group a block, its stages copied into a (steps, group) tile with zeros
    past T and past W, its lanes' chains stepping through the valid steps.
    ``coverage`` (B, T, W) counts the writes of each output."""
    bsz, t, w = a.shape
    per_row = -(-w // plan.group)
    assert plan.blocks == bsz * per_row
    out = np.full(a.shape, np.nan, np.float32)
    for blk in range(plan.blocks):
        bi, gi = divmod(blk, per_row)
        w0 = gi * plan.group
        nch = min(plan.group, w - w0)
        h = np.zeros(plan.group, np.float32)
        h[:nch] = h0[bi, w0:w0 + nch]
        for s in range(-(-t // plan.steps)):
            t0 = s * plan.steps
            tv = min(plan.steps, t - t0)
            tile_a = np.zeros((plan.steps, plan.group), np.float32)
            tile_b = np.zeros((plan.steps, plan.group), np.float32)
            tile_a[:tv, :nch] = a[bi, t0:t0 + tv, w0:w0 + nch]
            tile_b[:tv, :nch] = b[bi, t0:t0 + tv, w0:w0 + nch]
            for j in range(tv):
                h = fma32(tile_a[j], h, tile_b[j])
                out[bi, t0 + j, w0:w0 + nch] = h[:nch]
                if coverage is not None:
                    coverage[bi, t0 + j, w0:w0 + nch] += 1
    return out


def gates(shape, seed):
    """a = sigmoid(normal), b and h0 normal."""
    rng = np.random.default_rng(seed)
    bsz, _, w = shape
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal(shape)))).astype(np.float32)
    return a, rng.standard_normal(shape).astype(np.float32), rng.standard_normal((bsz, w)).astype(np.float32)


# (B, T, W): ragged T and W, one step, a T one past a stage, a W that leaves
# a ragged last group, a W below a group
SCAN_SHAPES = [(2, 37, 300), (1, 1, 5), (2, trg.SCAN_STEPS + 1, 64), (3, 2 * trg.SCAN_STEPS - 1, 40), (2, 9, 3)]


@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_scan_model_equals_jax_pallas_body(shape):
    a, b, h0 = gates(shape, sum(shape))
    plan = trg.rglru_plan(*shape, (ALIGNED, ALIGNED))
    coverage = np.zeros(shape, np.int64)
    got = scan_model(a, b, h0, plan, coverage)
    with japi.use_backend("interpret"):
        body = np.asarray(japi.rglru_scan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0)))
    np.testing.assert_array_equal(got, body)
    assert (coverage == 1).all()  # every (b, t, w) written exactly once
    # and the port's wrapper on CPU tensors (the kernel's plain version)
    np.testing.assert_array_equal(trg._scan(*map(torch.from_numpy, (a, b, h0))).numpy(), body)


def test_scan_model_keeps_zeros_and_subnormals():
    """±0 and subnormal operands: the model keeps the plain version's bits,
    whose exact fma keeps subnormals as the card's __fmaf_rn does (the
    kernel is built without -ftz).  XLA on the CPU flushes subnormals to
    zero, so its Pallas body is no reference here: it differs."""
    rng = np.random.default_rng(7)
    shape = (2, 40, 24)
    kinds = rng.integers(0, 3, shape)
    tiny = np.float32(2.0**-140)
    a = np.abs(rng.standard_normal(shape)).astype(np.float32)
    b = np.where(kinds == 0, np.float32(0.0), np.where(kinds == 1, np.float32(-0.0), tiny * rng.integers(-50, 50, shape)))
    b = b.astype(np.float32)
    h0 = (tiny * rng.integers(-50, 50, (2, 24))).astype(np.float32)
    got = scan_model(a, b, h0, trg.rglru_plan(*shape, (ALIGNED, ALIGNED)))
    assert ((np.abs(got) < np.finfo(np.float32).tiny) & (got != 0)).any()
    assert (got.view(np.int32) == I32_MIN).any()  # a -0.0 among them
    plain = trg._scan(*map(torch.from_numpy, (a, b, h0))).numpy()
    np.testing.assert_array_equal(got.view(np.int32), plain.view(np.int32))
    with japi.use_backend("interpret"):
        body = np.asarray(japi.rglru_scan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0)))
    assert not ((np.abs(body) < np.finfo(np.float32).tiny) & (body != 0)).any()


@pytest.mark.parametrize("bsz, t, w, group, vec, blocks", [
    (4, 2048, 2560, 32, True, 320),   # RecurrentGemma-2B's width: 320 warps over 132 SMs
    (2, 37, 300, 32, True, 20),       # a ragged last group of 12 channels
    (3, 260, 513, 32, False, 51),     # W % 4 != 0: 4-byte copies; a last group of 1
    (1, 1, 5, 5, False, 1),           # W below a group: the group is W
    (3, 50, 4, 4, True, 3),           # B · W below a group
    (2, 50, 3, 3, False, 2),
    (3, 50, 1, 1, False, 3),
    (2, 40, 20, 20, True, 2),
    (2, 40, 40, 32, True, 4),         # a ragged last group of 8
    (2, 40, 18, 18, False, 2),        # W % 4 != 0
])
def test_rglru_plan(bsz, t, w, group, vec, blocks):
    plan = trg.rglru_plan(bsz, t, w, (ALIGNED, ALIGNED))
    assert plan == trg.ScanPlan(group, trg.SCAN_STEPS, trg.SCAN_STAGES, vec, blocks)
    assert 1 <= plan.group <= trg.SCAN_THREADS and plan.blocks * plan.group >= bsz * w


@pytest.mark.parametrize("ptrs", [(ALIGNED + 4, ALIGNED), (ALIGNED, ALIGNED + 8), (ALIGNED + 12, ALIGNED + 12)])
def test_rglru_plan_takes_16_byte_copies_only_from_aligned_bases(ptrs):
    assert not trg.rglru_plan(4, 2048, 2560, ptrs).vec
    assert trg.rglru_plan(4, 2048, 2560, (ALIGNED + 16, ALIGNED + 32)).vec


def test_rglru_plan_keeps_enough_in_flight_at_the_phase_3g_shape():
    """At (4, 2048, 2560) every warp keeps SCAN_STAGES - 1 stages of a and b
    in flight: with 320 warps on 132 SMs that is more than the ~26 KB an SM
    that 3.35 TB/s at a ~1 µs round trip asks for, and each warp's ring fits
    48 KB of shared memory, so every warp is resident at once."""
    plan = trg.rglru_plan(4, 2048, 2560, (ALIGNED, ALIGNED))
    stage_bytes = 2 * plan.steps * plan.group * 4
    assert (plan.stages - 1) * stage_bytes * plan.blocks / 132 > 26 * 1024
    assert plan.stages * stage_bytes <= 48 * 1024
    assert -(-plan.blocks // 132) <= 3  # the busiest SM holds 3 groups against a mean of 2.42


# ---------------------------------------------------------------------------
# the KV-cache append
# ---------------------------------------------------------------------------


def kv_model(cache, new, sel, plan, coverage=None):
    """The append the way ``csrc/attention.cu`` computes it under ``plan``.
    ``coverage`` (T, D) counts the writes of each output element."""
    t, d = cache.shape
    out = np.zeros_like(cache)
    row = new.astype(np.int64).astype(cache.dtype)  # a wider row keeps its low bytes
    hit = sel != 0
    if coverage is None:
        coverage = np.zeros(cache.shape, np.int64)
    if plan.vec:  # chunk i of the cache, with selector byte i // d16 and chunk i % d16 of the row
        d16 = d // 16
        n16 = t * d16
        chunks, flat, cov = cache.reshape(n16, 16), out.reshape(n16, 16), coverage.reshape(n16, 16)
        for blk in range(plan.blocks):
            i = blk * tatt.KV_THREADS + np.arange(tatt.KV_THREADS)
            i = i[i < n16]
            r = i // d16
            mask = np.where(hit[r], -1, 0).astype(np.int8)[:, None]
            c, v = chunks[i], row.reshape(d16, 16)[i - r * d16]
            flat[i] = c ^ ((c ^ v) & mask)  # the branchless select
            cov[i] += 1
    else:
        n = t * d
        flat, cov = out.reshape(n), coverage.reshape(n)
        stride = plan.blocks * tatt.KV_THREADS
        for start in range(0, n, stride):
            i = np.arange(start, min(n, start + stride))
            r = i // d
            flat[i] = np.where(hit[r], row[i - r * d], cache.reshape(n)[i])
            cov[i] += 1
    return out


def i8(shape, seed):
    return np.random.default_rng(seed).integers(-128, 128, shape).astype(np.int8)


def selector(t, rows, dtype=np.int8):
    s = np.zeros(t, dtype)
    s[list(rows)] = 1 if dtype == np.bool_ else 3
    return s


# name → (cache, new, selector, whether kv_plan takes the vector kernel)
KV = {
    "serving-T32768-one-hot": lambda: (i8((32768, 64), 1), i8((64,), 2), selector(32768, [32767]), True),
    "run-edges": lambda: (i8((4096, 64), 3), i8((64,), 4), selector(4096, [0, 255, 256, 511, 4095]), True),
    "every-row": lambda: (i8((700, 64), 5), i8((64,), 6), selector(700, range(700)), True),
    "all-zero": lambda: (i8((700, 64), 7), i8((64,), 8), selector(700, []), True),
    "T-ragged-1000": lambda: (i8((1000, 64), 9), i8((64,), 10), selector(1000, [767, 768, 999]), True),
    "D16": lambda: (i8((3000, 16), 11), i8((16,), 12), selector(3000, [0, 1023, 1024, 2999]), True),
    "D48": lambda: (i8((1000, 48), 13), i8((48,), 14), selector(1000, [0, 340, 341, 999]), True),
    "int32-selector": lambda: (i8((2048, 64), 15), i8((64,), 16), selector(2048, [3, 2000], np.int32), True),
    "bool-selector-D5": lambda: (i8((50, 5), 17), i8((5,), 18), selector(50, [4], np.bool_), False),
    "int32-cache": lambda: (np.random.default_rng(19).integers(I32_MIN, I32_MAX, (300, 64)).astype(np.int32),
                            np.random.default_rng(20).integers(I32_MIN, I32_MAX, (64,)).astype(np.int32),
                            selector(300, [0, 299]), False),
    "int8-cache-int32-row": lambda: (i8((100, 64), 21),
                                     np.random.default_rng(22).integers(I32_MIN, I32_MAX, (64,)).astype(np.int32),
                                     selector(100, [7, 8], np.int32), False),
}


@pytest.mark.parametrize("case", sorted(KV))
def test_kv_model_equals_jax_pallas_body_and_oracle(case):
    cache, new, sel, vec = KV[case]()
    plan = tatt.kv_plan(*cache.shape, cache.dtype.itemsize, new.dtype.itemsize, (ALIGNED,) * 3)
    assert plan.vec == vec
    with japi.use_backend("interpret"):
        body = np.asarray(japi.kv_append(jnp.asarray(cache), jnp.asarray(new), jnp.asarray(sel)))
    with japi.use_backend("xla"):
        oracle = np.asarray(japi.kv_append(jnp.asarray(cache), jnp.asarray(new), jnp.asarray(sel)))
    np.testing.assert_array_equal(body, oracle)
    coverage = np.zeros(cache.shape, np.int64)
    np.testing.assert_array_equal(kv_model(cache, new, sel, plan, coverage), oracle)
    assert (coverage == 1).all()  # every element written exactly once
    # and the port's wrapper on CPU tensors (the kernel's plain version)
    got = tatt._kv_append(*map(torch.from_numpy, (cache, new, sel)))
    np.testing.assert_array_equal(got.numpy(), oracle)


@pytest.mark.parametrize("t, d, blocks", [
    (32768, 64, 512),  # the serving call: 131072 chunks, one a thread, in one wave of 512 blocks
    (1000, 64, 16),
    (3000, 48, 36),
    (5000, 16, 20),
    (5, 16, 1),
])
def test_kv_plan_gives_each_chunk_a_thread(t, d, blocks):
    assert tatt.kv_plan(t, d, 1, 1, (ALIGNED,) * 3) == tatt.KvPlan(True, blocks)
    assert (blocks - 1) * tatt.KV_THREADS < t * d // 16 <= blocks * tatt.KV_THREADS


@pytest.mark.parametrize("why, args", [
    ("int32 cache", (1000, 64, 4, 4, (ALIGNED,) * 3)),
    ("int32 row", (1000, 64, 1, 4, (ALIGNED,) * 3)),
    ("D % 16 != 0", (1000, 40, 1, 1, (ALIGNED,) * 3)),
    ("cache off 16 bytes", (1000, 64, 1, 1, (ALIGNED + 1, ALIGNED, ALIGNED))),
    ("row off 16 bytes", (1000, 64, 1, 1, (ALIGNED, ALIGNED + 8, ALIGNED))),
    ("output off 16 bytes", (1000, 64, 1, 1, (ALIGNED, ALIGNED, ALIGNED + 4))),
])
def test_kv_plan_sends_the_rest_to_the_generic_kernel(why, args):
    plan = tatt.kv_plan(*args)
    t, d = args[:2]
    assert not plan.vec, why
    assert plan.blocks == min(-(-t * d // tatt.KV_THREADS), tatt.KV_MAX_GRID)


def test_kv_plan_takes_the_vector_kernel_at_the_serving_call():
    assert tatt.kv_plan(32768, 64, 1, 1, (ALIGNED,) * 3).vec
    assert tatt.kv_plan(32768, 64, 1, 1, (ALIGNED + 16, ALIGNED + 64, ALIGNED)).vec


# ---------------------------------------------------------------------------
# the wrappers against the C entry points
# ---------------------------------------------------------------------------


class _CardLike(str):
    """A device that allocates on the CPU but is not ``"cpu"`` to the
    wrappers, so that they take their kernel path (with a recorded launch)."""

    type = "cuda"


@pytest.mark.parametrize("call", ["scan-vec", "scan-4-byte", "kv-vec", "kv-generic"])
def test_wrappers_pass_the_plans_the_entry_points_declare(monkeypatch, call):
    launched = []
    for mod in (tatt, trg):
        monkeypatch.setattr(mod, "kernel_device", lambda *ts: _CardLike("cpu"))
        monkeypatch.setattr(mod._build, "launch", lambda name, dev, *args: launched.append((name, args)))
    if call.startswith("scan"):
        w = 64 if call == "scan-vec" else 66
        z = torch.zeros((2, 40, w))
        trg._scan(z, z, torch.zeros((2, w)))
    else:
        cache = torch.zeros((1000, 64 if call == "kv-vec" else 5), dtype=torch.int8)
        tatt._kv_append(cache, torch.zeros(cache.shape[1], dtype=torch.int8), torch.zeros(1000, dtype=torch.int8))
    ((name, args),) = launched
    assert len(args) + 1 == len(_build.ENTRY_POINTS[name][1])  # + the stream
    if name == "rglru_scan_f32":
        w = args[6]
        assert tuple(args[7:]) == (trg.SCAN_GROUP, int(call == "scan-vec"), 2 * -(-w // trg.SCAN_GROUP))
    else:
        assert args[9:] == (int(call == "kv-vec"), tatt.kv_plan(1000, args[5], 1, 1, (0, 0, 0) if call == "kv-vec"
                                                                  else (1, 1, 1)).blocks)
