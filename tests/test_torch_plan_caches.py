"""The attention kernels' cached launch plans against fresh computations.

``softmax_plan``, ``pv_plan`` and ``kv_plan`` (``repro_torch/kernels/
attention.py``) are cached on their shapes and on their bases' 16-byte
alignment, not their addresses, as ``rowdot_plan`` is: an eager decode step
is host-bound, and each plan costs microseconds of Python.  Each cached plan
must equal the plan computed afresh (the uncached body, ``__wrapped__``) at
every address, over the shapes that ``test_torch_attention_plans.py`` and
``test_torch_scan_append_plans.py`` use.
"""
import pytest

pytest.importorskip("torch")

from repro_torch.kernels import attention as tatt  # noqa: E402

ALIGNED = 1 << 20
# offsets from an aligned base: aligned ones, and every offset that breaks 16-byte alignment in its own way
OFFSETS = (0, 16, 64, 1, 4, 8, 12)

SOFTMAX_SHAPES = [  # (r, t, x_bytes)
    (1, 32768, 4), (7, 32768, 4), (3, 100, 4), (5, 300, 4), (64, 8, 4), (1, 1, 4), (3, 20, 4), (3, 513, 4),
    (3, 4099, 4), (1, 65536, 4), (1, 65537, 4), (2, 70000, 4), (1, 2**20, 4), (1, 2**25 - 1, 4), (2, 32768, 1),
    (1, 70000, 1), (2, 4097, 1), (2, 4096, 1), (70000, 600, 4), (2, 4096, 4),
]
PV_SHAPES = [  # (m, t, dv, p_bytes, v_bytes)
    (1, 32768, 64, 4, 1), (7, 32768, 64, 4, 1), (9, 1000, 64, 4, 1), (1, 1, 64, 4, 1), (2, 5, 64, 4, 1),
    (1, 32767, 64, 4, 1), (3, 777, 16, 4, 1), (4, 999, 256, 4, 1), (2, 700, 48, 4, 1), (2, 400, 300, 4, 1),
    (1, 32768, 64, 4, 4), (3, 4096, 64, 1, 1), (1, 100000, 128, 4, 1), (1, 4096, 8, 4, 1), (1, 4096, 512, 4, 1),
    (2, 3000, 64, 4, 1), (2, 600, 6, 4, 4), (1, 4096, 64, 4, 1),
]
KV_SHAPES = [  # (t, d, cache_bytes, new_bytes)
    (32768, 64, 1, 1), (4096, 64, 1, 1), (700, 64, 1, 1), (1000, 64, 1, 1), (3000, 16, 1, 1), (1000, 48, 1, 1),
    (2048, 64, 1, 1), (50, 5, 1, 1), (300, 64, 4, 4), (100, 64, 1, 4), (5000, 16, 1, 1), (5, 16, 1, 1),
    (1000, 40, 1, 1), (1000, 64, 4, 4),
]


@pytest.mark.parametrize("shape", SOFTMAX_SHAPES, ids=str)
def test_cached_softmax_plan_equals_a_fresh_one(shape):
    r, t, x_bytes = shape
    for off in OFFSETS:
        fresh = tatt._softmax_plan.__wrapped__(r, t, x_bytes, off % 16 == 0)
        assert tatt.softmax_plan(r, t, x_bytes, ALIGNED + off) == fresh
        assert tatt.softmax_plan(r, t, x_bytes, 2 * ALIGNED + off) is tatt.softmax_plan(r, t, x_bytes, ALIGNED + off)


@pytest.mark.parametrize("shape", PV_SHAPES, ids=str)
def test_cached_pv_plan_equals_a_fresh_one(shape):
    for p_off in OFFSETS:
        for v_off in OFFSETS:
            fresh = tatt._pv_plan.__wrapped__(*shape, v_off % 16 == 0)
            assert tatt.pv_plan(*shape, (ALIGNED + p_off, ALIGNED + v_off)) == fresh


@pytest.mark.parametrize("shape", KV_SHAPES, ids=str)
def test_cached_kv_plan_equals_a_fresh_one(shape):
    for offs in ((0, 0, 0), (16, 64, 0), (1, 0, 0), (0, 8, 0), (0, 0, 4), (12, 12, 12)):
        fresh = tatt._kv_plan.__wrapped__(*shape, all(o % 16 == 0 for o in offs))
        assert tatt.kv_plan(*shape, tuple(ALIGNED + o for o in offs)) == fresh


def test_plans_are_cached_across_calls():
    for fn, args in ((tatt.softmax_plan, (1, 32768, 4, ALIGNED)),
                     (tatt.pv_plan, (1, 32768, 64, 4, 1, (ALIGNED, ALIGNED))),
                     (tatt.kv_plan, (32768, 64, 1, 1, (ALIGNED,) * 3))):
        cached = {"softmax_plan": tatt._softmax_plan, "pv_plan": tatt._pv_plan, "kv_plan": tatt._kv_plan}[fn.__name__]
        fn(*args)
        hits = cached.cache_info().hits
        assert fn(*args) is fn(*args)
        assert cached.cache_info().hits == hits + 2
