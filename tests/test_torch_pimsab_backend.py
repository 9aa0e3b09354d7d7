"""The port's eager pimsab backend (``repro_torch.kernels.pimsab_backend``)
against the JAX package's, kernel by kernel.

Inside ``use_backend("pimsab")`` both packages lower each registry kernel
onto the same PIMSAB compiler and functional simulator (the port's numpy copy
in ``repro_torch.core``), so on the same inputs — made with numpy from the
seeds of ``tests/test_pimsab_conformance.py`` — the outputs must be equal bit
for bit, float kernels included, and the ``SimReport`` s equal field for
field (``to_json()``).  The corner cases follow the JAX conformance tests:
the multi-slice static skip, int32 wrap, the lane-split reductions across
CRAMs, integer and bfloat16 H-tree reductions, the refused non-power-of-two
global pool, per-thread reports, and the refusal of operands without values.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.machine import PimsabConfig as JPimsabConfig  # noqa: E402
from repro.kernels import api as japi  # noqa: E402
from repro.kernels import pimsab_backend as jpb  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core.machine import PimsabConfig  # noqa: E402
from repro_torch.kernels import api as tapi  # noqa: E402
from repro_torch.kernels import pimsab_backend as tpb  # noqa: E402
from repro_torch.kernels import program as tprogram  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402


def _ints(shape, lo, hi, seed=0):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(np.int32)


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _sigmoid(z):
    return (1.0 / (1.0 + np.exp(-z.astype(np.float64)))).astype(np.float32)


def _onehot(t, row):
    o = np.zeros(t, np.int32)
    o[row] = 1
    return o


def _matmul(bits_x=8, bits_w=8):
    def call(api, x, w):
        return api.matmul(api.SlicedTensor.from_int(x, bits_x), api.SlicedTensor.from_int(w, bits_w))
    return call


# (operands, call) per registry kernel: tests/test_pimsab_conformance.py's
# `_case` inputs, drawn with numpy from the same seeds; `call(api, *ops)`
# runs the kernel through either package's public API
CASES = {
    "bitslice_matmul": ((_ints((16, 32), -100, 100, 0), _ints((32, 8), -100, 100, 1)), _matmul()),
    "htree_reduce": ((_normal((16, 32), 2),), lambda api, x: api.htree_reduce(x)),
    "rglru_scan": ((_sigmoid(_normal((2, 8, 24), 3)), _normal((2, 8, 24), 4), _normal((2, 24), 5)),
                   lambda api, a, b, h0: api.rglru_scan(a, b, h0)),
    "ewise_add": ((_ints((8, 32), -500, 500, 6), _ints((8, 32), -500, 500, 7)),
                  lambda api, x, y: api.ewise_add(x, y)),
    "relu": ((_ints((8, 32), -500, 500, 8),), lambda api, x: api.relu(x)),
    "conv2d": ((_ints((2, 3, 8, 8), -8, 8, 20), _ints((4, 3, 3, 3), -100, 100, 21)),
               lambda api, x, w: api.conv2d(x, w, stride=2, padding=1)),
    "int_matmul": ((_ints((8, 32), -200, 200, 22), _ints((32, 8), -200, 200, 23)),
                   lambda api, x, w: api.int_matmul(x, w)),
    "maxpool2d": ((_ints((2, 4, 8, 8), -500, 500, 24),), lambda api, x: api.maxpool2d(x, window=2)),
    "avgpool2d": ((_ints((2, 4, 8, 8), -500, 500, 25),), lambda api, x: api.avgpool2d(x, window=2)),
    "global_avgpool": ((_ints((2, 8, 4, 4), -500, 500, 26),), lambda api, x: api.global_avgpool(x)),
    "attention_qk": ((_ints((2, 8), -10, 10, 27), _ints((4, 8), -10, 10, 28)),
                     lambda api, q, k: api.attention_qk(q, k)),
    "softmax_fixedpoint": ((_ints((4, 8), -400, 400, 29),),
                           lambda api, x: api.softmax_fixedpoint(x, in_frac=7)),
    "attention_pv": ((_ints((2, 8), 0, 64, 30), _ints((8, 4), -100, 100, 31)),
                     lambda api, p, v: api.attention_pv(p, v)),
    "decode_gemv": ((_ints((8, 16), -50, 50, 32), _ints((16,), -20, 20, 33)),
                    lambda api, w, x: api.decode_gemv(w, x)),
    "kv_append": ((_ints((8, 4), -100, 100, 34), _ints((4,), -100, 100, 35), _onehot(8, 5)),
                  lambda api, c, n, o: api.kv_append(c, n, o)),
}


def _jax(call, ops, jcfg=None):
    args = [jnp.asarray(o) for o in ops]
    japi.clear_sim_report_log()
    with japi.use_backend("pimsab"):
        if jcfg is None:
            out = call(japi, *args)
        else:
            with jpb.functional_config(jcfg):
                out = call(japi, *args)
    return np.asarray(out), japi.last_sim_report()


def _port(call, ops, cfg=None, like=None):
    args = [torch.from_numpy(np.array(o)) for o in ops] if like is None else like
    tapi.clear_sim_report_log()
    tapi.reset_launch_counts()
    with tapi.use_backend("pimsab"):
        if cfg is None:
            out = call(tapi, *args)
        else:
            with tpb.functional_config(cfg):
                out = call(tapi, *args)
    assert tapi.launch_counts() == {}, "a pimsab call launched a kernel"
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu" and out.is_contiguous()
    return out.numpy(), tapi.last_sim_report()


def _assert_equal(call, ops, *, jcfg=None, cfg=None, like=None):
    want, jrep = _jax(call, ops, jcfg)
    got, trep = _port(call, ops, cfg, like)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.kind == "f":  # bit for bit, not allclose: the same numpy arithmetic
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    else:
        assert np.array_equal(got, want)
    assert trep is not None and jrep is not None
    assert trep.to_json() == jrep.to_json()
    return got, trep


# ---------------------------------------------------------------------------
# every registry kernel
# ---------------------------------------------------------------------------


def test_every_registered_kernel_has_a_pimsab_lowering_and_a_case():
    kernels = tapi.registered_kernels()
    assert sorted(kernels) == sorted(CASES) == sorted(japi.registered_kernels())
    for name, kd in kernels.items():
        assert kd.pimsab is not None, name


@pytest.mark.parametrize("name", sorted(CASES))
def test_registry_kernel_equals_jax_pimsab_output_and_report(name):
    ops, call = CASES[name]
    _, rep = _assert_equal(call, ops)
    assert rep.kernel == name and rep.mapping["workload"].startswith(name)
    assert rep.total_cycles > 0 and rep.energy_j > 0 and rep.functional_instrs > 0
    assert set(rep.cycles) == {"compute", "dram", "noc", "htree", "sync"}
    assert len(tapi.sim_report_log()) == 1


# ---------------------------------------------------------------------------
# corner cases
# ---------------------------------------------------------------------------


def test_matmul_multi_slice_static_skip_equals_jax():
    x, w = _ints((8, 16), -100, 100, 0), _ints((16, 8), -50, 50, 1)
    ws = tapi.SlicedTensor.from_int(torch.from_numpy(w), 16)
    assert ws.zero_slices == (1,)
    got, _ = _assert_equal(_matmul(8, 16), (x, w))
    assert np.array_equal(got, x.astype(np.int64) @ w.astype(np.int64))


@pytest.mark.parametrize("kernel", ["matmul", "int_matmul"])
def test_int32_wrap_equals_jax(kernel):
    seeds = (2, 3) if kernel == "matmul" else (46, 47)
    x, w = _ints((4, 64), -30000, 30000, seeds[0]), _ints((64, 4), -30000, 30000, seeds[1])
    call = _matmul(16, 16) if kernel == "matmul" else (
        lambda api, a, b: api.int_matmul(a, b, x_bits=16, w_bits=16))
    got, _ = _assert_equal(call, (x, w))
    wide = x.astype(np.int64) @ w.astype(np.int64)
    assert (np.abs(wide) > 2**31).any(), "the case must overflow int32"
    assert np.array_equal(got, wide.astype(np.int32))


def test_scaled_matmul_dequantizes_like_jax():
    x, w = _ints((8, 16), -100, 100, 4), _ints((16, 8), -100, 100, 5)
    scale = np.full((8,), 0.5, np.float32)

    def call(api, a, b, s):
        return api.matmul(api.SlicedTensor.from_int(a, 8), api.SlicedTensor.from_int(b, 8, scale=s))

    _assert_equal(call, (x, w, scale))


def test_lane_split_reduction_equals_jax():
    _, rep = _assert_equal(_matmul(), (_ints((2, 512), -20, 20, 10), _ints((512, 1), -20, 20, 11)))
    assert rep.mapping["reduce_split"] > 1


def test_full_lane_split_across_crams_equals_jax():
    """Two CRAMs a tile and one K = 512 output: the reduction folds through
    ReduceIntra in each CRAM and ReduceHTree across them."""
    cfg = PimsabConfig(mesh_cols=1, mesh_rows=1, crams_per_tile=2)
    jcfg = JPimsabConfig(mesh_cols=1, mesh_rows=1, crams_per_tile=2)
    x, w = _ints((1, 512), -20, 20, 12), _ints((512, 1), -20, 20, 13)
    got, _ = _assert_equal(_matmul(), (x, w), jcfg=jcfg, cfg=cfg)
    assert np.array_equal(got, x @ w)
    assert tpb.last_verify_report() and all(r.ok for r in tpb.last_verify_report())


def test_integer_htree_reduce_equals_jax():
    x = _ints((32, 16), -1000, 1000, 14)
    got, rep = _assert_equal(lambda api, v: api.htree_reduce(v), (x,))
    assert np.array_equal(got, x.sum(axis=0))
    assert rep.instr_mix.get("MacConst", 0) > 0 and rep.instr_mix.get("RfLoad", 0) == 1


def test_bfloat16_htree_reduce_widens_exactly_like_jax():
    x = _normal((16, 32), 2)
    want, jrep = _jax(lambda api, v: api.htree_reduce(v.astype(jnp.bfloat16)), (x,))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got, trep = _port(lambda api, v: api.htree_reduce(v), (), like=[xb])
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert trep.to_json() == jrep.to_json()


@pytest.mark.parametrize("case", ["ewise_add", "relu", "maxpool2d", "rglru_long"])
def test_float_fixed_point_kernels_equal_jax_bit_for_bit(case):
    x, y = _normal((8, 32), 20), _normal((8, 32), 21)
    ops, call = {
        "ewise_add": ((x, y), lambda api, a, b: api.ewise_add(a, b)),
        "relu": ((x,), lambda api, a: api.relu(a)),
        "maxpool2d": ((_normal((1, 2, 8, 8), 43),), lambda api, a: api.maxpool2d(a, window=2)),
        "rglru_long": ((_sigmoid(_normal((1, 32, 16), 22)), _normal((1, 32, 16), 23), _normal((1, 16), 24)),
                       lambda api, a, b, h: api.rglru_scan(a, b, h)),
    }[case]
    _assert_equal(call, ops)


@pytest.mark.parametrize("case", ["conv1x1-s2", "maxpool-3s2", "avgpool-negative", "relu-int8",
                                  "kv_append-int8", "kv_append-no-op", "softmax-in_frac-3"])
def test_more_conformance_corners_equal_jax(case):
    ops, call = {
        "conv1x1-s2": ((_ints((1, 4, 8, 8), -8, 8, 40), _ints((8, 4, 1, 1), -4, 4, 41)),
                       lambda api, x, w: api.conv2d(x, w, stride=2, padding=0)),
        "maxpool-3s2": ((_ints((1, 2, 7, 7), -100, 100, 42),), lambda api, x: api.maxpool2d(x, window=3, stride=2)),
        "avgpool-negative": ((-_ints((1, 2, 4, 4), 1, 500, 44),), lambda api, x: api.avgpool2d(x, window=2)),
        "relu-int8": ((_ints((8, 32), -128, 128, 8).astype(np.int8),), lambda api, x: api.relu(x)),
        "kv_append-int8": ((_ints((8, 4), -128, 128, 34).astype(np.int8),
                            _ints((4,), -128, 128, 35).astype(np.int8), _onehot(8, 7)),
                           lambda api, c, n, o: api.kv_append(c, n, o)),
        "kv_append-no-op": ((_ints((8, 4), -100, 100, 34), _ints((4,), -100, 100, 35), np.zeros(8, np.int32)),
                            lambda api, c, n, o: api.kv_append(c, n, o)),
        "softmax-in_frac-3": ((_ints((4, 8), -60, 60, 29),),
                              lambda api, x: api.softmax_fixedpoint(x, in_frac=3)),
    }[case]
    got, _ = _assert_equal(call, ops)
    if case == "relu-int8":
        assert got.dtype == np.int8


@pytest.mark.parametrize("case", ["conv2d-channels-last", "int_matmul-transposed", "relu-strided"])
def test_views_are_read_in_logical_order(case):
    """Channels-last, transposed and strided operands give the output of
    their contiguous copies (and JAX's on the logical arrays)."""
    if case == "conv2d-channels-last":
        x, w = _ints((2, 3, 8, 8), -8, 8, 20), _ints((4, 3, 3, 3), -100, 100, 21)
        like = [torch.from_numpy(x).contiguous(memory_format=torch.channels_last), torch.from_numpy(w)]
        call, ops = (lambda api, a, b: api.conv2d(a, b, stride=2, padding=1)), (x, w)
    elif case == "int_matmul-transposed":
        xt, w = _ints((32, 8), -200, 200, 22), _ints((32, 8), -200, 200, 23)
        like = [torch.from_numpy(xt).t(), torch.from_numpy(w)]
        call, ops = (lambda api, a, b: api.int_matmul(a, b)), (np.ascontiguousarray(xt.T), w)
    else:
        x = _ints((8, 64), -500, 500, 8)
        like = [torch.from_numpy(x)[:, ::2]]
        call, ops = (lambda api, a: api.relu(a)), (np.ascontiguousarray(x[:, ::2]),)
    assert not like[0].is_contiguous()
    want, jrep = _jax(call, ops)
    got, trep = _port(call, ops, like=like)
    assert np.array_equal(got, want) and trep.to_json() == jrep.to_json()


@pytest.mark.parametrize("case", ["conv2d-3x3-s2-p1", "conv2d-1x1-s2", "pool-2s2", "pool-3s2"])
def test_port_patch_order_equals_jax(case):
    """The lowerings take their patches from the port's ``ref.im2col`` /
    ``ref.pool_patches``; the workload's layout depends on their order."""
    if case.startswith("conv2d"):
        x = _ints((2, 3, 8, 8), -8, 8, 20) if "3x3" in case else _ints((1, 4, 8, 8), -8, 8, 40)
        k, stride, pad = (3, 2, 1) if "3x3" in case else (1, 2, 0)
        want = np.asarray(jref.im2col(jnp.asarray(x), k, k, stride, pad))
        got = tref.im2col(torch.from_numpy(x), k, k, stride, pad).numpy()
    else:
        x = _ints((2, 4, 8, 8), -500, 500, 24) if "2s2" in case else _ints((1, 2, 7, 7), -100, 100, 42)
        win = 2 if "2s2" in case else 3
        want = np.asarray(jref.pool_patches(jnp.asarray(x), win, 2))
        got = tref.pool_patches(torch.from_numpy(x), win, 2).numpy()
    assert got.shape == want.shape and np.array_equal(got, want)


def test_non_power_of_two_global_avgpool_is_refused():
    x = torch.from_numpy(_ints((1, 2, 3, 3), -10, 10, 45))
    with tapi.use_backend("pimsab"):
        with pytest.raises(NotImplementedError, match="power-of-two"):
            tapi.global_avgpool(x)


def test_float_operands_of_the_integer_lowerings_are_refused():
    x = torch.from_numpy(_normal((8, 32), 1))
    with tapi.use_backend("pimsab"):
        with pytest.raises(NotImplementedError, match="raw-integer"):
            tapi.int_matmul(x, x.t())


def test_sim_report_is_per_thread_and_the_scope_per_context():
    x = torch.from_numpy(_ints((4, 8), -5, 5, 30))
    y = torch.from_numpy(_ints((4, 8), -5, 5, 31))
    seen = {}

    def worker():
        # a thread starts outside the scope: the call runs on its device
        seen["outside"] = (tapi.current_backend(), tapi.relu(x), tapi.last_sim_report())
        with tapi.use_backend("pimsab"):
            tapi.relu(x)
        seen["inside"] = tapi.last_sim_report(), tapi.sim_report_log()

    tapi.clear_sim_report_log()
    with tapi.use_backend("pimsab"):
        assert tapi.current_backend() == "pimsab"
        tapi.ewise_add(x, y)
        t = threading.Thread(target=worker)
        t.start()
        t.join()
        r1 = tapi.last_sim_report()
    assert tapi.current_backend() is None
    assert seen["outside"][0] is None and seen["outside"][2] is None
    assert torch.equal(seen["outside"][1], torch.clamp_min(x, 0))
    rep, log = seen["inside"]
    assert rep.kernel == "relu" and [r.kernel for r in log] == ["relu"]
    assert r1.kernel == "ewise_add" and [r.kernel for r in tapi.sim_report_log()] == ["ewise_add"]
    j = rep.to_json()
    assert j["kernel"] == "relu" and j["total_cycles"] > 0 and j["mapping"]["tiles_used"] >= 1


@pytest.mark.parametrize("operand", ["meta", "program-value"])
def test_operands_without_values_are_refused(operand):
    if operand == "meta":
        x = torch.empty((4, 8), dtype=torch.int32, device="meta")
    else:
        x = tprogram.ProgramValue(0, ((4, 8), "int32"), "relu")
    with tapi.use_backend("pimsab"):
        with pytest.raises(tapi.PimsabTracerError, match="'relu'.*hold values"):
            tapi.relu(x)
    with pytest.raises(tapi.PimsabTracerError, match="needs operands that hold values"):
        tapi.get_kernel("relu").pimsab(x)
