"""The PyTorch port's Program API (``repro_torch.kernels.program``) against
the JAX package's.

The same functions are traced by both packages over the same numpy-seeded
inputs; their Programs must agree field for field — ops (kernel, operand
references, static kwargs, output aval), slot avals, output references and
captured-constant fingerprints — for the README block
``relu(ewise_add(matmul(xs, ws), y))``, the ``TINY`` ResNet forward and the
``quant_linear_relu`` chain.  The rest covers the compile cache, the
placeholder's refusals, the Executor's argument checks, the parts ported
last (the pimsab and resident-state compiles, whose full cases are in
``tests/test_torch_pimsab_program.py``, and multi-chip sharding, in
``tests/test_torch_multichip.py``), shape inference on ``meta``
tensors for every registered kernel, and eager equality of traced programs
on CPU tensors.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import api as japi  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import resnet as jres  # noqa: E402
from repro_torch.kernels import api as tapi  # noqa: E402
from repro_torch.kernels import program as tprogram  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import resnet as tres  # noqa: E402


def ints(shape, lo, hi, seed, dtype=np.int32):
    return np.random.default_rng(seed).integers(lo, hi, shape, endpoint=False).astype(dtype)


def floats(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _jblock(xs, ws, y):
    return japi.relu(japi.ewise_add(japi.matmul(xs, ws), y))


def _tblock(xs, ws, y):
    return tapi.relu(tapi.ewise_add(tapi.matmul(xs, ws), y))


def _block_operands(m=8, k=16, n=8, seed=0, x_bits=8, w_bits=16):
    x, w = ints((m, k), -100, 100, seed), ints((k, n), -50, 50, seed + 1)
    y = ints((m, n), -1000, 1000, seed + 2)
    jops = (japi.SlicedTensor.from_int(jnp.asarray(x), x_bits),
            japi.SlicedTensor.from_int(jnp.asarray(w), w_bits), jnp.asarray(y))
    tops = (tapi.SlicedTensor.from_int(torch.from_numpy(x), x_bits),
            tapi.SlicedTensor.from_int(torch.from_numpy(w), w_bits), torch.from_numpy(y))
    return jops, tops


def _qlr_operands(seed=0, spec="w8a16"):
    """The ``_matmul_relu`` arguments ``quant_linear_relu`` builds."""
    w, x = floats((24, 16), seed, scale=0.1), floats((6, 24), seed + 1)
    jspec, tspec = getattr(japi.PrecisionSpec, spec), getattr(tapi.PrecisionSpec, spec)
    ops = []
    for pkg, common, arr, spec_ in ((japi, jcommon, jnp.asarray, jspec),
                                     (tapi, tcommon, torch.from_numpy, tspec)):
        p = common.quantize_weight(arr(w), 8)
        x_st = pkg.SlicedTensor.quantize(arr(x), spec_)
        x_raw = pkg.SlicedTensor(slices=x_st.slices, slice_bits=x_st.slice_bits,
                                 orig_bits=x_st.orig_bits, zero_slices=x_st.zero_slices)
        w_q = p["w_q"].astype(jnp.int32) if pkg is japi else p["w_q"].to(torch.int32)
        ops.append((x_raw, pkg.SlicedTensor.from_int(w_q, spec_.weight_bits,
                                                     slice_bits=spec_.slice_bits)))
    return ops


def _jax_const_fp(prog):
    return tuple(s for s in prog.signature()[-1])


def _assert_same_program(jp, tp):
    assert tp.name == jp.name and tp.n_slots == jp.n_slots
    assert [(o.kernel, o.inputs, o.kwargs, o.out_aval) for o in tp.ops] == \
        [(o.kernel, o.inputs, o.kwargs, o.out_aval) for o in jp.ops]
    assert tp.slot_avals == jp.slot_avals
    assert tp.out_refs == jp.out_refs
    assert tp.const_fingerprints() == _jax_const_fp(jp)


# ---------------------------------------------------------------------------
# signatures equal to the JAX package's
# ---------------------------------------------------------------------------


def test_readme_block_program_equals_jax():
    jops, tops = _block_operands()
    jp = japi.trace(_jblock, name="block").program_for(*jops)
    tp = tapi.trace(_tblock, name="block").program_for(*tops)
    _assert_same_program(jp, tp)
    assert tp.kernels == ("bitslice_matmul", "ewise_add", "relu")
    assert dict(tp.ops[0].kwargs)["skip"] == ((0, 1),)  # the zero high weight slice


def test_program_with_captured_constant_equals_jax():
    jops, tops = _block_operands(seed=5)
    y = ints((8, 8), -9, 9, 9)
    jy, ty = jnp.asarray(y), torch.from_numpy(y)
    jp = japi.trace(lambda xs, ws: _jblock(xs, ws, jy), name="const").program_for(*jops[:2])
    tp = tapi.trace(lambda xs, ws: _tblock(xs, ws, ty), name="const").program_for(*tops[:2])
    _assert_same_program(jp, tp)
    assert tp.ops[1].inputs[1] == ("const", 0) and len(tp.const_fingerprints()) == 1


@pytest.mark.parametrize("batch", [1, 2])
def test_tiny_resnet_program_equals_jax(batch):
    jcfg, tcfg = jres.TINY, tres.TINY
    jp = japi.trace(lambda p, v: jres.forward(jcfg, p, v), name="resnet").program_for(
        jres.init_params(jcfg), jres.make_input(jcfg, batch))
    tp = tapi.trace(lambda p, v: tres.forward(tcfg, p, v), name="resnet").program_for(
        tres.init_params(tcfg, device="cpu"), tres.make_input(tcfg, batch, device="cpu"))
    _assert_same_program(jp, tp)
    assert list(tp.kernels) == tres.layer_names(tcfg)


@pytest.mark.parametrize("spec", ["w8a16", "int16", "int8"])
def test_quant_linear_relu_program_equals_jax(spec):
    (jx, jw), (tx, tw) = _qlr_operands(seed=3, spec=spec)
    jp = jcommon._matmul_relu.program_for(jx, jw)
    tp = tcommon._matmul_relu.program_for(tx, tw)
    _assert_same_program(jp, tp)
    assert tp.name == "quant_linear_relu" and tp.kernels == ("bitslice_matmul", "relu")


def test_slot_order_follows_sorted_dict_keys_like_jax():
    tree = {"b": [np.int32(1), (np.int32(2), None)], "a": {"z": np.int32(3), "c": np.int32(4)},
            "c": None}
    jleaves, _ = jax.tree_util.tree_flatten(tree)
    tleaves, td = tprogram.tree_flatten(tree)
    assert [int(v) for v in tleaves] == [int(v) for v in jleaves] == [4, 3, 1, 2]
    assert tprogram.tree_unflatten(td, tleaves) == tree


def _gates(shape, seed):
    a = (1.0 / (1.0 + np.exp(-floats(shape, seed)))).astype(np.float32)
    return a, floats(shape, seed + 1), floats((shape[0], shape[2]), seed + 2)


# entry point → (JAX call, port call, numpy operands, JAX dtypes, torch dtypes)
ENTRY_POINTS = {
    "htree_reduce-float32": ("htree_reduce", lambda: (floats((256, 64), 30),), None),
    "htree_reduce-bfloat16": ("htree_reduce", lambda: (floats((16, 40), 31),), "bfloat16"),
    "htree_reduce-int32": ("htree_reduce", lambda: (ints((8, 12), -2**31, 2**31, 32),), None),
    "rglru_scan": ("rglru_scan", lambda: _gates((2, 16, 24), 33), None),
    "decode_gemv-int8": ("decode_gemv", lambda: (ints((48, 96), -128, 128, 36, np.int8),
                                                 ints((96,), -128, 128, 37, np.int8)), None),
    "decode_gemv-int32": ("decode_gemv", lambda: (ints((32, 64), -1000, 1000, 38), ints((64,), -1000, 1000, 39)),
                          None),
}


@pytest.mark.parametrize("case", sorted(ENTRY_POINTS))
def test_traced_entry_point_program_equals_jax(case):
    """A traced call of ``htree_reduce``, ``rglru_scan`` and ``decode_gemv``
    has JAX's Program signature (float32 and bfloat16 avals named as numpy
    names them), and replays to the eager result."""
    name, make, cast = ENTRY_POINTS[case]
    args = make()
    jargs = [jnp.asarray(a).astype(jnp.bfloat16) if cast else jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(a).to(torch.bfloat16) if cast else torch.from_numpy(a) for a in args]
    jp = japi.trace(getattr(japi, name), name=name).program_for(*jargs)
    tp = tapi.trace(getattr(tapi, name), name=name).program_for(*targs)
    _assert_same_program(jp, tp)
    assert tp.kernels == (name,)
    if cast:
        assert tp.slot_avals[0][1] == "bfloat16"
    assert torch.equal(tapi.compile(tp)(*targs), getattr(tapi, name)(*targs))


# ---------------------------------------------------------------------------
# shape inference on meta tensors, every registered kernel
# ---------------------------------------------------------------------------


def _i(shape, seed=0, lo=-50, hi=50, dtype=np.int32):
    return torch.from_numpy(ints(shape, lo, hi, seed, dtype))


KERNEL_CALLS = {
    "bitslice_matmul": (lambda: (_i((2, 6, 10), 1, dtype=np.int8), _i((3, 10, 5), 2, dtype=np.int8)),
                        dict(slice_bits=8, skip=((1, 2),))),
    "conv2d": (lambda: (_i((2, 3, 7, 7), 3), _i((4, 3, 3, 3), 4)), dict(stride=2, padding=1)),
    "int_matmul": (lambda: (_i((5, 9), 5), _i((9, 4), 6)), dict(x_bits=8, w_bits=8)),
    "maxpool2d": (lambda: (_i((1, 2, 6, 6), 7),), dict(window=3, stride=2)),
    "avgpool2d": (lambda: (_i((1, 2, 6, 6), 8),), dict(window=2)),
    "global_avgpool": (lambda: (torch.from_numpy(floats((2, 3, 4, 4), 9)),), dict()),
    "ewise_add": (lambda: (_i((3, 4), 10), _i((3, 4), 11, dtype=np.int8)), dict()),
    "relu": (lambda: (_i((3, 4), 12),), dict()),
    "attention_qk": (lambda: (_i((2, 8), 13, dtype=np.int8), _i((6, 8), 14, dtype=np.int8)),
                     dict(q_bits=8, out_bits=22)),
    "softmax_fixedpoint": (lambda: (_i((2, 6), 15, lo=-2**20, hi=2**20),), dict(in_frac=13)),
    "attention_pv": (lambda: (_i((2, 6), 16, lo=0, hi=64), _i((6, 4), 17, dtype=np.int8)), dict(shift=6)),
    "kv_append": (lambda: (_i((6, 4), 18, dtype=np.int8), _i((4,), 19), _i((6,), 20, lo=0, hi=2, dtype=np.int8)),
                  dict()),
    "decode_gemv": (lambda: (_i((6, 32), 21, lo=-128, hi=128, dtype=np.int8), _i((32,), 22, lo=-128, hi=128,
                                                                                dtype=np.int8)),
                    dict(w_bits=8, x_bits=8)),
    "htree_reduce": (lambda: (torch.from_numpy(floats((8, 5), 23)).to(torch.bfloat16),), dict()),
    "rglru_scan": (lambda: (torch.sigmoid(torch.from_numpy(floats((2, 5, 3), 24))),
                            torch.from_numpy(floats((2, 5, 3), 25)), torch.from_numpy(floats((2, 3), 26))),
                   dict()),
}


def test_every_registered_kernel_has_a_shape_inference_case():
    assert set(KERNEL_CALLS) == set(tapi.registered_kernels())


@pytest.mark.parametrize("name", sorted(KERNEL_CALLS))
def test_traced_kernel_aval_from_meta_oracle_equals_eager_output(name):
    make, kwargs = KERNEL_CALLS[name]
    args = make()
    prog = tapi.trace(lambda *a: tapi.dispatch(name, *a, **kwargs), name=name).program_for(*args)
    eager = tapi.dispatch(name, *args, **kwargs)
    assert prog.ops[0].out_aval == (tuple(eager.shape), str(eager.dtype).removeprefix("torch."))
    assert prog.ops[0].kwargs == tuple(sorted(kwargs.items()))
    assert torch.equal(tapi.compile(prog)(*args), eager)


# ---------------------------------------------------------------------------
# compile cache
# ---------------------------------------------------------------------------


def test_second_compile_with_identical_signature_is_cache_hit():
    _, tops = _block_operands(seed=10)
    traced = tapi.trace(_tblock, name="cache_hit_block")
    prog = traced.program_for(*tops)
    before = tapi.compile_cache_info()
    ex1 = tapi.compile(prog)
    mid = tapi.compile_cache_info()
    ex2 = tapi.compile(prog)
    after = tapi.compile_cache_info()
    assert mid.misses == before.misses + 1
    assert after.hits == mid.hits + 1 and after.misses == mid.misses
    assert ex1 is ex2
    prog2 = traced.trace(*tops)
    assert prog2 is not prog and prog2.signature() == prog.signature()
    assert tapi.compile(prog2) is ex1
    entry = [e for e in after.entries if e["name"] == "cache_hit_block"]
    assert entry == [{"name": "cache_hit_block", "backend": "eager",
                      "kernels": ["bitslice_matmul", "ewise_add", "relu"], "verify": None}]


def test_cache_miss_on_shape_and_precision_change():
    traced = tapi.trace(_tblock, name="cache_miss_block")
    base = tapi.compile(traced.program_for(*_block_operands(seed=20)[1]))
    info0 = tapi.compile_cache_info()
    tapi.compile(traced.program_for(*_block_operands(seed=21)[1]))  # fresh values: hit
    info1 = tapi.compile_cache_info()
    assert info1.hits == info0.hits + 1 and info1.misses == info0.misses
    tapi.compile(traced.program_for(*_block_operands(m=4, seed=22)[1]))  # new shape: miss
    info2 = tapi.compile_cache_info()
    assert info2.misses == info1.misses + 1
    ex16 = tapi.compile(traced.program_for(*_block_operands(seed=23, x_bits=16)[1]))  # 2 slices
    assert tapi.compile_cache_info().misses == info2.misses + 1 and ex16 is not base


def test_clear_compile_cache_and_generic_cached_executable():
    builds = []

    def build():
        builds.append(1)
        return object()

    key = ("test_generic", id(build))
    a = tprogram.cached_executable(key, build)
    assert tprogram.cached_executable(key, build) is a and len(builds) == 1
    tapi.clear_compile_cache()
    info = tapi.compile_cache_info()
    assert (info.hits, info.misses, info.size, info.entries) == (0, 0, 0, ())


def test_traced_call_runs_through_the_cache():
    _, tops = _block_operands(seed=25)
    traced = tapi.trace(_tblock, name="call_block")
    before = tapi.compile_cache_info()
    out1, out2 = traced(*tops), traced(*tops)
    after = tapi.compile_cache_info()
    assert after.misses == before.misses + 1 and after.hits == before.hits + 1
    assert torch.equal(out1, _tblock(*tops)) and torch.equal(out1, out2)


# ---------------------------------------------------------------------------
# placeholders, executors and what is not ported
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("misuse", ["add", "radd", "neg", "astype", "to", "torch.relu", "numpy",
                                    "matmul"])
def test_program_value_refuses_non_kernel_use(misuse):
    _, tops = _block_operands(seed=30)
    use = {
        "add": lambda v: v + 1, "radd": lambda v: 1 + v, "neg": lambda v: -v,
        "astype": lambda v: v.astype(np.float32), "to": lambda v: v.to(torch.float32),
        "torch.relu": torch.relu, "numpy": np.asarray, "matmul": lambda v: v @ v,
    }[misuse]

    def bad(xs, ws, y):
        return use(tapi.matmul(xs, ws))

    with pytest.raises(tapi.TraceError, match="bitslice_matmul"):
        tapi.trace(bad)(*tops)


def test_program_value_exposes_its_aval():
    _, (xs, ws, _) = _block_operands(seed=31)
    seen = {}

    def probe(xs, ws):
        v = tapi.matmul(xs, ws)
        seen.update(shape=v.shape, dtype=v.dtype, ndim=v.ndim)
        return v

    tapi.trace(probe).program_for(xs, ws)
    assert seen == {"shape": (8, 8), "dtype": torch.int32, "ndim": 2}


def test_trace_without_kernel_calls_raises():
    with pytest.raises(tapi.TraceError, match="no registry kernel"):
        tapi.trace(lambda x: x)(torch.zeros(3))


def test_executor_rejects_wrong_structure_and_avals():
    _, tops = _block_operands(seed=40)
    ex = tapi.compile(tapi.trace(_tblock, name="structure_block").program_for(*tops))
    with pytest.raises(TypeError, match="argument structure"):
        ex(*tops[:2])
    with pytest.raises(TypeError, match="argument structure"):
        ex(tops[0], tops[1], y=tops[2])
    with pytest.raises(TypeError, match="leaf shapes"):
        ex(*_block_operands(m=4, seed=41)[1])
    with pytest.raises(TypeError, match="leaf shapes"):
        ex(tops[0], tops[1], tops[2].to(torch.int64))


def test_executor_replays_with_fresh_values():
    _, tops = _block_operands(seed=50)
    ex = tapi.compile(tapi.trace(_tblock, name="replay_block").program_for(*tops))
    _, tops2 = _block_operands(seed=51)
    got1, got2 = ex(*tops), ex(*tops2)
    assert torch.equal(got2, _tblock(*tops2)) and not torch.equal(got1, got2)


def test_derived_input_constants_do_not_go_stale():
    traced = tapi.trace(lambda x, y: tapi.ewise_add(x + 0, y), name="derived_const")
    y = torch.zeros(4, dtype=torch.int32)
    x1 = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    x2 = torch.tensor([10, 20, 30, 40], dtype=torch.int32)
    assert torch.equal(traced(x1, y), x1) and torch.equal(traced(x2, y), x2)


def test_programs_differing_only_in_outputs_do_not_share_executors():
    _, tops = _block_operands(seed=45)

    def one(xs, ws, y):
        return tapi.relu(tapi.ewise_add(tapi.matmul(xs, ws), y))

    def both(xs, ws, y):
        s = tapi.ewise_add(tapi.matmul(xs, ws), y)
        return s, tapi.relu(s)

    p1 = tapi.trace(one, name="outs").program_for(*tops)
    p2 = tapi.trace(both, name="outs").program_for(*tops)
    assert p1.signature() != p2.signature()
    ex1, ex2 = tapi.compile(p1), tapi.compile(p2)
    assert ex1 is not ex2
    s, r = ex2(*tops)
    assert torch.equal(r, ex1(*tops)) and torch.equal(r, torch.clamp_min(s, 0))


def test_same_kernel_multiset_different_edges_do_not_collide():
    def wired(x, y):
        return tapi.ewise_add(tapi.relu(x), tapi.relu(y))

    def rewired(x, y):
        a = tapi.relu(x)
        tapi.relu(y)
        return tapi.ewise_add(a, a)

    x, y = _i((4, 8), 60), _i((4, 8), 61, lo=10, hi=90)
    p1 = tapi.trace(wired, name="multiset").program_for(x, y)
    p2 = tapi.trace(rewired, name="multiset").program_for(x, y)
    assert p1.kernels == p2.kernels and p1.signature() != p2.signature()
    assert torch.equal(tapi.compile(p1)(x, y), torch.clamp_min(x, 0) + torch.clamp_min(y, 0))
    assert torch.equal(tapi.compile(p2)(x, y), torch.clamp_min(x, 0) * 2)


def _state_step(api):
    def step(kc, new, onehot, q):
        return api.attention_qk(q, api.kv_append(kc, new, onehot))
    return step


@pytest.mark.parametrize("how", ["pimsab", "states", "chips=2"])
def test_parts_not_ported_yet_raise_not_implemented(how):
    """The parts once not ported are ported and equal JAX's: the pimsab
    Program lowering, ResidentState binding (states on the device path raise
    JAX's refusal) and multi-chip sharding (``chips=2`` on pimsab gives a
    ClusterExecutor whose output, plan and report equal JAX's; on the device
    path it raises JAX's refusal)."""
    jops, tops = _block_operands(seed=70)
    if how == "chips=2":
        prog = tapi.trace(_tblock, name="unported").program_for(*tops)
        jprog = japi.trace(_jblock, name="unported").program_for(*jops)
        with pytest.raises(NotImplementedError, match="chips/cluster sharding is a pimsab-backend concept"):
            tapi.compile(prog, chips=2)
        ex, jex = tapi.compile(prog, "pimsab", chips=2), japi.compile(jprog, "pimsab", chips=2)
        assert isinstance(ex, tapi.ClusterExecutor) and ex.cluster.chips == 2 and ex.plan == jex.plan
        got = ex(*tops)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jex(*jops)))
        np.testing.assert_array_equal(got.numpy(), tapi.compile(prog, "pimsab")(*tops).numpy())
        rep, jrep = ex.report.to_json(), jex.report.to_json()
        assert rep.pop("energy_j") == pytest.approx(jrep.pop("energy_j"), rel=1e-12, abs=0)
        assert rep == jrep
        return
    if how == "pimsab":
        prog = tapi.trace(_tblock, name="unported").program_for(*tops)
        jprog = japi.trace(_jblock, name="unported").program_for(*jops)
        ex, jex = tapi.compile(prog, "pimsab"), japi.compile(jprog, "pimsab")
        got, want, args = ex(*tops), jex(*jops), tops
    else:
        rng = np.random.default_rng(70)
        vals = [rng.integers(-8, 8, s).astype(np.int8) for s in ((8, 8), (8,), (1, 8))]
        onehot = np.zeros(8, np.int8)
        onehot[3] = 1
        init = ints((8, 8), -50, 50, 71)
        st, jst = tapi.ResidentState("kv", (8, 8), 8, init=init), japi.ResidentState("kv", (8, 8), 8, init=init)
        args = [torch.from_numpy(a) for a in (vals[0], vals[1], onehot, vals[2])]
        prog = tapi.trace(_state_step(tapi), name="unported_state").program_for(*args)
        jprog = japi.trace(_state_step(japi), name="unported_state").program_for(vals[0], vals[1], onehot, vals[2])
        with pytest.raises(NotImplementedError, match="ResidentState is a pimsab-backend concept"):
            tapi.compile(prog, states={0: st})
        ex, jex = tapi.compile(prog, "pimsab", states={0: st}), japi.compile(jprog, "pimsab", states={0: jst})
        got, want = ex(*args), jex(vals[0], vals[1], onehot, vals[2])
        np.testing.assert_array_equal(st.value.numpy(), jst.value)
        assert st.value[3].tolist() == vals[1].tolist()
    assert ex.backend == "pimsab" and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ex.report.to_json() == jex.report.to_json()
    entry = [e for e in tapi.compile_cache_info().entries if e["name"] == prog.name][-1]
    jentry = [e for e in japi.compile_cache_info().entries if e["name"] == jprog.name][-1]
    assert entry["verify"] == jentry["verify"]


def test_compile_accepts_one_chip_and_refuses_unknown_backends():
    _, tops = _block_operands(seed=71)
    prog = tapi.trace(_tblock, name="one_chip").program_for(*tops)
    assert tapi.compile(prog, chips=1) is tapi.compile(prog)
    with pytest.raises(ValueError, match="no backend scope"):
        tapi.compile(prog, backend="xla")


def test_resident_state_handle():
    st = tapi.ResidentState("kv", (4, 6), prec=8, init=np.arange(24).reshape(4, 6))
    assert st.spec() == ("kv", (4, 6), 8) and "kv" in repr(st)
    ph = st.placeholder()
    assert tuple(ph.shape) == (4, 6) and ph.dtype == torch.int8 and not ph.any()
    assert torch.equal(st.to_array(), torch.arange(24, dtype=torch.int8).reshape(4, 6))
    with pytest.raises(ValueError, match="2-D"):
        tapi.ResidentState("bad", (4,), 8)
    with pytest.raises(ValueError, match="init shape"):
        tapi.ResidentState("bad", (4, 6), 8, init=np.zeros((2, 2)))


# ---------------------------------------------------------------------------
# traced programs equal eager execution on CPU tensors
# ---------------------------------------------------------------------------


def test_traced_tiny_resnet_equals_eager_and_jax():
    cfg = tres.TINY
    params = tres.init_params(cfg, device="cpu")
    x = tres.make_input(cfg, 2, device="cpu")
    traced = tapi.trace(lambda p, v: tres.forward(cfg, p, v), name="tiny")
    tapi.reset_launch_counts()
    got = traced(params, x)
    assert tapi.launch_counts() == {}  # CPU tensors run the plain versions
    assert torch.equal(got, tres.forward(cfg, params, x))
    ex = tapi.compile(traced.program_for(params, x))
    assert torch.equal(ex(params, x), got)
    with japi.use_backend("xla"):
        want = jres.forward(jres.TINY, jres.init_params(jres.TINY), jres.make_input(jres.TINY, 2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_traced_module_forward_equals_eager():
    model = tres.ResNet(tres.TINY, device="cpu")
    x = tres.make_input(tres.TINY, 1, device="cpu")
    traced = tapi.trace(lambda v: model(v), name="module")
    prog = traced.program_for(x)
    assert prog.n_slots == 1 and len(prog.consts) == len(list(model.buffers()))
    assert torch.equal(traced(x), model(x))


def test_quant_linear_relu_runs_the_traced_program():
    w, x = floats((24, 16), 80, scale=0.1), floats((3, 24), 81)
    p = tcommon.quantize_weight(torch.from_numpy(w), 8)
    before = tapi.compile_cache_info()
    got = tcommon.quant_linear_relu(p, torch.from_numpy(x), tapi.PrecisionSpec.w8a16)
    again = tcommon.quant_linear_relu(p, torch.from_numpy(x), tapi.PrecisionSpec.w8a16)
    after = tapi.compile_cache_info()
    assert after.hits + after.misses == before.hits + before.misses + 2
    assert torch.equal(got, again) and bool((got >= 0).all())
    assert any(e["name"] == "quant_linear_relu" for e in after.entries)
