"""The port's decode programs (``repro_torch.serve.pimsab_step``) against the
JAX package's ``serve/pimsab_step.py``.

Both packages trace the same programs: their signatures must agree field for
field.  Both then run them on the same numpy-seeded caches, queries, rows
and weights: the port on CPU tensors (the kernels' plain versions), the JAX
package through ``api.compile`` on its ``"xla"`` backend (the oracles) and
its ``"interpret"`` backend (the Pallas bodies).  Outputs must be bit-equal.
Every case also asserts that the fixed-point softmax it runs is not
degenerate (rows summing to at least 32 of 64, and more than one nonzero
probability somewhere), since an all-zero or one-hot softmax would make the
comparison nearly empty.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import api as japi  # noqa: E402
from repro.serve import pimsab_step as jps  # noqa: E402
from repro_torch.kernels import api as tapi  # noqa: E402
from repro_torch.serve import pimsab_step as tps  # noqa: E402

# Qwen2-0.5B's attention width (src/repro/configs/qwen2_0_5b.py: head_dim 64)
QWEN = dict(head_dim=64, value_dim=64, kv_bits=8, q_bits=8, score_bits=22, score_frac=13)
# head_dim 8 scores spread less than head_dim 64 ones: fewer fraction bits
# keep the softmax as sharp
SMALL = dict(head_dim=8, value_dim=8, kv_bits=8, q_bits=8, score_bits=22, score_frac=11)


def ints(shape, lo, hi, rng, dtype=np.int8):
    return rng.integers(lo, hi, shape).astype(dtype)


def _assert_same_program(jp, tp):
    assert tp.name == jp.name and tp.n_slots == jp.n_slots
    assert [(o.kernel, o.inputs, o.kwargs, o.out_aval) for o in tp.ops] == \
        [(o.kernel, o.inputs, o.kwargs, o.out_aval) for o in jp.ops]
    assert tp.slot_avals == jp.slot_avals
    assert tp.out_refs == jp.out_refs
    assert tp.const_fingerprints() == tuple(jp.signature()[-1]) == ()


def _probs(q, kc, score_frac):
    """The step's softmax output, recomputed with the port's kernels."""
    return tapi.softmax_fixedpoint(tapi.attention_qk(q, kc), in_frac=score_frac)


def _assert_not_degenerate(prob_rows):
    for p in prob_rows:
        assert int(p.sum(dim=-1).min()) >= 32, p.sum(dim=-1)
    assert max(int((p != 0).sum(dim=-1).max()) for p in prob_rows) >= 2


# ---------------------------------------------------------------------------
# configuration and signatures
# ---------------------------------------------------------------------------


def test_config_and_state_handles_equal_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(jps.AttnServeConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tps.AttnServeConfig)]
    assert tf == jf
    for kw in ({}, QWEN):
        jcfg, tcfg = jps.AttnServeConfig(**kw), tps.AttnServeConfig(**kw)
        assert tcfg.state_rows() == jcfg.state_rows()
        for js, ts in zip(jps.kv_states(jcfg, 64), tps.kv_states(tcfg, 64)):
            assert ts.spec() == js.spec()
            assert tuple(ts.placeholder().shape) == js.placeholder().shape
            assert str(ts.placeholder().dtype).removeprefix("torch.") == str(js.placeholder().dtype)


@pytest.mark.parametrize("cfg,capacity", [({}, 4), ({}, 8), (QWEN, 64)], ids=["default-4", "default-8", "qwen-64"])
def test_decode_program_equals_jax(cfg, capacity):
    jp = jps.decode_program(jps.AttnServeConfig(**cfg), capacity)
    tp = tps.decode_program(tps.AttnServeConfig(**cfg), capacity)
    _assert_same_program(jp, tp)
    assert tp.kernels == ("kv_append", "kv_append", "attention_qk", "softmax_fixedpoint", "attention_pv")
    assert tps.decode_program(tps.AttnServeConfig(**cfg), capacity) is tp  # cached per bucket


def test_decode_layer_program_equals_jax_at_its_defaults():
    jp, tp = jps.decode_layer_program(), tps.decode_layer_program()
    _assert_same_program(jp, tp)
    assert tp.kernels == ("attention_qk", "softmax_fixedpoint", "attention_pv",
                          "int_matmul", "int_matmul", "relu", "int_matmul")


def test_requests_of_a_bucket_share_one_executor():
    prog = tps.decode_program(tps.AttnServeConfig(**SMALL), 48)
    before = tapi.compile_cache_info()
    executors = [tapi.compile(tps.decode_program(tps.AttnServeConfig(**SMALL), 48)) for _ in range(3)]
    after = tapi.compile_cache_info()
    assert after.misses == before.misses + 1 and after.hits == before.hits + 2
    assert all(ex is executors[0] for ex in executors) and executors[0].program is prog


# ---------------------------------------------------------------------------
# outputs bit-equal to the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["xla", "interpret"])
def test_decode_contexts_equal_jax(backend):
    """Three requests of one bucket (head_dim 8, capacity 64), four decode
    steps each; each package carries its caches with its own kv_append."""
    capacity, steps = 64, 4
    rng = np.random.default_rng(7)
    jcfg, tcfg = jps.AttnServeConfig(**SMALL), tps.AttnServeConfig(**SMALL)
    jex = japi.compile(jps.decode_program(jcfg, capacity), backend)
    tex = tapi.compile(tps.decode_program(tcfg, capacity))
    probs = []
    for length in (10, 33, 60):
        kc = np.zeros((capacity, SMALL["head_dim"]), np.int8)
        vc = np.zeros((capacity, SMALL["value_dim"]), np.int8)
        kc[:length] = ints((length, SMALL["head_dim"]), -128, 128, rng)
        vc[:length] = ints((length, SMALL["value_dim"]), -128, 128, rng)
        tkc, tvc = torch.from_numpy(kc), torch.from_numpy(vc)
        for i in range(steps):
            q = ints((1, SMALL["head_dim"]), -128, 128, rng)
            k_new = ints((SMALL["head_dim"],), -128, 128, rng)
            v_new = ints((SMALL["value_dim"],), -128, 128, rng)
            onehot = np.zeros(capacity, np.int8)
            onehot[length + i] = 1
            want = np.asarray(jex(kc, vc, q, k_new, v_new, onehot))
            targs = [torch.from_numpy(a) for a in (q, k_new, v_new, onehot)]
            got = tex(tkc, tvc, *targs)
            assert got.dtype == torch.int32 and got.shape == (1, SMALL["value_dim"])
            np.testing.assert_array_equal(got.numpy(), want)
            with japi.use_backend(backend):
                kc = np.asarray(japi.kv_append(kc, k_new, onehot))
                vc = np.asarray(japi.kv_append(vc, v_new, onehot))
            tkc = tapi.kv_append(tkc, targs[1], targs[3])
            tvc = tapi.kv_append(tvc, targs[2], targs[3])
            np.testing.assert_array_equal(tkc.numpy(), kc)
            np.testing.assert_array_equal(tvc.numpy(), vc)
            probs.append(_probs(targs[0], tkc, SMALL["score_frac"]))
    _assert_not_degenerate(probs)


# case → (kwargs, q/K/V half-range, weight half-range)
LAYER = {
    # the program's own precisions (3-bit q/K/V, 4-bit weights), with scores
    # read at 4 fraction bits: at its default 7 the 3-bit scores' softmax is
    # nearly flat (row sums 10-43 of 64)
    "default-precision": (dict(score_frac=4), 4, 8),
    # Qwen2-0.5B's attention precision: int8 everything, score_frac 13
    "int8": (dict(q_bits=8, kv_bits=8, score_bits=22, score_frac=13, w_bits=8), 128, 128),
}


@pytest.mark.parametrize("case", sorted(LAYER))
@pytest.mark.parametrize("backend", ["xla", "interpret"])
def test_decode_layer_outputs_equal_jax(case, backend):
    kwargs, qkv_half, w_half = LAYER[case]
    model_dim, head_dim, ff_dim, capacity = 64, 16, 128, 64
    rng = np.random.default_rng(11)
    args = (ints((capacity, head_dim), -qkv_half, qkv_half, rng),
            ints((capacity, head_dim), -qkv_half, qkv_half, rng),
            ints((1, head_dim), -qkv_half, qkv_half, rng),
            ints((head_dim, model_dim), -w_half, w_half, rng),
            ints((model_dim, ff_dim), -w_half, w_half, rng),
            ints((ff_dim, model_dim), -w_half, w_half, rng))
    jp = jps.decode_layer_program(model_dim, head_dim, ff_dim, capacity, **kwargs)
    tp = tps.decode_layer_program(model_dim, head_dim, ff_dim, capacity, **kwargs)
    _assert_same_program(jp, tp)
    want = np.asarray(japi.compile(jp, backend)(*args))
    targs = [torch.from_numpy(a) for a in args]
    got = tapi.compile(tp)(*targs)
    assert got.dtype == torch.int32 and got.shape == (1, model_dim)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.any()
    _assert_not_degenerate([_probs(targs[2], targs[0], kwargs.get("score_frac", 7))])


def test_resident_state_value_feeds_a_slot():
    """A cache held as a ResidentState enters a program as a plain slot
    through ``to_array()``."""
    cfg = tps.AttnServeConfig(**SMALL)
    rng = np.random.default_rng(3)
    kst, vst = tps.kv_states(cfg, 16)
    kst.value = torch.from_numpy(ints((16, 8), -128, 128, rng, np.int64))
    vst.value = torch.from_numpy(ints((16, 8), -128, 128, rng, np.int64))
    q, k_new, v_new = (torch.from_numpy(ints(s, -128, 128, rng)) for s in ((1, 8), (8,), (8,)))
    onehot = torch.zeros(16, dtype=torch.int8)
    onehot[15] = 1
    ex = tapi.compile(tps.decode_program(cfg, 16))
    got = ex(kst.to_array(), vst.to_array(), q, k_new, v_new, onehot)
    kc, vc = tapi.kv_append(kst.to_array(), k_new, onehot), tapi.kv_append(vst.to_array(), v_new, onehot)
    want = tapi.attention_pv(_probs(q, kc, SMALL["score_frac"]), vc)
    assert torch.equal(got, want)
