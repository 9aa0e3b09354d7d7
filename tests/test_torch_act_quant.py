"""The one-pass activation quantize (``kernels/act_quant.py``) in front of the
quantized linear.

On the CPU: its plain version is the PyTorch chain of
``models.common._dynamic_act_quant`` (which ``test_torch_bitslice.py`` and
``test_torch_quantize_saturation.py`` hold to the JAX package); its meta
route gives the card's shapes and dtypes, notes its work and launches
nothing; ``quant_linear`` routes a single-pass call through it and refuses,
on every device, what the card refuses.

On the card (marker ``cuda``; they skip without one): the kernel's int8
values and scales are ``torch.equal`` to the chain's, the quantized linear's
output is the chain's composition's, and the counters say which route a
call took.  Run them with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_act_quant.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.kernels import act_quant as aq  # noqa: E402
from repro_torch.kernels import api  # noqa: E402
from repro_torch.models import common  # noqa: E402

DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}
BITS = range(2, 9)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    return torch.device("cuda", 0)


def activations(m, k, dtype, seed, scale=3.0):
    x = np.random.default_rng(seed).standard_normal((m, k)) * scale
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def chain(x, bits):
    """The PyTorch chain the kernel replaces, on ``x``'s device."""
    return common._dynamic_act_quant(x, bits)


def meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# the CPU: the plain version, the plan, the meta route, the routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("bits", BITS)
def test_cpu_route_is_the_chain_and_launches_nothing(dtype, bits):
    x = activations(9, 37, DTYPES[dtype], bits)
    api.reset_launch_counts()
    got_q, got_s = api.act_quant(x.reshape(3, 3, 37), bits)
    want_q, want_s = chain(x, bits)
    assert api.launch_counts() == {}
    assert got_q.shape == (3, 3, 37) and got_s.shape == (3, 3, 1)
    assert torch.equal(got_q.reshape(9, 37), want_q) and torch.equal(got_s.reshape(9, 1), want_s)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plan_holds_every_row_in_registers(dtype):
    dt = DTYPES[dtype]
    epv = 16 // dt.itemsize
    for k in [1, 7, 16, 896, 2304, 2305, 5760, aq.act_quant_max_k(dt) - 1, aq.act_quant_max_k(dt)]:
        threads = aq.act_quant_plan(k, dt)
        assert threads % 32 == 0 and 32 <= threads <= aq.ACT_QUANT_MAX_THREADS, k
        assert threads * aq.ACT_QUANT_VPT >= k // epv, k  # the longest body a row can have
        assert threads == 32 or (threads - 32) * aq.ACT_QUANT_VPT < k // epv, k  # no idle warp


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_meta_route_gives_the_card_outputs_and_notes_its_work(dtype):
    dt = DTYPES[dtype]
    api.reset_launch_counts()
    api.reset_kernel_work()
    with api.kernels_as_units():
        q, s = api.act_quant(meta(4, 33, 2305, dtype=dt), 8)
        empty_q, empty_s = api.act_quant(meta(0, 2305, dtype=dt), 8)
    assert (q.device.type, q.dtype, tuple(q.shape)) == ("meta", torch.int8, (4, 33, 2305))
    assert (s.device.type, s.dtype, tuple(s.shape)) == ("meta", torch.float32, (4, 33, 1))
    assert tuple(empty_q.shape) == (0, 2305) and tuple(empty_s.shape) == (0, 1)
    assert api.launch_counts() == {}  # the meta route launches nothing
    # an empty call launches nothing on the card either, so only one is noted
    rows = 4 * 33
    assert api.kernel_work() == {"act_quant": {"calls": 1, "ops": 0.0,
                                               "bytes": rows * 2305 * (dt.itemsize + 1) + 4 * rows}}


def test_meta_route_refuses_what_the_card_refuses():
    with pytest.raises(TypeError, match="bfloat16, float16 or float32"):
        api.act_quant(meta(4, 16, dtype=torch.float64), 8)
    for bits in (1, 9):
        with pytest.raises(ValueError, match="2 to 8 bits"):
            api.act_quant(meta(4, 16), bits)
    with pytest.raises(ValueError, match="rows of 1 to 16384"):
        api.act_quant(meta(2, 16385, dtype=torch.float32), 8)
    with pytest.raises(ValueError, match="grid"):
        api.act_quant(meta(2**31, 1), 8)


@pytest.mark.parametrize("dtype,bits,k,takes", [
    (torch.bfloat16, 8, 2304, True), (torch.float16, 2, 5760, True), (torch.float32, 4, 16384, True),
    (torch.float32, 8, 16385, False), (torch.bfloat16, 8, 32768, True), (torch.bfloat16, 8, 32769, False),
    (torch.float64, 8, 64, False), (torch.bfloat16, 1, 64, False), (torch.bfloat16, 12, 64, False),
    (torch.bfloat16, 8, 0, False),
])
def test_act_quant_takes(dtype, bits, k, takes):
    assert aq.act_quant_takes(meta(3, k, dtype=dtype), bits) == takes


@pytest.mark.parametrize("dev", ["cpu", "meta"])
def test_quant_linear_refuses_what_the_kernel_does_not_take(dev):
    """A single-pass linear has no second route without a model shard: a
    dtype or a row the kernel does not take raises, on the CPU as on the
    card, and counts no fallback."""
    p = {k: v.to(dev) for k, v in common.quantize_weight(torch.randn(64, 24)).items()}
    obs.reset_counts("model.act_quant.torch")
    with pytest.raises(TypeError, match="bfloat16, float16 or float32"):
        common.quant_linear(p, torch.zeros(3, 64, dtype=torch.float64, device=dev))
    wide = {k: v.to(dev) for k, v in common.quantize_weight(torch.randn(16385, 2)).items()}
    with pytest.raises(ValueError, match="rows of 1 to 16384"):
        common.quant_linear(wide, torch.zeros(2, 16385, device=dev))
    assert obs.counts("model.act_quant.torch") == {}


@pytest.mark.parametrize("preset,noted", [("int8", 1), ("int4", 1), ("int16", 0), ("w8a16", 0)])
def test_quant_linear_notes_one_quantize_a_single_pass_call(preset, noted):
    """On ``meta`` (the dry run's stand-in for the card) and the CPU alike:
    a single-pass linear notes one activation quantize, a multi-pair one
    none (it quantizes into slices, as before)."""
    spec = getattr(api.PrecisionSpec, preset)
    p = common.quantize_weight(torch.randn(64, 24), spec.weight_bits)
    x = activations(2 * 5, 64, torch.float32, 1).reshape(2, 5, 64)
    want = common.quant_linear(p, x, spec)
    for dev in ("meta", "cpu"):
        api.reset_kernel_work()
        with api.kernels_as_units():
            got = common.quant_linear({k: v.to(dev) for k, v in p.items()}, x.to(dev), spec)
        assert api.kernel_work().get("act_quant", {"calls": 0})["calls"] == noted, dev
        assert got.shape == want.shape
        if dev == "cpu":
            assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 33, 4097])
@pytest.mark.parametrize("k", [7, 16, 896, 2304, 2305, 5760])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernel_equals_the_chain(card, dtype, k, m):
    x = activations(m, k, DTYPES[dtype], m * k).to(card)
    for bits in BITS:
        api.reset_launch_counts()
        got_q, got_s = api.act_quant(x, bits)
        want_q, want_s = chain(x, bits)
        torch.cuda.synchronize()
        assert api.launch_counts() == {"act_quant": 1}
        assert torch.equal(got_q, want_q) and torch.equal(got_s, want_s), bits


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernel_floors_a_zero_row_and_rounds_ties_to_even(card, dtype):
    """Rows of zeros (the 1e-8 floor) and of tiny values; rows whose
    ``x / scale`` lands on every half-integer of the range (scale 2**-3,
    the row's max qmax · 2**-3: exact in every dtype)."""
    dt = DTYPES[dtype]
    for bits in BITS:
        qmax = 2 ** (bits - 1) - 1
        halves = (np.arange(-qmax, qmax) + 0.5) / 8
        row = np.concatenate([halves, [qmax / 8], halves[::-1]])
        rows = np.stack([np.zeros_like(row), np.full_like(row, 1e-6), row, -row])
        x = torch.from_numpy(rows.astype(np.float32)).to(dt).to(card)
        got_q, got_s = api.act_quant(x, bits)
        want_q, want_s = chain(x, bits)
        assert torch.equal(got_q, want_q) and torch.equal(got_s, want_s), bits
        assert float(got_s[0]) == float(np.float32(1e-8)) and not got_q[0].any()
        assert float(got_s[2]) == 0.125 and bool((got_q[2, :len(halves)] % 2 == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernel_keeps_a_non_finite_row_non_finite(card, dtype):
    """A row with a NaN gets the chain's NaN scale, a row with an infinity
    its infinite one (an overflow shows in the dequantized output, not as a
    plausible scale); the finite rows, and the finite elements of an
    infinite row (0), equal the chain's.  Where ``x / scale`` is NaN the int8
    value is unspecified on both routes."""
    x = activations(6, 2305, DTYPES[dtype], 12)
    x[1, 700] = float("nan")
    x[2, 5] = float("inf")
    x[3, 2304] = -float("inf")
    x[4, 0] = float("nan")
    x[4, 9] = float("inf")
    x = x.to(card)
    got_q, got_s = api.act_quant(x, 8)
    want_q, want_s = chain(x, 8)
    assert torch.equal(got_s.isnan(), want_s.isnan()) and got_s.isnan().flatten().tolist() == [
        False, True, False, False, True, False]
    assert torch.equal(got_s.isinf(), want_s.isinf()) and bool(got_s[2:4].isinf().all())
    finite = ~(x.to(torch.float32) / want_s).isnan()
    assert torch.equal(got_s[[0, 5]], want_s[[0, 5]])
    assert torch.equal(got_q[finite], want_q[finite])
    assert not got_q[2:4][finite[2:4]].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernel_reads_non_contiguous_rows(card, dtype):
    """Rows a stride apart at no 16-byte boundary (a column slice), and a
    transposed matrix (its last dim strided: copied first)."""
    big = activations(4097, 2400, DTYPES[dtype], 11).to(card)
    for x in (big[:, 3:3 + 2305], big[:, 1:897], big[:64, :96].t()):
        got_q, got_s = api.act_quant(x, 8)
        want_q, want_s = chain(x, 8)
        assert got_q.is_contiguous() and torch.equal(got_q, want_q) and torch.equal(got_s, want_s)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(2304, 2304), (5760, 2304), (2305, 40)])
def test_quant_linear_output_is_the_chains_composition(card, k, n):
    """``quant_linear`` in bf16 on the card equals, bit for bit, the
    composition of the PyTorch chain, K4 and the dequantize."""
    p = {key: v.to(card) for key, v in common.quantize_weight(activations(k, n, torch.float32, 2, 0.02)).items()}
    x = activations(2 * 65, k, torch.bfloat16, 3).reshape(2, 65, k).to(card)
    got = common.quant_linear(p, x)
    x_q, x_scale = chain(x, 8)
    acc = common.int_matmul(x_q, p["w_q"])
    want = (acc.to(torch.float32) * x_scale * p["w_scale"]).to(x.dtype)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.cuda
def test_counters_say_which_route_a_call_took(card, tmp_path):
    """One single-pass ``quant_linear`` adds one ``launch.act_quant`` and no
    ``model.act_quant.torch``; a row-parallel one (``ms``, on an NCCL group
    of one rank) adds the reverse; a dtype the kernel does not read raises
    and adds neither."""
    import torch.distributed as dist

    from repro_torch.dist.sharding import ModelShard

    p = {key: v.to(card) for key, v in common.quantize_weight(torch.randn(64, 24)).items()}
    x = activations(8, 64, torch.bfloat16, 4).to(card)

    def routes(call):
        api.reset_launch_counts()
        obs.reset_counts("model.act_quant.torch")
        call()
        torch.cuda.synchronize()
        return api.launch_counts().get("act_quant", 0), obs.counts("model.act_quant.torch").get(
            "model.act_quant.torch", 0)

    assert routes(lambda: common.quant_linear(p, x)) == (1, 0)
    with pytest.raises(TypeError, match="bfloat16, float16 or float32"):
        routes(lambda: common.quant_linear(p, x.to(torch.float64)))
    assert api.launch_counts().get("act_quant", 0) == 0 and obs.counts("model.act_quant.torch") == {}
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rdzv'}", world_size=1, rank=0)
    try:
        ms = ModelShard(1, 0, dist.group.WORLD)
        want = common.quant_linear(p, x)
        got = []
        assert routes(lambda: got.append(common.quant_linear(p, x, ms=ms))) == (0, 1)
        assert torch.equal(got[0], want)  # one rank: the all-reduced scale is its own
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_prefill_logits_equal_the_chain_route(card, monkeypatch):
    """Qwen2-0.5B at full width, 2 layers, bfloat16 weights served int8: a
    4 × 40 prefill's logits are the same bits whether the activations take
    the kernel (one launch a linear) or the PyTorch chain (forced)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tt
    from repro_torch.models.runtime import RunFlags

    cfg = dataclasses.replace(get_config("qwen2-0.5b"), n_layers=2)
    params = common.maybe_quantize_tree(tt.init_params(cfg, 0, device=card), cfg)
    toks = torch.from_numpy(np.random.default_rng(5).integers(2, 1000, (4, 40)).astype(np.int32)).to(card)

    def prefill():
        api.reset_launch_counts()
        with torch.no_grad():
            _, logits = tt.prefill(params, cfg, {"tokens": toks}, RunFlags(), max_len=64)
        torch.cuda.synchronize()
        return logits, api.launch_counts()

    got, launches = prefill()
    monkeypatch.setattr(api, "act_quant", lambda x, bits=8: common._dynamic_act_quant(x, bits))
    want, chain_launches = prefill()
    assert launches == {"bitslice_matmul": 7 * cfg.n_layers, "act_quant": 7 * cfg.n_layers}
    assert chain_launches == {"bitslice_matmul": 7 * cfg.n_layers}
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
