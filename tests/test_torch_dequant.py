"""The quantized linear's dequantize in the bit-sliced GEMM's epilogue
(``api.dequant_matmul``, ``api.grouped_dequant_matmul``; ``csrc/
bitslice_gemm.cu``'s tensor-core kernels with ``Out`` a float type).

On the CPU: the plain versions equal the PyTorch chain the epilogue replaces
(int32 sums to float32, times the row scale, times the column scale, plus
the bias in float32, cast to the activation's dtype), written out here;
``dequant_matmul_takes`` says which products the kernel takes; the meta
route gives the card's shapes and dtypes and notes the output at the dtype
it writes; every device refuses what the card refuses; ``quant_linear`` and
the dropless expert layer give the same bits on either route.

On the card (marker ``cuda``; they skip without one): each kernel equals
its plain version on the CPU and its own int32 output followed by the
chain, bit for bit (a NaN row by position), over output dtypes, biases (K4
alone), tiles, ragged M, N % 4 == 0 alone, empty and one-row groups and the
benchmark cells' shapes; the counters say which route a linear took.  Run them with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_dequant.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.kernels import api  # noqa: E402
from repro_torch.kernels import bitslice_matmul as bm  # noqa: E402
from repro_torch.models import common, moe  # noqa: E402

DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}
BIASES = ("none", "same", "f32")  # no bias, one of the output's dtype, a float32 one


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    return torch.device("cuda", 0)


def chain(acc, x_scale, w_scale, bias, dtype):
    """The dequantize as ``models.common.quant_linear`` wrote it before the
    epilogue: row scales (M, 1), column scales (1, N) or (M, N)."""
    out = acc.to(torch.float32) * x_scale * w_scale
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(dtype)


def operands(m, k, n, dtype, bias, seed, groups=None):
    """Activations quantized as the linear quantizes them (int8 and their
    row scales), a quantized weight (one, or ``groups`` of them) with its
    column scales, and a bias of the named kind."""
    g = torch.Generator().manual_seed(seed)
    x = (3.0 * torch.randn(m, k, generator=g)).to(dtype)
    x_q, x_scale = api.act_quant_plain(x, 8)
    lead = () if groups is None else (groups,)
    wq = common.quantize_weight(0.05 * torch.randn(*lead, k, n, generator=g))
    b = None if bias == "none" else torch.randn(*lead, n, generator=g).to(
        dtype if bias == "same" else torch.float32)
    return x_q, x_scale, wq["w_q"], wq["w_scale"], b


def same_bits(got, want):
    """Equal, with NaN compared by position (the kernel's NaN and PyTorch's
    differ in payload)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], want[~nan])


# ---------------------------------------------------------------------------
# the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bias", BIASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_version_is_the_chain(dtype, bias):
    x_q, x_scale, w_q, w_scale, b = operands(37, 64, 20, DTYPES[dtype], bias, 1)
    got = api.dequant_matmul(x_q, w_q, x_scale, w_scale, b, DTYPES[dtype])
    assert torch.equal(got, chain(common.int_matmul(x_q, w_q), x_scale, w_scale, b, DTYPES[dtype]))


# name → rows of each group: empty groups inside, at both ends, one group
PLAIN_GROUPS = {"ragged": [5, 0, 17, 1, 0, 9], "empty-ends": [0, 7, 0, 0, 4, 0], "one-group": [23]}


@pytest.mark.parametrize("layout", sorted(PLAIN_GROUPS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_grouped_plain_version_is_the_chain_with_each_rows_expert_scales(dtype, layout):
    counts = PLAIN_GROUPS[layout]
    x_q, x_scale, w_q, w_scale, _ = operands(sum(counts), 32, 24, DTYPES[dtype], "none", 2, groups=len(counts))
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int32)
    got = api.grouped_dequant_matmul(x_q, w_q, offsets, x_scale, w_scale, DTYPES[dtype])
    expert = torch.repeat_interleave(torch.arange(len(counts)), torch.tensor(counts))
    want = chain(api.grouped_matmul(x_q, w_q, offsets), x_scale, w_scale.squeeze(-2).index_select(0, expert),
                 None, DTYPES[dtype])
    assert torch.equal(got, want)


def test_dequant_matmul_takes_the_tensor_core_path_within_one_fold():
    x = torch.zeros(8, 64, dtype=torch.int8)
    w = torch.zeros(64, 40, dtype=torch.int8)
    assert api.dequant_matmul_takes(x, w) and api.dequant_matmul_takes(x.reshape(2, 4, 64), w)
    assert not api.dequant_matmul_takes(x[:, :40], w[:40])  # K % 16
    assert not api.dequant_matmul_takes(x, w[:, :38])  # N % 4
    assert not api.dequant_matmul_takes(x.to(torch.int32), w)
    buf = torch.zeros(8 * 64 + 1, dtype=torch.int8)
    assert not api.dequant_matmul_takes(buf[1:].view(8, 64), w)  # x off 16 bytes: the dp4a path
    k = bm.ONE_PAIR_FOLD_K
    assert api.dequant_matmul_takes(torch.zeros(1, k, dtype=torch.int8), torch.zeros(k, 4, dtype=torch.int8))
    assert not api.dequant_matmul_takes(torch.zeros(1, k + 128, dtype=torch.int8),
                                        torch.zeros(k + 128, 4, dtype=torch.int8))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_meta_route_gives_the_cards_output_and_notes_its_bytes(dtype):
    x_q, x_scale, w_q, w_scale, b = operands(33, 48, 28, DTYPES[dtype], "same", 3)
    meta = [t.to("meta") for t in (x_q, w_q, x_scale, w_scale, b)]
    api.reset_launch_counts()
    api.reset_kernel_work()
    with api.kernels_as_units():
        out = api.dequant_matmul(meta[0], meta[1], meta[2], meta[3], meta[4], DTYPES[dtype])
    work = api.kernel_work()
    api.reset_kernel_work()
    assert out.device.type == "meta" and tuple(out.shape) == (33, 28) and out.dtype == DTYPES[dtype]
    assert api.launch_counts() == {}
    size = DTYPES[dtype].itemsize
    assert work == {"bitslice_matmul": {"calls": 1, "ops": 2 * 33 * 48 * 28, "bytes": bm.dequant_work(
        33, 48, 28, 1, size, size)[1]}}
    assert bm.dequant_work(33, 48, 28, 1, size, size)[1] == 33 * 48 + 48 * 28 + 4 * 33 + 28 * (4 + size) + \
        33 * 28 * size
    counts = [3, 0, 4]
    xg, sg, wg, wsg, _ = operands(7, 32, 20, DTYPES[dtype], "none", 4, groups=3)
    offsets = torch.tensor([0, 3, 3, 7], dtype=torch.int32)
    out = api.grouped_dequant_matmul(*(t.to("meta") for t in (xg, wg, offsets, sg, wsg)), out_dtype=DTYPES[dtype])
    assert out.device.type == "meta" and tuple(out.shape) == (sum(counts), 20) and out.dtype == DTYPES[dtype]


@pytest.mark.parametrize("dev", ["cpu", "meta"])
def test_every_device_refuses_what_the_card_refuses(dev):
    x_q, x_scale, w_q, w_scale = (t.to(dev) for t in operands(8, 64, 24, torch.bfloat16, "none", 5)[:4])
    call = api.dequant_matmul
    with pytest.raises(ValueError, match="K % 16"):
        call(x_q[:, :40], w_q[:40], x_scale, w_scale)
    with pytest.raises(ValueError, match="N % 4"):
        call(x_q, w_q[:, :22], x_scale, w_scale.reshape(-1)[:22])
    with pytest.raises(ValueError, match="one fold"):
        k = bm.ONE_PAIR_FOLD_K + 16
        call(torch.zeros(1, k, dtype=torch.int8, device=dev), torch.zeros(k, 4, dtype=torch.int8, device=dev),
             x_scale[:1], w_scale.reshape(-1)[:4])
    with pytest.raises(ValueError, match="elements"):
        call(x_q, w_q, x_scale[:4], w_scale)
    with pytest.raises(ValueError, match="shapes"):  # K of x and w differ
        call(x_q, w_q[:48], x_scale, w_scale)
    with pytest.raises(TypeError):
        call(x_q.to(torch.int32), w_q, x_scale, w_scale)
    with pytest.raises(TypeError):
        call(x_q, w_q, x_scale, w_scale, out_dtype=torch.float64)
    xg, sg, wg, wsg = (t.to(dev) for t in operands(7, 48, 20, torch.bfloat16, "none", 6, groups=2)[:4])
    offsets = torch.tensor([0, 3, 7], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="K % 16"):
        api.grouped_dequant_matmul(xg[:, :24], wg[:, :24], offsets, sg, wsg)
    with pytest.raises(ValueError, match="N % 4"):
        api.grouped_dequant_matmul(xg, wg[..., :18], offsets, sg, wsg[..., :18])
    with pytest.raises(ValueError, match="elements"):
        api.grouped_dequant_matmul(xg, wg, offsets, sg, wsg[:1])
    with pytest.raises(TypeError):
        api.grouped_dequant_matmul(xg, wg, offsets.to(torch.int64), sg, wsg)


@pytest.mark.parametrize("k, n", [(64, 40), (40, 24), (64, 22)], ids=["epilogue", "K%16", "N%4"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quant_linear_gives_the_same_bits_on_either_route(monkeypatch, dtype, k, n):
    """Where the kernel takes the product (or not: K % 16, N % 4), the
    linear equals the int32 product and the chain; forcing the chain gives
    the same bits."""
    g = torch.Generator().manual_seed(7)
    p = dict(common.quantize_weight(0.1 * torch.randn(k, n, generator=g)),
             b=torch.randn(n, generator=g).to(DTYPES[dtype]))
    x = torch.randn(2, 9, k, generator=g).to(DTYPES[dtype])
    got = common.quant_linear(p, x)
    x_q, x_scale = api.act_quant(x, 8)
    assert torch.equal(got, chain(common.int_matmul(x_q, p["w_q"]), x_scale, p["w_scale"], p["b"], x.dtype))
    monkeypatch.setattr(api, "dequant_matmul_takes", lambda *a: False)
    assert torch.equal(common.quant_linear(p, x), got)


def test_a_moe_layer_gives_the_same_bits_as_the_chain_after_the_grouped_product(monkeypatch):
    """The dropless expert layer's grouped linears dequantize in the
    epilogue; replacing it by ``grouped_matmul`` and the chain with each
    row's expert's scales (the layer before the epilogue) changes no bit."""
    import dataclasses

    from repro_torch.configs.moonlight_16b_a3b import CONFIG

    cfg = dataclasses.replace(CONFIG, d_model=64, n_experts=8, experts_per_token=2, moe_d_ff=32,
                              n_shared_experts=1, dtype="bfloat16")
    p = common.maybe_quantize_tree({"ffn": moe.dropless_moe_init(torch.Generator().manual_seed(0), cfg,
                                                                 torch.bfloat16, device="cpu")}, cfg)["ffn"]
    x = torch.randn(2, 11, 64, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    got, _ = moe.dropless_moe_ffn(p, x, cfg)

    def grouped_then_chain(x_q, w_q, offsets, x_scale, w_scale, out_dtype):
        counts = (offsets[1:] - offsets[:-1]).to(torch.int64)
        expert = torch.repeat_interleave(torch.arange(w_q.shape[0]), counts)
        return chain(api.grouped_matmul(x_q, w_q, offsets), x_scale,
                     w_scale.squeeze(-2).index_select(0, expert), None, out_dtype)

    monkeypatch.setattr(api, "grouped_dequant_matmul", grouped_then_chain)
    want, _ = moe.dropless_moe_ffn(p, x, cfg)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

# name → (M, K, N): the square tile with 16-byte w copies, the narrow tile
# (N <= 32) at N % 16 == 0 and at N % 4 == 0 alone, the square tile with
# 4-byte w copies, M off the tile, MiniCPM-2B's prefill shapes
CARD_SHAPES = {
    "square": (256, 256, 256),
    "narrow-N32": (200, 128, 32),
    "narrow-N20": (77, 64, 20),
    "square-N100": (130, 208, 100),
    "square-M300-N36": (300, 144, 36),
    "minicpm-qkvo": (512, 2304, 2304),
    "minicpm-gate-up": (512, 2304, 5760),
    "minicpm-down": (512, 5760, 2304),
}


def card_reference(x_q, w_q, x_scale, w_scale, b, dtype):
    """The kernel's own int32 output (the same path without the epilogue),
    then the chain, on the card."""
    acc = bm._bitslice_gemm(x_q[None], w_q[None], 8, bm.ONE_PAIR)
    return chain(acc, x_scale, w_scale, b, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("bias", BIASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CARD_SHAPES))
def test_kernel_equals_its_int32_output_and_the_chain(card, case, dtype, bias):
    """Equal to the plain version on the CPU (float64 products, then the
    chain) and to the same path's int32 output, then the chain."""
    m, k, n = CARD_SHAPES[case]
    x_q, x_scale, w_q, w_scale, b = operands(m, k, n, DTYPES[dtype], bias, len(case))
    ops = [t if t is None else t.to(card) for t in (x_q, w_q, x_scale, w_scale, b)]
    api.reset_launch_counts()
    got = api.dequant_matmul(*ops, out_dtype=DTYPES[dtype])
    torch.cuda.synchronize()
    assert api.launch_counts() == {"bitslice_matmul": 1} and bm.launched_path() == "mma"
    same_bits(got.cpu(), api.dequant_matmul(x_q, w_q, x_scale, w_scale, b, DTYPES[dtype]))
    same_bits(got, card_reference(*ops, DTYPES[dtype]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernel_keeps_non_finite_scales_where_the_chain_does(card, dtype):
    """A row whose scale is NaN or infinite, a column whose scale is NaN: the
    NaN and infinite outputs fall where the chain's do."""
    cpu = operands(70, 96, 48, DTYPES[dtype], "same", 9)
    cpu[1][3], cpu[1][65] = float("nan"), float("inf")
    cpu[3][0, 7] = float("nan")
    x_q, x_scale, w_q, w_scale, b = (t.to(card) for t in cpu)
    got = api.dequant_matmul(x_q, w_q, x_scale, w_scale, b, DTYPES[dtype])
    want = card_reference(x_q, w_q, x_scale, w_scale, b, DTYPES[dtype])
    same_bits(got, want)
    same_bits(got.cpu(), api.dequant_matmul(cpu[0], cpu[2], cpu[1], cpu[3], cpu[4], DTYPES[dtype]))
    assert bool(torch.isnan(got[3]).all()) and bool(torch.isnan(got[:, 7]).all())


@pytest.mark.cuda
def test_kernel_refuses_operands_off_its_alignment(card):
    x_q, x_scale, w_q, w_scale = (t.to(card) for t in operands(8, 64, 24, torch.bfloat16, "none", 10)[:4])
    buf = torch.empty(x_q.numel() + 1, dtype=torch.int8, device=card)
    shifted = buf[1:].view(x_q.shape)
    shifted.copy_(x_q)
    with pytest.raises(ValueError, match="aligned"):
        api.dequant_matmul(shifted, w_q, x_scale, w_scale)


def card_groups(counts, k, n, dtype, seed, card):
    """Grouped operands on the CPU and their copies on the card: (x_q, w_q,
    offsets, x_scale, w_scale) each."""
    x_q, x_scale, w_q, w_scale, _ = operands(sum(counts), k, n, dtype, "none", seed, groups=len(counts))
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int32)
    cpu = (x_q, w_q, offsets, x_scale, w_scale)
    return cpu, [t.to(card) for t in cpu]


def routed_counts(rows_per_expert, experts, seed):
    rng = np.random.default_rng(seed)
    return list(rng.multinomial(rows_per_expert * experts, rng.dirichlet(np.full(experts, 20.0))))


# name → (rows of each group, K, N): an empty group and a one-row group on
# each tile, 64 experts at Moonlight-16B-A3B's two projections at a small R
CARD_GROUPS = {
    "ragged-empty-one-row": ([5, 0, 300, 1, 0, 129, 128, 0], 64, 144),
    "narrow-N20": ([100, 0, 1, 256], 48, 20),
    "moonlight-gate-up": (routed_counts(12, 64, 1), 2048, 2816),
    "moonlight-down": (routed_counts(12, 64, 2), 1408, 2048),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CARD_GROUPS))
def test_grouped_kernel_equals_its_int32_output_and_the_chain(card, case, dtype):
    """Equal to the plain version on the CPU (each group's float64
    products, then the chain with each row's group's scales) and to the
    grouped int32 output, then the chain."""
    counts, k, n = CARD_GROUPS[case]
    cpu, (x_q, w_q, offsets, x_scale, w_scale) = card_groups(counts, k, n, DTYPES[dtype], len(case), card)
    api.reset_launch_counts()
    got = api.grouped_dequant_matmul(x_q, w_q, offsets, x_scale, w_scale, DTYPES[dtype])
    torch.cuda.synchronize()
    assert api.launch_counts() == {"grouped_matmul": 1}
    same_bits(got.cpu(), api.grouped_dequant_matmul(*cpu, DTYPES[dtype]))
    acc = api.grouped_matmul(x_q, w_q, offsets)
    expert = torch.repeat_interleave(torch.arange(len(counts), device=card),
                                     torch.tensor(counts, device=card))
    same_bits(got, chain(acc, x_scale, w_scale.squeeze(-2).index_select(0, expert), None, DTYPES[dtype]))


@pytest.mark.cuda
def test_counters_say_where_a_linear_dequantized(card):
    """A linear the kernel takes adds one ``model.dequant.epilogue``; K %
    16 != 0 (the dp4a path) and N % 4 != 0 add one ``model.dequant.torch``
    (K past one fold cannot reach it: the activation quantize takes rows of
    at most 32768); a grouped linear adds one ``model.dequant.epilogue``.
    Each route equals the int32 product and the chain."""
    def routes(call):
        obs.reset_counts("model.dequant.")
        out = call()
        torch.cuda.synchronize()
        c = obs.counts("model.dequant.")
        return out, (c.get("model.dequant.epilogue", 0), c.get("model.dequant.torch", 0))

    for k, n, want in ((2304, 16, (1, 0)), (2312, 16, (0, 1)), (2304, 18, (0, 1))):
        g = torch.Generator(device=card).manual_seed(k + n)
        p = {key: v.to(card) for key, v in common.quantize_weight(0.02 * torch.randn(k, n)).items()}
        x = torch.randn(4, k, generator=g, device=card).to(torch.bfloat16)
        out, got = routes(lambda: common.quant_linear(p, x))
        assert got == want, k
        x_q, x_scale = api.act_quant(x, 8)
        assert torch.equal(out, chain(common.int_matmul(x_q, p["w_q"]), x_scale, p["w_scale"], None, x.dtype))
    _, (x_q, w_q, offsets, x_scale, w_scale) = card_groups([3, 0, 9], 64, 32, torch.bfloat16, 11, card)
    p = {"w_q": w_q, "w_scale": w_scale}
    _, got = routes(lambda: moe._grouped_linear(p, torch.randn(12, 64, device=card).to(torch.bfloat16), offsets))
    assert got == (1, 0)
