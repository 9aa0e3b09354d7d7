"""Moonlight-16B-A3B's architecture in the port (``configs.base.MLAMoEConfig``:
latent attention with a latent cache, dropless sigmoid-routed experts beside
shared ones, the grouped bit-sliced GEMM) against a plain float32 reference
(``_torch_mla_moe_ref.py``, which imports no JAX and nothing of the port).

On the CPU at a small size (d 64, 4 heads, nope/rope/v 16/8/16, latent 32,
8 experts top-2 with 1 shared, layer 0 dense, 3 layers), float32 weights:
the prefill logits, prefill then three decode steps through the latent
cache against the full forward, the routing (its bias included), a token's
output independent of the batch, the grouped product's plain version
against per-expert ``int_matmul`` with empty and ragged experts, and the
int4-weight control outside the tolerance that the program keeps.

On the card (marker ``cuda``; they skip without one) the grouped kernel is
``torch.equal`` to its plain version at Moonlight-16B-A3B's shapes and at
edges, and one expert layer runs under ``torch.cuda.set_sync_debug_mode
("error")``.  Run them with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mla_moe.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.configs.base import mla_moe_pattern  # noqa: E402
from repro_torch.configs.moonlight_16b_a3b import CONFIG  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.kernels import api  # noqa: E402
from repro_torch.kernels import bitslice_matmul as bm  # noqa: E402
from repro_torch.models import common, moe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.runtime import RunFlags  # noqa: E402

import _torch_mla_moe_ref as ref  # noqa: E402

SMALL = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=24, d_ff=96, vocab_size=256,
    block_pattern=mla_moe_pattern(3, 1), n_experts=8, experts_per_token=2, kv_lora_rank=32, qk_nope_head_dim=16,
    qk_rope_head_dim=8, v_head_dim=16, moe_d_ff=32, n_shared_experts=1, dtype="float32")
# float32 through the same ops as the reference, in another order (the
# combine sums a token's experts in float32 in its own order, the reference
# token by token; the attention's einsums group their sums otherwise): a
# few float32 ulps of the largest logit
TOL = 2e-5
ROUTES = {"float": None, "int8": 8}


@pytest.fixture(scope="module")
def params():
    return T.init_params(SMALL, 3, device="cpu")


def served(params, bits):
    return params if bits is None else common.maybe_quantize_tree(params, SMALL)


def tokens(b=3, s=12, seed=0):
    t = torch.from_numpy(np.random.default_rng(seed).integers(0, SMALL.vocab_size, (b, s)))
    t[0, :4] = 0  # left padding, as the engine pads
    return t


def rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------


def test_config_is_the_published_model_and_stays_out_of_the_registry():
    assert CONFIG.name not in list_archs()
    kinds = CONFIG.layer_kinds()
    assert len(kinds) == 27 and kinds[0] == "mla" and set(kinds[1:]) == {"mla_moe"}
    assert (CONFIG.d_model, CONFIG.n_heads, CONFIG.kv_lora_rank, CONFIG.resolved_head_dim, CONFIG.v_head_dim) == \
        (2048, 16, 512, 192, 128)
    assert (CONFIG.n_experts, CONFIG.experts_per_token, CONFIG.n_shared_experts, CONFIG.moe_d_ff, CONFIG.d_ff) == \
        (64, 6, 2, 1408, 11264)
    assert CONFIG.padded_vocab() == CONFIG.vocab_size == 163840 and not CONFIG.tie_embeddings
    assert round(CONFIG.param_count() / 1e9, 2) == 15.96 and round(CONFIG.active_param_count() / 1e9, 2) == 2.91


def test_full_size_tree_on_meta_holds_the_param_count_and_serves_at_16_gb():
    from repro_torch.serve.engine import serve_params_shape

    tree = T.params_shape(CONFIG)
    assert sum(t.numel() for t in T._tree_leaves(tree)) == CONFIG.param_count()
    moe_layer = tree["blocks"]["01_mla_moe"]["ffn"]
    assert tuple(moe_layer["experts"]["gate_up"]["w"].shape) == (1, 64, 2048, 2816)
    served_bytes = T.param_bytes(serve_params_shape(CONFIG))
    # 15.96 G parameters at a byte, the bfloat16 embedding's 0.34 G at a
    # second byte, the float32 scales, router and bias
    assert 16.3e9 < served_bytes < 16.4e9


def test_latent_cache_is_the_latent_and_the_shared_rope_key():
    cache = T.cache_shape(CONFIG, 32, 512)
    entry = cache["blocks"]["05_mla_moe"]
    assert {n: tuple(t.shape) for n, t in entry.items()} == {"c_kv": (1, 32, 512, 512), "k_pe": (1, 32, 512, 64)}
    per_token_layer = sum(t[0, 0, 0].numel() * t.element_size() for t in entry.values())
    assert per_token_layer == 1152  # against 10,240 B of per-head bf16 K/V


def test_latent_attention_refuses_rules_and_quant_kv(params):
    with pytest.raises(NotImplementedError):
        T.check_supported(SMALL, sharding.MeshRules(mesh=None))
    with pytest.raises(NotImplementedError):
        T.init_cache(SMALL, 2, 16, RunFlags(quant_kv=True), device="cpu")
    with pytest.raises(NotImplementedError):
        T.prefill(params, SMALL, {"tokens": tokens()}, RunFlags(quant_kv=True))


def test_more_than_one_routing_group_raises(params):
    cfg = dataclasses.replace(SMALL, n_group=2, topk_group=1)
    with pytest.raises(NotImplementedError):
        moe.route_sigmoid(torch.zeros(3, 8), torch.zeros(8), cfg)


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_prefill_logits_equal_the_reference(params, route):
    bits = ROUTES[route]
    t = tokens()
    _, got = T.prefill(served(params, bits), SMALL, {"tokens": t}, max_len=16)
    want = ref.forward(SMALL, params, t, bits)[:, -1]
    assert rel_err(got, want) < TOL


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_decode_through_the_latent_cache_equals_the_full_forward(params, route):
    bits = ROUTES[route]
    p = served(params, bits)
    t = tokens(s=12, seed=1)
    want = ref.forward(SMALL, params, t, bits)
    cache, got = T.prefill(p, SMALL, {"tokens": t[:, :9]}, max_len=16)
    assert rel_err(got, want[:, 8]) < TOL
    for i in range(9, 12):
        cache, got = T.decode_step(p, SMALL, cache, t[:, i:i + 1])
        assert rel_err(got, want[:, i]) < TOL, i
    assert int(cache["pos"]) == 12


def test_routing_chooses_by_score_plus_bias_and_weighs_by_score(params):
    router = {k: v[0] for k, v in params["blocks"]["01_mla_moe"]["ffn"]["router"].items()}
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((40, SMALL.d_model)).astype(np.float32))
    weights, experts = moe.route_sigmoid(x @ router["w"], router["bias"], SMALL)
    want_w, want_e = ref.route(SMALL, router, x)
    assert torch.equal(experts, want_e)
    torch.testing.assert_close(weights, want_w, rtol=1e-6, atol=0)  # the same float32 ops
    torch.testing.assert_close(weights.sum(-1), torch.full((40,), SMALL.routed_scaling_factor), rtol=1e-6, atol=0)
    # the bias moves choices (it is drawn at std 0.05 against scores of ~0.2)
    _, unbiased = moe.route_sigmoid(x @ router["w"], torch.zeros_like(router["bias"]), SMALL)
    assert not torch.equal(unbiased, experts)
    big = router["bias"].clone()
    big[5] = 10.0  # an expert the bias forces on every token, weighed by its score alone
    w5, e5 = moe.route_sigmoid(x @ router["w"], big, SMALL)
    assert bool((e5 == 5).any(-1).all())
    w_ref, e_ref = ref.route(SMALL, {"w": router["w"], "bias": big}, x)
    assert torch.equal(e5, e_ref) and torch.allclose(w5, w_ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_a_tokens_output_does_not_depend_on_the_rest_of_the_batch(params, route):
    p = served(params, ROUTES[route])["blocks"]["01_mla_moe"]["ffn"]
    p = T._group({"f": p}, 0)["f"]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 6, SMALL.d_model)).astype(np.float32))
    alone, _ = moe.dropless_moe_ffn(p, x, SMALL)
    # 60 more tokens, many of them on the first token's experts: a capacity
    # dispatch would drop some of its pairs
    crowd = torch.cat([x, x[:, :1].expand(1, 60, -1) + 0.01 * torch.randn(1, 60, SMALL.d_model)], dim=1)
    together, _ = moe.dropless_moe_ffn(p, crowd, SMALL)
    assert torch.equal(together[:, :6], alone)


def test_moe_layer_counts_routed_rows_and_records_its_spans(params):
    p = T._group({"f": common.maybe_quantize_tree(params, SMALL)["blocks"]["01_mla_moe"]["ffn"]}, 0)["f"]
    x = torch.randn(2, 5, SMALL.d_model)
    before = obs.counts("moe.").get("moe.routed_rows", 0)
    obs.enable()
    try:
        moe.dropless_moe_ffn(p, x, SMALL)
        names = {s.name for s in obs.record().spans}
    finally:
        obs.disable()
    assert obs.counts("moe.")["moe.routed_rows"] - before == 2 * 5 * SMALL.experts_per_token
    assert {"model.moe.route", "model.moe.experts", "model.moe.combine"} <= names


def test_prefill_notes_one_grouped_call_a_projection_of_each_expert_layer(params):
    p = common.maybe_quantize_tree(params, SMALL)
    api.reset_kernel_work()
    with api.kernels_as_units():
        T.prefill(p, SMALL, {"tokens": tokens()}, max_len=16)
    work = api.kernel_work()
    api.reset_kernel_work()
    moe_layers = SMALL.layer_kinds().count("mla_moe")
    assert work["grouped_matmul"]["calls"] == 2 * moe_layers
    # K4: wq, wkv_a, wkv_b, wo and three FFN linears a layer (dense or shared), the head
    assert work["bitslice_matmul"]["calls"] == 7 * SMALL.n_layers + 1
    assert work["act_quant"]["calls"] == work["bitslice_matmul"]["calls"] + work["grouped_matmul"]["calls"]


def test_the_int4_control_falls_outside_the_tolerance(params):
    t = tokens(seed=2)
    want = ref.forward(SMALL, params, t, 8)[:, -1]
    _, got = T.prefill(served(params, 8), SMALL, {"tokens": t}, max_len=16)
    control = ref.forward(SMALL, params, t, 4)[:, -1]
    assert rel_err(got, want) < TOL < rel_err(control, want)


def test_bfloat16_serving_stays_near_the_reference():
    cfg = dataclasses.replace(SMALL, dtype="bfloat16")
    p = T.init_params(cfg, 3, device="cpu")
    t = tokens(seed=3)
    _, got = T.prefill(common.maybe_quantize_tree(p, cfg), cfg, {"tokens": t}, max_len=16)
    want = ref.forward(cfg, p, t, 8)[:, -1]
    control = ref.forward(cfg, p, t, 4)[:, -1]
    # bfloat16 activations (2**-8 relative) move an int8 activation by a
    # step now and then, and a near tie of the routing may flip
    assert rel_err(got.to(torch.float32), want) < 0.5 * rel_err(control, want)


# ---------------------------------------------------------------------------
# the grouped product's plain version and its checks
# ---------------------------------------------------------------------------

GROUPS = {
    "ragged": [5, 0, 17, 1, 0, 33, 2, 8],
    "empty-ends": [0, 0, 9, 40, 0, 0],
    "one-expert": [0, 0, 0, 64],
    "no-rows": [0, 0, 0],
}


def grouped_operands(counts, k=32, n=20, seed=0):
    rng = np.random.default_rng(seed)
    r = sum(counts)
    x = torch.from_numpy(rng.integers(-128, 128, (r, k)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (len(counts), k, n)).astype(np.int8))
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int32)
    return x, w, offsets


@pytest.mark.parametrize("case", sorted(GROUPS))
def test_grouped_plain_equals_per_expert_int_matmul(case):
    counts = GROUPS[case]
    x, w, offsets = grouped_operands(counts)
    got = api.grouped_matmul(x, w, offsets)
    assert got.dtype == torch.int32 and tuple(got.shape) == (sum(counts), 20)
    lo = 0
    for e, c in enumerate(counts):
        assert torch.equal(got[lo:lo + c], common.int_matmul(x[lo:lo + c], w[e])), e
        lo += c


def test_grouped_meta_route_and_refusals():
    x, w, offsets = grouped_operands([3, 4])
    out = api.grouped_matmul(x.to("meta"), w.to("meta"), offsets.to("meta"))
    assert out.device.type == "meta" and tuple(out.shape) == (7, 20) and out.dtype == torch.int32
    with pytest.raises(ValueError):  # K % 16
        api.grouped_matmul(x[:, :24], w[:, :24], offsets)
    with pytest.raises(ValueError):  # N % 4
        api.grouped_matmul(x, w[..., :18], offsets)
    with pytest.raises(ValueError):  # offsets of another length
        api.grouped_matmul(x, w, offsets[:2])
    with pytest.raises(TypeError):
        api.grouped_matmul(x.to(torch.int32), w, offsets)
    assert bm.grouped_work(7, 32, 20, 2) == (2 * 7 * 32 * 20, 7 * 32 + 2 * 32 * 20 + 4 * 7 * 20)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    return torch.device("cuda", 0)


def routed_counts(rows_per_expert, experts, seed):
    """Expert row counts as the cell's routing gives them: about
    ``rows_per_expert`` each, uneven."""
    rng = np.random.default_rng(seed)
    return list(rng.multinomial(rows_per_expert * experts, rng.dirichlet(np.full(experts, 20.0))))


CARD_GROUPS = {
    "moonlight-gate-up": (routed_counts(1500, 64, 1), 2048, 2816),
    "moonlight-down": (routed_counts(1500, 64, 2), 1408, 2048),
    "moonlight-decode": (routed_counts(3, 64, 3), 2048, 2816),
    "ragged-empty": ([5, 0, 300, 1, 0, 129, 128, 0], 64, 36),
    "narrow-N": ([100, 0, 27, 256], 48, 32),
    "no-rows": ([0, 0, 0, 0], 32, 16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_GROUPS))
def test_grouped_kernel_equals_its_plain_version(card, case):
    counts, k, n = CARD_GROUPS[case]
    x, w, offsets = grouped_operands(counts, k, n, seed=7)
    api.reset_launch_counts()
    got = api.grouped_matmul(x.to(card), w.to(card), offsets.to(card))
    torch.cuda.synchronize()
    assert api.launch_counts() == ({"grouped_matmul": 1} if sum(counts) else {})
    assert torch.equal(got.cpu(), bm._grouped_plain(x, w, offsets))


@pytest.mark.cuda
def test_an_expert_layer_never_synchronises_with_the_host(card):
    cfg = dataclasses.replace(CONFIG, dtype="bfloat16")
    gen = torch.Generator(device=card).manual_seed(0)
    p = moe.dropless_moe_init(gen, cfg, torch.bfloat16, device=card)
    p = common.maybe_quantize_tree({"ffn": p}, cfg)["ffn"]
    x = torch.randn(4, 128, cfg.d_model, generator=gen, device=card).to(torch.bfloat16)
    moe.dropless_moe_ffn(p, x, cfg)  # builds the kernels, outside the check
    torch.cuda.synchronize()
    api.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, _ = moe.dropless_moe_ffn(p, x, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    # two grouped products, three shared-expert linears, one quantize each
    assert api.launch_counts() == {"grouped_matmul": 2, "bitslice_matmul": 3, "act_quant": 5}
