"""The Moonlight-16B-A3B configuration's pieces of the benchmark: its JSON is
the port's configuration at full size, its frozen reference follows the port
at a small size (and its int4 control does not), its work formulas hold to
hand counts, the grouped kernel is known by name in the trace, and its cell
runs through the harness on the CPU at a small size."""
import dataclasses
import math
import time

import numpy as np
import pytest
import torch

import pbsetup
from perfbench.bench import harness, spec
from perfbench.reference import mla_moe_int8 as ref
from perfbench.systems import mla_moe as msys
from perfbench.work import kernels, peaks, mla_moe as mw, transformer as tw

CELL = "moonlight-16b.prefill-512"
FULL = spec.load_json(spec.PKG / "configs" / "moonlight-16b-a3b-int8.json")


def tiny(**kw) -> dict:
    """Moonlight's JSON at three layers of width 64: 4 heads (nope, rope, v
    16, 8, 16), latent 32, 8 experts top-2 of width 32 and one shared, layer
    0 dense, vocabulary 256."""
    cfg = dict(FULL, hidden_size=64, num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4,
               qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, kv_lora_rank=32, intermediate_size=96,
               moe_intermediate_size=32, n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
               vocab_size=256)
    cfg.update(kw)
    return cfg


def test_the_moonlight_configuration_is_the_ports_at_full_size():
    from repro_torch.configs.moonlight_16b_a3b import CONFIG

    ours = msys.model_config(FULL)
    assert dataclasses.replace(ours, name=CONFIG.name, source=CONFIG.source) == CONFIG
    for key in ("n_layers", "d_model", "n_heads", "d_ff", "vocab_size", "resolved_head_dim", "block_pattern",
                "n_experts", "experts_per_token", "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
                "v_head_dim", "moe_d_ff", "n_shared_experts", "routed_scaling_factor", "norm_topk_prob",
                "scoring_func", "n_group", "topk_group", "rope_theta", "norm_eps", "tie_embeddings", "quant"):
        assert getattr(ours, key) == getattr(CONFIG, key), key
    # every top-level number of the source's config.json, as the catalog reads it
    assert (FULL["num_hidden_layers"], FULL["hidden_size"], FULL["n_routed_experts"], FULL["vocab_size"]) == \
        (27, 2048, 64, 163840)
    assert FULL["reduced"] == [] and FULL["system"] == "mla_moe"


def test_the_weights_fill_the_ports_tree():
    from repro_torch.models import transformer

    cfg = tiny()
    w = msys.make_weights(cfg, 1, torch.device("cpu"))
    got = {k: (tuple(v.shape), v.dtype) for k, v in _leaves(msys.port_tree(w, cfg))}
    want = {k: (tuple(v.shape), v.dtype) for k, v in _leaves(transformer.params_shape(msys.model_config(cfg)))}
    assert got == want


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in _leaves(v, f"{path}/{k}")]
    return [(path, tree)]


def port_prefill_logits(cfg, weights, tokens, routes=None):
    """The port's last-position logits; each expert layer's chosen experts
    appended to ``routes``."""
    from repro_torch.models import moe
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(msys.model_config(cfg), msys.port_tree(weights, cfg), max_len=tokens.shape[1])
    plain = moe.route_sigmoid

    def route(*args):
        weights, experts = plain(*args)
        if routes is not None:
            routes.append(experts)
        return weights, experts

    moe.route_sigmoid = route
    try:
        with torch.no_grad():
            _, logits = eng._prefill(eng.params, {"tokens": tokens.to(torch.int32)})
    finally:
        moe.route_sigmoid = plain
    assert torch.all(logits[:, cfg["vocab_size"]:] == 0)  # the zero padding of the head
    return logits[:, :cfg["vocab_size"]].to(torch.float32)


def prompts(cfg, seed=3):
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg["vocab_size"], (6, 20)))
    tokens[:3, :7] = 0  # left padding, as the engine pads
    return tokens


def as_float32(w):
    return {k: ([{n: t.float() for n, t in lw.items()} for lw in v] if k == "layers" else v.float())
            for k, v in w.items()}


@pytest.mark.parametrize("seed", [5, 6])
def test_moe_reference_equals_the_port_in_float32(seed):
    cfg = tiny(torch_dtype="float32")
    w = as_float32(msys.make_weights(cfg, seed, torch.device("cpu")))
    tokens = prompts(cfg, seed)
    routes = []
    got = port_prefill_logits(cfg, w, tokens, routes)
    want, chosen, gap = ref.last_logits(cfg, ref.quantize_weights(w, 8), tokens, 8)
    # the same float32 ops in another order (the combine's sums, the
    # attention's einsums): a few ulps of the largest logit; the same experts
    assert float((got - want).abs().max()) < 1e-5 * float(want.abs().max())
    assert gap == 0.0 and all(torch.equal(a, b) for a, b in zip(routes, chosen))
    followed, _, gap = ref.last_logits(cfg, ref.quantize_weights(w, 8), tokens, 8, routes)
    assert torch.equal(followed, want) and gap == 0.0


def test_moe_reference_follows_the_port_and_its_control_does_not():
    cfg = tiny()
    w = msys.make_weights(cfg, 5, torch.device("cpu"))
    tokens = prompts(cfg)
    q8 = ref.quantize_weights(w, 8)
    routes = []
    got = port_prefill_logits(cfg, w, tokens, routes)
    want, _, gap = ref.last_logits(cfg, q8, tokens, 8, routes)
    control, control_routes, _ = ref.last_logits(cfg, ref.quantize_weights(w, 4), tokens, 8)
    control_want, _, control_gap = ref.last_logits(cfg, q8, tokens, 8, control_routes)

    def err(x, y):
        return float((torch.linalg.vector_norm(x - y, dim=-1) / torch.linalg.vector_norm(y, dim=-1)).max())

    # bfloat16 activations move an int8 activation by a step now and then,
    # and a near tie of the routing with it; int4 weights move every value
    assert err(got, want) < 0.5 * err(control, control_want)
    assert gap < 0.5 * control_gap


def test_k4_and_k4g_hand_count():
    cfg = tiny()
    assert mw.attention_linears(cfg) == [(64, 96), (64, 40), (32, 128), (64, 64)]
    assert mw.k4_layer_linears(cfg, True)[4:] == [(64, 96), (64, 96), (96, 64)]
    assert mw.k4_layer_linears(cfg, False)[4:] == [(64, 32), (64, 32), (32, 64)]
    b, s = 2, 10
    want = sum(tw.k4_call_least_s(cfg, 20, k, n) for k, n in mw.k4_layer_linears(cfg, True))
    want += 2 * sum(tw.k4_call_least_s(cfg, 20, k, n) for k, n in mw.k4_layer_linears(cfg, False))
    want += tw.k4_call_least_s(cfg, 2, 64, 256)
    assert mw.k4_least_s(cfg, b, s) == pytest.approx(want)
    # the grouped calls: 20 slots × top-2 = 40 rows, 8 experts' weights
    assert mw.k4g_calls(cfg, 20) == [(40, 64, 64, 8), (40, 32, 64, 8)]
    one = max(2 * 40 * 64 * 64 / peaks.INT8_OPS_PER_S, (40 * 64 + 8 * 64 * 64 + 4 * 40 * 64) / peaks.HBM_BYTES_PER_S)
    two = max(2 * 40 * 32 * 64 / peaks.INT8_OPS_PER_S, (40 * 32 + 8 * 32 * 64 + 4 * 40 * 64) / peaks.HBM_BYTES_PER_S)
    assert mw.k4g_least_s(cfg, b, s) == pytest.approx(2 * (one + two))


def test_useful_work_hand_count():
    cfg = tiny()
    attn = 64 * 96 + 64 * 40 + 32 * 128 + 64 * 64
    macs = (attn + 3 * 64 * 96) + 2 * (attn + 3 * 64 * 32 + 2 * 3 * 64 * 32)
    assert mw.token_macs(cfg) == macs
    want = (2 * macs * 10 + 2 * 64 * 256) / peaks.INT8_OPS_PER_S
    want += 3 * 2 * (24 + 16) * 4 * 10 * 11 / 2 / peaks.BF16_FLOPS_PER_S
    assert mw.useful_least_s(cfg, [10]) == pytest.approx(want)
    # at full size: 2.24 G multiply-adds a token in the linears
    assert mw.token_macs(FULL) == 2_240_151_552
    assert math.isclose(mw.token_macs(FULL) / 1e9, 2.24, abs_tol=0.005)


@pytest.mark.parametrize("name,kernel", [
    ("void (anonymous namespace)::tc::bitslice_grouped_kernel<128, 128, 64>((anonymous namespace)::tc::Args, "
     "int const*, int)", "K4G"),
    ("void (anonymous namespace)::tc::bitslice_mma_kernel<1, 1, 128, 128, 64>((anonymous namespace)::tc::Args)",
     "K4"),
])
def test_the_grouped_kernel_is_known_by_name(name, kernel):
    assert kernels.kernel_of(name) == kernel


def test_the_cell_runs_on_the_cpu_at_a_small_size():
    lim = {"served_gap_max": 1.0, "logit_err_max": 1.0, "route_gap_max": 1.0}
    for trace in (False, True):
        r = harness.run_cell(CELL, 2**33 + 5, 0.2, trace, torch.device("cpu"), t0=time.perf_counter(), config=tiny(),
                             traffic=pbsetup.tiny_prompts(), limits=lim, log=lambda m: None)
        assert r["correct"], r
        if not trace:
            assert set(r["metrics"]) == {"tokens_per_s", "ttft_p95_ms", "setup_s"}

