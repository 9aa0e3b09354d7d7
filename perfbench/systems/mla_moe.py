"""The port's serving path for a DeepSeek-V3-architecture decoder (latent
attention, dropless sigmoid-routed experts beside shared ones):
``serve.engine.ServeEngine`` with the prefill step it builds and caches,
every linear on the bit-sliced GEMM and every routed expert on its grouped
path, one batch of requests a call of ``ServeEngine.run``, the first token
read back per request: :mod:`perfbench.systems.transformer`'s loop, sample
and check, on this architecture's weights and reference.

The harness makes the weights on the device from the run's seed, a layer
at a time (bfloat16, the router float32); the engine quantizes them itself.
A wrapper around the port's ``models.moe.route_sigmoid`` keeps the experts
each expert layer chose for each batch (the tensors themselves: nothing is
launched), with the sampled batches' logits.  The check draws the weights
again after the window, quantizes them in the reference's own way and runs
:mod:`perfbench.reference.mla_moe_int8` over the sampled batches, each
expert layer following the program's choices: ``served_gap_max`` and
``logit_err_max`` as the dense decoder's, and ``route_gap_max``, the most by
which an expert the program chose lies below the reference's own k-th
choice value (a near tie that the program's bfloat16 rounding flipped lies
just below it).
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from perfbench.bench import traffic as tr
from perfbench.reference import mla_moe_int8 as ref
from perfbench.systems import transformer as dense
from perfbench.work import mla_moe as work
from perfbench.work.transformer import padded_vocab


def check_supported(cfg: dict) -> None:
    if (cfg.get("attention_bias") or cfg.get("hidden_act", "silu") != "silu" or cfg.get("q_lora_rank") is not None
            or cfg["scoring_func"] != "sigmoid" or cfg["n_group"] != 1 or cfg["topk_group"] != 1
            or cfg["moe_layer_freq"] != 1 or cfg["tie_word_embeddings"] or cfg["num_nextn_predict_layers"]):
        raise NotImplementedError("this system serves DeepSeek-V3-architecture decoders without a query latent, "
                                  "with sigmoid routing in one group, an expert layer after each dense one and an "
                                  "untied head")


def make_weights(cfg: dict, seed: int, device: torch.device) -> dict:
    """The reference's tree, drawn on ``device`` from ``seed``: bfloat16
    linears normal of std 1/sqrt(fan-in), a float32 router of std
    1/sqrt(hidden_size) and selection bias of std 0.05, an embedding and a
    head of std 0.02 (their rows past ``vocab_size`` up to the port's padded
    vocabulary zero; Moonlight's needs none), norm scales of 1 + 0.1 ·
    normal."""
    d, h, r = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rp, v = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    e, f = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    fs = cfg["n_shared_experts"] * f
    gen = torch.Generator(device=device).manual_seed(tr.substreams(seed)[tr.WEIGHTS])

    def normal(shape, std, mean=0.0, dtype=torch.bfloat16):
        t = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        return t.mul_(std).add_(mean)

    def linear(k, n, lead=()):
        return normal((*lead, k, n), 1 / math.sqrt(k))

    layers = []
    for i in range(cfg["num_hidden_layers"]):
        lw = {"ln1": normal((d,), 0.1, 1.0), "wq": linear(d, h * (nope + rp)), "wkv_a": linear(d, r + rp),
              "kv_norm": normal((r,), 0.1, 1.0), "wkv_b": linear(r, h * (nope + v)), "wo": linear(h * v, d),
              "ln2": normal((d,), 0.1, 1.0)}
        if i < cfg["first_k_dense_replace"]:
            lw.update(w_gate=linear(d, cfg["intermediate_size"]), w_up=linear(d, cfg["intermediate_size"]),
                      w_down=linear(cfg["intermediate_size"], d))
        else:
            lw.update(router=normal((d, e), 1 / math.sqrt(d), dtype=torch.float32),
                      router_bias=normal((e,), 0.05, dtype=torch.float32),
                      experts_gate_up=linear(d, 2 * f, (e,)), experts_down=linear(f, d, (e,)),
                      shared_gate=linear(d, fs), shared_up=linear(d, fs), shared_down=linear(fs, d))
        layers.append(lw)
    vp = padded_vocab(cfg)
    embed, head = normal((vp, d), 0.02), normal((d, vp), 0.02)
    embed[cfg["vocab_size"]:] = 0
    head[:, cfg["vocab_size"]:] = 0
    return {"embed": embed, "layers": layers, "final_norm": normal((d,), 0.1, 1.0), "lm_head": head}


def port_tree(w: dict, cfg: dict) -> dict:
    """The same tensors in the tree ``models/transformer`` takes: one pattern
    group, layer i its block ``{i:02d}_{kind}``, each leaf behind a group
    axis of 1 (a view)."""
    kinds = model_config(cfg).block_pattern

    def lin(t):
        return {"w": t[None]}

    blocks = {}
    for i, (kind, lw) in enumerate(zip(kinds, w["layers"])):
        b = {"ln1": {"scale": lw["ln1"][None]}, "ln2": {"scale": lw["ln2"][None]},
             "attn": {"wq": lin(lw["wq"]), "wkv_a": lin(lw["wkv_a"]), "kv_norm": {"scale": lw["kv_norm"][None]},
                      "wkv_b": lin(lw["wkv_b"]), "wo": lin(lw["wo"])}}
        if kind == "mla":
            b["ffn"] = {n: lin(lw[n]) for n in ("w_gate", "w_up", "w_down")}
        else:
            b["ffn"] = {"router": {"w": lw["router"][None], "bias": lw["router_bias"][None]},
                        "experts": {"gate_up": lin(lw["experts_gate_up"]), "down": lin(lw["experts_down"])},
                        "shared": {"w_gate": lin(lw["shared_gate"]), "w_up": lin(lw["shared_up"]),
                                   "w_down": lin(lw["shared_down"])}}
        blocks[f"{i:02d}_{kind}"] = b
    return {"embed": {"w": w["embed"]}, "blocks": blocks, "final_norm": {"scale": w["final_norm"]},
            "lm_head": {"w": w["lm_head"]}}


def model_config(cfg: dict):
    from repro_torch.configs.base import MLAMoEConfig, QuantConfig, mla_moe_pattern

    q = cfg["quant"]
    return MLAMoEConfig(
        name=cfg["name"], family="moe", n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"], n_kv_heads=cfg["num_key_value_heads"], d_ff=cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"], head_dim=cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"],
        block_pattern=mla_moe_pattern(cfg["num_hidden_layers"], cfg["first_k_dense_replace"]),
        n_experts=cfg["n_routed_experts"], experts_per_token=cfg["num_experts_per_tok"],
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"], tie_embeddings=False,
        dtype=cfg["torch_dtype"],
        quant=QuantConfig(enabled=True, act_bits=q["act_bits"], weight_bits=q["weight_bits"],
                          slice_bits=q["slice_bits"]),
        kv_lora_rank=cfg["kv_lora_rank"], qk_nope_head_dim=cfg["qk_nope_head_dim"],
        qk_rope_head_dim=cfg["qk_rope_head_dim"], v_head_dim=cfg["v_head_dim"],
        moe_d_ff=cfg["moe_intermediate_size"], n_shared_experts=cfg["n_shared_experts"],
        routed_scaling_factor=cfg["routed_scaling_factor"], norm_topk_prob=cfg["norm_topk_prob"],
        scoring_func=cfg["scoring_func"], n_group=cfg["n_group"], topk_group=cfg["topk_group"])


class System(dense.System):
    """The dense decoder's serving loop on this architecture."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device, spans):
        check_supported(config)
        super().__init__(config, traffic, seed, device, spans)
        self.routes: Dict[int, List[torch.Tensor]] = {}  # the sampled batches' experts, a layer each
        self._routes: List[torch.Tensor] = []
        self._plain_route = None

    def _wrap_route(self) -> None:
        """Keep each expert layer's chosen experts (T, k) of the batch in
        flight (``models.moe.route_sigmoid``'s output, not a copy)."""
        from repro_torch.models import moe

        plain = self._plain_route = moe.route_sigmoid

        def route(logits, bias, cfg):
            weights, experts = plain(logits, bias, cfg)
            self._routes.append(experts)
            return weights, experts

        moe.route_sigmoid = route

    def setup(self) -> None:
        from repro_torch.serve.engine import ServeEngine

        cfg, traffic = self.config, self.traffic
        self._wrap_route()
        self.pool = tr.prompt_pool(traffic, cfg["vocab_size"], self.seed)
        self.engine = ServeEngine(model_config(cfg), port_tree(make_weights(cfg, self.seed, self.device), cfg),
                                  max_len=traffic["cache_len"])
        self._wrap_prefill()
        if self.spans.tracing:
            self._wrap_prompt_batch()
        with torch.no_grad():
            self._serve(tr.warmup_prompts(traffic, cfg["vocab_size"], self.seed))
            self.call(0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.slots = [0, 0]

    def call(self, i: int):
        self._routes = []
        return super().call(i)

    def observe(self, i: int, out) -> None:
        """The dense decoder's sample, and the chosen experts of the batches
        it keeps."""
        super().observe(i, out)
        self.routes[i] = self._routes
        kept = {j for j, _ in self.kept} | {self.longest[0]}
        for j in [j for j in self.routes if j not in kept]:
            del self.routes[j]

    def release(self) -> None:
        from repro_torch.models import moe

        if self._plain_route is not None:
            moe.route_sigmoid = self._plain_route
        super().release()

    def reference_weights(self, bits: int) -> dict:
        """The weights drawn again and quantized at ``bits`` by the reference."""
        return ref.quantize_weights(make_weights(self.config, self.seed, self.device), bits)

    def check(self, limits: Dict[str, float], control: bool = False) -> List[dict]:
        """Over the sampled requests, against the reference at the
        configuration's weight bits following the program's experts:
        ``served_gap_max`` and ``logit_err_max`` as the dense decoder's, and
        ``route_gap_max``.  With ``control`` the reference with int4 weights
        stands in for the program (its logits, its best token served, its
        own experts followed)."""
        q, cfg = self.config["quant"], self.config
        want = self.reference_weights(q["weight_bits"])
        low = self.reference_weights(q["weight_bits"] // 2) if control else None
        vocab = cfg["vocab_size"]
        worst_gap, worst_err, worst_route, compared = 0.0, 0.0, 0.0, 0
        for i, logits in self.checked():
            tokens = torch.from_numpy(self._padded(i)).to(self.device)
            b, s = tokens.shape
            for lo in range(0, b, self.traffic["check_rows"]):
                rows = slice(lo, lo + self.traffic["check_rows"])
                if control:
                    got, routes, _ = ref.last_logits(cfg, low, tokens[rows], q["act_bits"])
                    served = got.argmax(-1)
                else:
                    routes = [r.view(b, s, -1)[rows].reshape(-1, r.shape[-1]) for r in self.routes[i]]
                    got = logits[rows, :vocab].to(torch.float32)
                    served = torch.from_numpy(self.served[i][rows]).to(self.device)
                best, _, route_gap = ref.last_logits(cfg, want, tokens[rows], q["act_bits"], routes)
                worst_gap = max(worst_gap, dense.gap(best, served))
                err = torch.linalg.vector_norm(got - best, dim=-1) / torch.linalg.vector_norm(best, dim=-1)
                worst_err = max(worst_err, float(err.max()))
                worst_route = max(worst_route, route_gap)
                compared += len(served)
        return [{"name": n, "value": v, "limit": limits[n], "compared": compared}
                for n, v in (("served_gap_max", worst_gap), ("logit_err_max", worst_err),
                             ("route_gap_max", worst_route))]

    @staticmethod
    def least_s(config: dict, batch: dict) -> Dict[str, float]:
        """Per traced batch: K4's and K4G's least times and the useful work's."""
        b, s = batch["batch"], batch["padded_len"]
        return {"K4": work.k4_least_s(config, b, s), "K4G": work.k4g_least_s(config, b, s),
                "useful": work.useful_least_s(config, batch["lengths"])}
