"""The port's serving path for a dense decoder: ``serve.engine.ServeEngine``
(its prefill step as the engine builds and caches it, on the engine's own
``prompt_batch``, every linear on the bit-sliced GEMM), one batch of
requests a call of ``ServeEngine.run``, the first token read back per
request.

The harness makes the bfloat16 weights on the device from the run's seed,
one draw a kind of leaf over all layers; the engine quantizes them itself.
It keeps the served tokens of every batch and, for a sample of the window's
batches (a reservoir drawn from the seed, and the batch with the longest
prompt), the last-position logits the engine's prefill step returned (a
wrapper around the engine's step records them; ``run`` discards them).
The check draws the weights again after the window, quantizes them in the
reference's own way and runs :mod:`perfbench.reference.transformer_int8`
over the sampled batches.  Two numbers: how far the served token's
reference logit lies below the reference's best, and the relative L2 gap
between the program's logit vector and the reference's, each the widest
over the sampled requests.
"""
from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from perfbench.bench import traffic as tr
from perfbench.reference import transformer_int8 as ref
from perfbench.work import transformer as work

def check_supported(cfg: dict) -> None:
    if cfg.get("attention_bias") or cfg.get("hidden_act", "silu") != "silu":
        raise NotImplementedError("this driver serves dense SwiGLU decoders without attention biases")


def make_weights(cfg: dict, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """bfloat16 weights in the reference's layout, drawn on ``device`` from
    ``seed``: normal linears of std 1/sqrt(fan-in), an embedding (and an
    untied head) of std 0.02 whose padding past ``vocab_size`` is zero, norm
    scales of 1 + 0.1 · normal."""
    d, f, n = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    hd = work.head_dim(cfg)
    q, kv = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    vp = work.padded_vocab(cfg)
    gen = torch.Generator(device=device).manual_seed(tr.substreams(seed)[tr.WEIGHTS])

    def normal(shape, std, mean=0.0):
        t = torch.randn(shape, generator=gen, dtype=torch.bfloat16, device=device)
        return t.mul_(std).add_(mean)

    w = {"embed": normal((vp, d), 0.02)}
    w["embed"][cfg["vocab_size"]:] = 0
    shapes = {"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wo": (q, d),
              "w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    for name, (k_in, k_out) in shapes.items():
        w[name] = normal((n, k_in, k_out), 1 / math.sqrt(k_in))
    w["ln1"], w["ln2"] = normal((n, d), 0.1, 1.0), normal((n, d), 0.1, 1.0)
    w["final_norm"] = normal((d,), 0.1, 1.0)
    if not cfg["tie_word_embeddings"]:
        w["lm_head"] = normal((d, vp), 0.02)
        w["lm_head"][:, cfg["vocab_size"]:] = 0
    return w


def port_tree(w: Dict[str, torch.Tensor], cfg: dict) -> dict:
    """The same tensors in the tree ``models/transformer`` takes (one
    pattern group a layer)."""
    tree = {
        "embed": {"w": w["embed"]},
        "blocks": {"00_attn": {
            "ln1": {"scale": w["ln1"]},
            "attn": {k: {"w": w[k]} for k in ("wq", "wk", "wv", "wo")},
            "ln2": {"scale": w["ln2"]},
            "ffn": {k: {"w": w[k]} for k in ("w_gate", "w_up", "w_down")},
        }},
        "final_norm": {"scale": w["final_norm"]},
    }
    if not cfg["tie_word_embeddings"]:
        tree["lm_head"] = {"w": w["lm_head"]}
    return tree


def model_config(cfg: dict):
    from repro_torch.configs.base import ModelConfig, QuantConfig

    q = cfg["quant"]
    return ModelConfig(
        name=cfg["name"], family="dense", n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"], n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"], head_dim=work.head_dim(cfg),
        qkv_bias=False, block_pattern=("attn",), rope_theta=cfg["rope_theta"], norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"], dtype=cfg["torch_dtype"],
        quant=QuantConfig(enabled=True, act_bits=q["act_bits"], weight_bits=q["weight_bits"],
                          slice_bits=q["slice_bits"]))


class System:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device, spans):
        check_supported(config)
        if traffic["new_tokens"] != 1:
            raise NotImplementedError("time to first token is read at ServeEngine.run's return: one new token")
        self.config, self.traffic, self.seed, self.device, self.spans = config, traffic, seed, device, spans
        self.served: Dict[int, np.ndarray] = {}
        self.slots = [0, 0]  # padding slots, all prompt slots (trace mode)
        self.kept: List[Tuple[int, torch.Tensor]] = []    # reservoir of (batch, logits)
        self.longest: Optional[Tuple[int, torch.Tensor]] = None
        self._logits: Optional[torch.Tensor] = None
        self._sample = random.Random(tr.substreams(seed)[tr.SAMPLE])
        self._seen = 0

    def setup(self) -> None:
        from repro_torch.serve.engine import ServeEngine

        cfg, traffic = self.config, self.traffic
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

    def _wrap_prefill(self) -> None:
        """Hold on to the logits of the engine's prefill step, which its
        ``run`` reads the first tokens from and then drops."""
        step = self.engine._prefill

        def prefill(params, batch):
            cache, logits = step(params, batch)
            self._logits = logits
            return cache, logits

        self.engine._prefill = prefill

    def _wrap_prompt_batch(self) -> None:
        """Count the padding slots of each prefill batch the engine builds."""
        built = self.engine.prompt_batch

        def prompt_batch(requests):
            batch = built(requests)
            b, s = batch["tokens"].shape
            self.slots[0] += b * s - sum(len(r.prompt) for r in requests)
            self.slots[1] += b * s
            return batch

        self.engine.prompt_batch = prompt_batch

    def prompts(self, i: int) -> List[np.ndarray]:
        b, n = self.traffic["batch"], len(self.pool)
        return [self.pool[(i * b + j) % n] for j in range(b)]

    def padded_len(self, i: int) -> int:
        """The length the engine pads batch ``i`` to (its longest, at least 8)."""
        return max(max(len(p) for p in self.prompts(i)), 8)

    def _serve(self, prompts: List[np.ndarray]) -> np.ndarray:
        from repro_torch.serve.engine import Request

        reqs = [Request(rid=j, prompt=p, max_new_tokens=1) for j, p in enumerate(prompts)]
        with self.spans.span("perfbench.engine_run"):
            self.engine.run(reqs)
        return np.array([r.generated[0] for r in reqs], dtype=np.int64)

    def call(self, i: int) -> np.ndarray:
        return self._serve(self.prompts(i))

    def requests(self, i: int) -> List[int]:
        """Units of each request of batch ``i``: its prompt tokens and the new one."""
        return [len(p) + self.traffic["new_tokens"] for p in self.prompts(i)]

    def observe(self, i: int, out: np.ndarray) -> None:
        """Keep the served tokens, and the logits of a uniform sample of the
        batches (a reservoir drawn from the seed) and of the longest one."""
        self.served[i] = out
        logits, self._logits = self._logits, None
        if self.longest is None or self.padded_len(i) > self.padded_len(self.longest[0]):
            self.longest = (i, logits)
        k = self.traffic["check_batches"] - 1
        self._seen += 1
        if len(self.kept) < k:
            self.kept.append((i, logits))
        else:
            j = self._sample.randrange(self._seen)
            if j < k:
                self.kept[j] = (i, logits)

    def traced_batch(self, i: int) -> dict:
        return {"batch": self.traffic["batch"], "padded_len": self.padded_len(i),
                "lengths": [len(p) for p in self.prompts(i)]}

    def counters(self) -> Dict[str, int]:
        return {"padding_slots": self.slots[0], "prompt_slots": self.slots[1]}

    def release(self) -> None:
        del self.engine
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def checked(self) -> List[Tuple[int, torch.Tensor]]:
        """The sampled batches and their logits, the longest among them."""
        return sorted(dict(self.kept + [self.longest]).items())

    def check(self, limits: Dict[str, float], control: bool = False) -> List[dict]:
        """``served_gap_max``: the widest gap, over the sampled requests, by
        which the served token's reference logit lies below the reference's
        best.  ``logit_err_max``: the widest relative L2 gap between the
        program's last-position logits and the reference's.  With
        ``control`` the reference with int4 weights stands in for the
        program (its logits, and its best token served)."""
        cfg = self.config
        q = cfg["quant"]
        raw = make_weights(cfg, self.seed, self.device)
        want = ref.quantize_weights(raw, q["weight_bits"])
        low = ref.quantize_weights(raw, q["weight_bits"] // 2) if control else None
        del raw
        vocab = cfg["vocab_size"]
        worst_gap, worst_err, compared = 0.0, 0.0, 0
        for i, logits in self.checked():
            tokens = torch.from_numpy(self._padded(i)).to(self.device)
            for lo in range(0, len(tokens), self.traffic["check_rows"]):
                rows = slice(lo, lo + self.traffic["check_rows"])
                best = ref.last_logits(cfg, want, tokens[rows], q["act_bits"])
                if control:
                    got = ref.last_logits(cfg, low, tokens[rows], q["act_bits"])
                    served = got.argmax(-1)
                else:
                    got = logits[rows, :vocab].to(torch.float32)
                    served = torch.from_numpy(self.served[i][rows]).to(self.device)
                worst_gap = max(worst_gap, gap(best, served))
                err = torch.linalg.vector_norm(got - best, dim=-1) / torch.linalg.vector_norm(best, dim=-1)
                worst_err = max(worst_err, float(err.max()))
                compared += len(served)
        return [{"name": "served_gap_max", "value": worst_gap, "limit": limits["served_gap_max"],
                 "compared": compared},
                {"name": "logit_err_max", "value": worst_err, "limit": limits["logit_err_max"],
                 "compared": compared}]

    def _padded(self, i: int) -> np.ndarray:
        """Batch ``i``'s prompts left-padded with id 0 to its padded length,
        as the engine builds them."""
        s = self.padded_len(i)
        out = np.zeros((self.traffic["batch"], s), np.int64)  # pad id 0
        for j, p in enumerate(self.prompts(i)):
            out[j, s - len(p):] = p
        return out

    @staticmethod
    def least_s(config: dict, batch: dict) -> Dict[str, float]:
        """Per traced batch: K4's least time and the useful work's."""
        return {"K4": work.k4_least_s(config, batch["batch"], batch["padded_len"]),
                "useful": work.useful_least_s(config, batch["lengths"])}


OUT_OF_VOCAB = 1e9  # the gap of a served token outside the vocabulary


def gap(logits: torch.Tensor, served: torch.Tensor) -> float:
    """The widest ``max(logits[r]) - logits[r, served[r]]``; a served token
    outside the vocabulary is OUT_OF_VOCAB away."""
    vocab = logits.shape[-1]
    if bool(((served < 0) | (served >= vocab)).any()):
        return OUT_OF_VOCAB
    best = logits.max(-1).values
    return float((best - logits.gather(-1, served[:, None].to(torch.int64))[:, 0]).max())
