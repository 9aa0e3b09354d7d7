"""The port's integer ResNet through a held ``Executor`` (its CUDA-graph
route): ``api.compile(api.trace(forward).program_for(params, x))``, called
with the weights and each batch's input; the logits are copied to the host.

The harness makes the weights: uniform over the signed ``weight_bits``
range, drawn on the device from the run's seed in one call.  The check
reruns :mod:`perfbench.reference.resnet_int` on the inputs of a sample of
the window's batches, with the weights drawn again from the seed, and
counts the logits that differ (an exact comparison).
"""
from __future__ import annotations

import random
import time
from typing import Dict, List, Tuple

import torch

from perfbench.bench import traffic as tr
from perfbench.reference import resnet_int
from perfbench.work import resnet as work

def weight_shapes(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(path, shape) of every weight, in the layout ``models/resnet.forward``
    takes: ``stem``, ``s{stage}.{block}.{conv1|conv2|proj}``, ``head``."""
    out = [("stem", (cfg["stem_channels"], cfg["in_channels"], 3, 3))]
    c_in = cfg["stem_channels"]
    for si, (c_out, n) in enumerate(zip(cfg["stage_channels"], cfg["blocks_per_stage"])):
        for bi in range(n):
            stride = 2 if si > 0 and bi == 0 else 1
            out += [(f"s{si}.{bi}.conv1", (c_out, c_in, 3, 3)), (f"s{si}.{bi}.conv2", (c_out, c_out, 3, 3))]
            if stride != 1 or c_in != c_out:
                out.append((f"s{si}.{bi}.proj", (c_out, c_in, 1, 1)))
            c_in = c_out
    out.append(("head", (c_in, cfg["num_classes"])))
    return out


def make_weights(cfg: dict, seed: int, device: torch.device) -> dict:
    """The weight tree, drawn on ``device`` from ``seed`` in one call."""
    shapes = weight_shapes(cfg)
    sizes = [torch.Size(s).numel() for _, s in shapes]
    gen = torch.Generator(device=device).manual_seed(tr.substreams(seed)[tr.WEIGHTS])
    lim = 2 ** (cfg["weight_bits"] - 1)
    flat = torch.randint(-lim + 1, lim, (sum(sizes),), generator=gen, dtype=torch.int32, device=device)
    leaves = {p: t.reshape(s).clone() for (p, s), t in zip(shapes, flat.split(sizes))}
    stages: List[List[Dict[str, torch.Tensor]]] = [[{} for _ in range(n)] for n in cfg["blocks_per_stage"]]
    for path, leaf in leaves.items():
        if path not in ("stem", "head"):
            si, bi, key = path[1:].split(".")
            stages[int(si)][int(bi)][key] = leaf
    return {"stem": leaves["stem"], "stages": stages, "head": leaves["head"]}


def port_config(cfg: dict):
    """The configuration as ``models/resnet.ResNetConfig``."""
    from repro_torch.models import resnet

    return resnet.ResNetConfig(
        in_channels=cfg["in_channels"], input_hw=cfg["input_hw"], stem_channels=cfg["stem_channels"],
        stem_pool=cfg["stem_pool"], stage_channels=tuple(cfg["stage_channels"]),
        blocks_per_stage=tuple(cfg["blocks_per_stage"]), num_classes=cfg["num_classes"],
        input_bits=cfg["input_bits"], weight_bits=cfg["weight_bits"])


class System:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device, spans):
        self.config, self.traffic, self.seed, self.device, self.spans = config, traffic, seed, device, spans
        self.kept: List[Tuple[int, torch.Tensor]] = []
        self._sample = random.Random(tr.substreams(seed)[tr.SAMPLE])
        self._seen = 0

    def setup(self) -> None:
        from repro_torch.kernels import api
        from repro_torch.models import resnet

        cfg = self.config
        self.rcfg = port_config(cfg)
        self.params = make_weights(cfg, self.seed, self.device)
        self.pool = tr.image_pool(self.traffic, cfg, self.seed, pin=self.device.type == "cuda")
        rcfg = self.rcfg
        traced = api.trace(lambda p, v: resnet.forward(rcfg, p, v), name="perfbench_resnet")
        self.ex = api.compile(traced.program_for(self.params, self.pool[0].to(self.device)))
        for i in range(self.traffic["warmup_batches"]):
            self.call(i)
        if self.device.type == "cuda" and self.ex.replay != "graph":
            raise RuntimeError(f"the Executor took the {self.ex.replay} route: {self.ex.replay_reason}")

    def call(self, i: int) -> torch.Tensor:
        with self.spans.span("perfbench.copy_in"):
            x = self.pool[i % len(self.pool)].to(self.device, non_blocking=True)
        with self.spans.span("perfbench.executor_call"):
            t = time.perf_counter()
            logits = self.ex(self.params, x)
            self.spans.record("executor_call_s", time.perf_counter() - t)
        with self.spans.span("perfbench.copy_out"):
            return logits.cpu()

    def requests(self, i: int) -> List[int]:
        """Units of each request of batch ``i``: an image each."""
        return [1] * self.traffic["batch"]

    def observe(self, i: int, out: torch.Tensor) -> None:
        """Keep a uniform sample (reservoir, drawn from the seed) of the
        window's batches for the check."""
        k = self.traffic["check_batches"]
        self._seen += 1
        if len(self.kept) < k:
            self.kept.append((i, out))
        else:
            j = self._sample.randrange(self._seen)
            if j < k:
                self.kept[j] = (i, out)

    def traced_batch(self, i: int) -> dict:
        return {"batch": self.traffic["batch"]}

    def counters(self) -> Dict[str, int]:
        return {}

    def release(self) -> None:
        del self.ex, self.params
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, limits: Dict[str, float], control: bool = False) -> List[dict]:
        """The kept batches' logits against the reference on their inputs;
        with ``control`` the reference in float32 stands in for the program."""
        weights = make_weights(self.config, self.seed, self.device)
        entries = sorted({i % len(self.pool) for i, _ in self.kept})
        want = {}
        got = {}
        for e in entries:
            x = self.pool[e].to(self.device)
            want[e] = resnet_int.forward(self.config, weights, x).cpu()
            if control:
                got[e] = resnet_int.forward(self.config, weights, x, acc=torch.float32).cpu()
        bad = 0
        for i, out in self.kept:
            e = i % len(self.pool)
            bad += int((want[e] != (got[e] if control else out)).sum())
        return [{"name": "logits_mismatched", "value": bad, "limit": limits["logits_mismatched"],
                 "compared": len(self.kept) * self.traffic["batch"] * self.config["num_classes"]}]

    @staticmethod
    def least_s(config: dict, batch: dict) -> Dict[str, float]:
        """Per traced batch: K1's least time and the useful work's."""
        return {"K1": work.k1_least_s(config, batch["batch"]),
                "useful": work.useful_least_s(config, batch["batch"])}
