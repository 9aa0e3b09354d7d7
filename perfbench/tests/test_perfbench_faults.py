"""``correct`` comes out false when the timed path is broken underneath,
and when the control stands in for the program.

Each test skips the harness's look for a card and drives the rest of a run
on the CPU at a small size (``harness.run_cell``), with one fault planted
in the program where the answer is produced: an answer altered, or half
of the batch left out (its rows answered with the other half's).  The
faults of training cells (a state left unchanged) and of several chips
(an exchange left out) cannot occur in these one-chip inference cells.
"""
import sys
import time

import pytest
import torch

import pbsetup
from perfbench.bench import harness, spec
from perfbench.bench.trace import Spans

RESNET = ("resnet18.b32", pbsetup.tiny_resnet, pbsetup.tiny_images)
LLM = ("minicpm-2b.prefill-512", pbsetup.tiny_transformer, pbsetup.tiny_prompts)


def run(cell, make_cfg, make_traffic, limits=None):
    return harness.run_cell(cell, 2**31 + 11, 0.3, False, torch.device("cpu"), t0=time.perf_counter(),
                            config=make_cfg(), traffic=make_traffic(),
                            limits=limits or spec.limits_of(cell), log=lambda m: None)


def alter_answer(out):
    out = out.clone()
    out[0, 0] += 1
    return out


def half_batch(out):
    out = out.clone()
    h = out.shape[0] // 2
    out[h:2 * h] = out[:h]
    return out


@pytest.fixture
def resnet_head(monkeypatch):
    """Break the GEMM that produces the logits (the head: N = classes)."""
    from repro_torch.kernels import conv

    plain = conv._gemm

    def plant(fault):
        def gemm(x, w, b_layout="kn"):
            out = plain(x, w, b_layout)
            return fault(out) if b_layout == "kn" and out.shape[1] == 10 else out
        monkeypatch.setattr(conv, "_gemm", gemm)
    return plant


@pytest.fixture
def llm_head(monkeypatch):
    """Break the logits the prefill step takes its first token from."""
    from repro_torch.models import transformer

    plain = transformer._lm_head

    def plant(fault):
        def head(params, x, cfg, ms=None):
            logits = plain(params, x, cfg, ms)
            return fault(logits[:, 0])[:, None] if logits.dim() == 3 else fault(logits)
        monkeypatch.setattr(transformer, "_lm_head", head)
    return plant


def test_sound_runs_are_correct():
    assert run(*RESNET)["correct"]
    assert run(*LLM)["correct"]


@pytest.mark.parametrize("fault", [alter_answer, half_batch], ids=["altered", "half-batch"])
def test_resnet_fault_is_caught(resnet_head, fault):
    resnet_head(fault)
    r = run(*RESNET)
    assert not r["correct"] and r["checks"]["logits_mismatched"]["value"] > 0


def promote_other_token(logits):
    """Row 0 answers with a token far below its best (the fault
    ``perfbench/calibrate.py --fault altered-token`` reads on the card)."""
    sys.path.insert(0, str(pbsetup.ROOT / "perfbench"))
    try:
        import calibrate
    finally:
        sys.path.remove(str(pbsetup.ROOT / "perfbench"))
    return calibrate.promote_other_token(logits)


@pytest.mark.parametrize("fault", [promote_other_token, half_batch], ids=["altered", "half-batch"])
def test_llm_fault_is_caught(llm_head, fault):
    llm_head(fault)
    assert not run(*LLM)["correct"]


@pytest.mark.parametrize("cell,make_cfg,make_traffic", [RESNET, LLM], ids=["resnet", "llm"])
def test_the_control_is_not_correct(cell, make_cfg, make_traffic):
    """The reference one precision down (float32 sums; int4 weights) put in
    the program's place fails the cell's own limit (the ResNet at its full
    widths, batch 1, where the sums pass 2**24)."""
    cfg = make_cfg() if cell != "resnet18.b32" else spec.load_json(spec.PKG / "configs" / "resnet18-cifar-int8.json")
    traffic = make_traffic(batch=1, pool_batches=2, check_batches=2) if cell == "resnet18.b32" else make_traffic()
    system = spec.system(cfg["system"]).System(cfg, traffic, 9, torch.device("cpu"), Spans(False))
    system.setup()
    for i in range(traffic["check_batches"] + 1):
        system.observe(i, system.call(i))
    system.release()
    limits = spec.limits_of(cell)
    assert all(c["value"] <= c["limit"] for c in system.check(limits))
    assert any(c["value"] > c["limit"] for c in system.check(limits, control=True))
