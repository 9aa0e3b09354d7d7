"""The plain references agree with the port at small sizes on the CPU, and
their controls (the next precision down) do not.  The references import
nothing of the program; these tests import both."""
import numpy as np
import pytest
import torch

import pbsetup
from perfbench.bench import spec, traffic as tr
from perfbench.reference import resnet_int, transformer_int8 as ref
from perfbench.systems import resnet as rsys, transformer as tsys


RESNETS = {
    "tiny": (pbsetup.tiny_resnet(), 3),
    "tiny-avgpool": (pbsetup.tiny_resnet(stem_pool="avg"), 2),
    "resnet18-b1": (spec.load_json(spec.PKG / "configs" / "resnet18-cifar-int8.json"), 1),
}


@pytest.mark.parametrize("case", sorted(RESNETS))
def test_integer_resnet_reference_equals_the_port(case):
    from repro_torch.models import resnet

    cfg, b = RESNETS[case]
    dev = torch.device("cpu")
    w = rsys.make_weights(cfg, 11, dev)
    x = tr.image_pool(pbsetup.tiny_images(batch=b, pool_batches=1), cfg, 11, pin=False)[0]
    got = resnet.forward(rsys.port_config(cfg), w, x)
    want = resnet_int.forward(cfg, w, x)
    assert torch.equal(got, want)
    if case == "resnet18-b1":
        assert int(got.abs().max()) > 2**28  # the wrap is exercised
        control = resnet_int.forward(cfg, w, x, acc=torch.float32)
        assert int((control != want).sum()) >= want.numel() - 1  # float32 sums lose nearly every logit


def port_prefill_logits(cfg, weights, tokens):
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(tsys.model_config(cfg), tsys.port_tree(weights, cfg), max_len=tokens.shape[1])
    with torch.no_grad():
        _, logits = eng._prefill(eng.params, {"tokens": tokens.to(torch.int32)})
    return logits.to(torch.float32)


@pytest.mark.parametrize("kv_heads,tied", [(2, True), (4, False)])
def test_transformer_reference_follows_the_port(kv_heads, tied):
    cfg = pbsetup.tiny_transformer(num_key_value_heads=kv_heads, tie_word_embeddings=tied)
    dev = torch.device("cpu")
    w = tsys.make_weights(cfg, 5, dev)
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, cfg["vocab_size"], (6, 20)))
    tokens[:3, :7] = 0  # left padding, as the engine pads
    got = port_prefill_logits(cfg, w, tokens)
    want = ref.last_logits(cfg, ref.quantize_weights(w, 8), tokens, 8)
    assert got.shape[1] == 2048 and want.shape[1] == cfg["vocab_size"]
    if tied:
        assert torch.all(got[:, cfg["vocab_size"]:] == 0)  # the zero padding rows
    # the port's activations are bfloat16 (2**-8 relative) and a rounding
    # there can move an int8 activation by one step (1/127 of its row's max)
    scale = float(want.abs().max())
    assert float((got[:, :cfg["vocab_size"]] - want).abs().max()) < 0.05 * scale
    program = tsys.gap(want, got.argmax(-1))
    control = tsys.gap(want, ref.last_logits(cfg, ref.quantize_weights(w, 4), tokens, 8).argmax(-1))
    assert program < control


def test_gap_of_a_token_outside_the_vocabulary():
    logits = torch.tensor([[0.0, 2.0, 1.0]])
    assert tsys.gap(logits, torch.tensor([1])) == 0.0
    assert tsys.gap(logits, torch.tensor([2])) == 1.0
    assert tsys.gap(logits, torch.tensor([3])) == tsys.OUT_OF_VOCAB


def test_references_import_nothing_of_the_program():
    import ast

    for path in (spec.PKG / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
        assert not [m for m in names if m.split(".")[0] in ("repro_torch", "repro", "jax", "perfbench")], path
