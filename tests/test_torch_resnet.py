"""The PyTorch port's integer ResNet (``repro_torch.models.resnet``) against
the JAX package's, on CPU tensors.

Both packages draw their parameters and inputs with numpy from the same
seeds; the logits must be bit-equal.  ``TINY`` and a narrow four-stage
network (ResNet18's topology at widths 8-32) are held against the JAX
forward through the Pallas bodies (``"interpret"``); full-width ``RESNET18``
at batch 1 against the JAX oracle backend (``"xla"``), whose logits reach
the int32 range, so the port's wrap is exercised.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.kernels import api as japi  # noqa: E402
from repro.models import resnet as jres  # noqa: E402
from repro_torch.kernels import api as tapi  # noqa: E402
from repro_torch.models import resnet as tres  # noqa: E402

NARROW = dict(in_channels=3, input_hw=16, stem_channels=8, stem_pool=None,
              stage_channels=(8, 16, 16, 32), blocks_per_stage=(2, 2, 2, 2), num_classes=10)
NARROW_AVG = dict(NARROW, stem_pool="avg", input_hw=32)
CONFIGS = {
    "TINY": (tres.TINY, jres.TINY),
    "NARROW": (tres.ResNetConfig(**NARROW), jres.ResNetConfig(**NARROW)),
    "NARROW_AVG": (tres.ResNetConfig(**NARROW_AVG), jres.ResNetConfig(**NARROW_AVG)),
    "RESNET18": (tres.RESNET18, jres.RESNET18),
}


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _jax_logits(jcfg, backend, batch, seed=0):
    with japi.use_backend(backend):
        out = jres.forward(jcfg, jres.init_params(jcfg, seed), jres.make_input(jcfg, batch))
    return np.asarray(out)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_configs_match_jax(name):
    tcfg, jcfg = CONFIGS[name]
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.final_hw == jcfg.final_hw
    assert tres.layer_names(tcfg) == jres.layer_names(jcfg)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_params_and_input_equal_jax(name):
    tcfg, jcfg = CONFIGS[name]
    tp = tres.init_params(tcfg, seed=3, device="cpu")
    jp = jres.init_params(jcfg, seed=3)
    tl, jl = [t.numpy() for t in jax.tree_util.tree_leaves(tp)], _leaves(jp)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert a.dtype == np.int32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tres.make_input(tcfg, 2, seed=5, device="cpu").numpy(),
                                  np.asarray(jres.make_input(jcfg, 2, seed=5)))


def test_conv_out_bits_equal_jax():
    for bits_in in (2, 4, 20, 31):
        for k in (1, 2, 27, 576, 4608):
            assert tres._conv_out_bits(bits_in, 3, k) == jres._conv_out_bits(bits_in, 3, k)


@pytest.mark.parametrize("name", ["TINY", "NARROW", "NARROW_AVG"])
def test_forward_bit_exact_vs_jax_pallas_bodies(name):
    tcfg, jcfg = CONFIGS[name]
    got = tres.forward(tcfg, tres.init_params(tcfg, device="cpu"),
                       tres.make_input(tcfg, 2, device="cpu"))
    assert got.dtype == torch.int32 and got.shape == (2, tcfg.num_classes)
    np.testing.assert_array_equal(got.numpy(), _jax_logits(jcfg, "interpret", 2))


def test_resnet18_batch1_bit_exact_vs_jax_oracle():
    got = tres.forward(tres.RESNET18, tres.init_params(tres.RESNET18, device="cpu"),
                       tres.make_input(tres.RESNET18, 1, device="cpu"))
    want = _jax_logits(jres.RESNET18, "xla", 1)
    assert np.abs(want.astype(np.int64)).max() > 2**30  # the wrap is in play
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["TINY", "NARROW"])
def test_params_from_numpy_gives_the_same_logits(name):
    tcfg, jcfg = CONFIGS[name]
    jp = jres.init_params(jcfg, seed=7)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    x = tres.make_input(tcfg, 2, device="cpu")
    from_jax = tres.forward(tcfg, tres.params_from_numpy(tree, device="cpu"), x)
    native = tres.forward(tcfg, tres.init_params(tcfg, seed=7, device="cpu"), x)
    np.testing.assert_array_equal(from_jax.numpy(), native.numpy())


@pytest.mark.parametrize("name", ["TINY", "NARROW"])
def test_module_holds_int32_buffers_and_matches_forward(name):
    tcfg, _ = CONFIGS[name]
    model = tres.ResNet(tcfg, seed=2, device="cpu")
    bufs = dict(model.named_buffers())
    assert all(b.dtype == torch.int32 for b in bufs.values())
    assert "stem" in bufs and "head" in bufs and "s0_b0_conv1" in bufs
    assert len(bufs) == len(jax.tree_util.tree_leaves(tres.init_params(tcfg, 2, device="cpu")))
    assert list(model.parameters()) == []
    x = tres.make_input(tcfg, 3, device="cpu")
    want = tres.forward(tcfg, tres.init_params(tcfg, seed=2, device="cpu"), x)
    assert torch.equal(model(x), want)
    assert set(model.state_dict()) == set(bufs)


@pytest.mark.parametrize("name", ["TINY", "NARROW_AVG", "RESNET18"])
def test_forward_dispatches_layer_names_in_order(name, monkeypatch):
    tcfg, _ = CONFIGS[name]
    seen = []
    real = tapi.dispatch

    def spy(kernel, *args, **kwargs):
        seen.append(kernel)
        return real(kernel, *args, **kwargs)

    monkeypatch.setattr(tapi, "dispatch", spy)
    small = dataclasses.replace(tcfg, input_hw=tcfg.input_hw if name != "RESNET18" else 8)
    tres.forward(small, tres.init_params(small, device="cpu"), tres.make_input(small, 1, device="cpu"))
    assert seen == tres.layer_names(tcfg)
