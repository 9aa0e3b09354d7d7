"""The port's train-state and input specs and its memory model against the
JAX package's (``train.steps.train_state_specs`` with ZeRO-1 off and on,
``batch_specs_tree``, ``launch.specs.input_specs``,
``launch.memory_model.analytic_memory``): all 10 configs at full size on
``meta``, every shape cell, the meshes 16 × 16, 2 × 16 × 16, 4 × 4, 8 × 1 and
1 × 1, ``seq_shard_kv`` off and on.  Specs, shapes and dtypes entry for
entry, the decision logs equal, every memory figure equal (the port's
``fits_device`` takes the place of JAX's TPU check)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_specs_ref import (  # noqa: E402,F401
    MESHES,
    assert_specs_equal,
    cached_shapes,
    rules_pair,
    sds_leaves,
)
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.launch import memory_model as jmem  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models.runtime import RunFlags as JFlags  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs.base import SHAPES as TSHAPES  # noqa: E402
from repro_torch.launch import memory_model as tmem  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models.runtime import RunFlags as TFlags  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

ARCHS = list_archs()
GIB = 2**30


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_and_batch_specs_equal_jax(arch, mesh):
    jcfg, tcfg = jget(arch), tget(arch)
    jr, tr = rules_pair(mesh)
    for zero1 in (False, True):
        assert_specs_equal(jsteps.train_state_specs(jcfg, jr, jsteps.AdamWConfig(), JFlags(zero1=zero1)),
                           tsteps.train_state_specs(tcfg, tr, topt.AdamWConfig(), TFlags(zero1=zero1)),
                           f"{arch} train_state_specs zero1={zero1}")
        assert tr.decisions == jr.decisions
    for b in (1, 8, 12, 256):
        jb = {"tokens": jnp.zeros((b, 4), jnp.int32), "enc_embeds": jnp.zeros((b, 3, 2), jnp.float32)}
        tb = {"tokens": torch.zeros((b, 4), dtype=torch.int32, device="meta"),
              "enc_embeds": torch.zeros((b, 3, 2), device="meta")}
        assert_specs_equal(jsteps.batch_specs_tree(jb, jr), tsteps.batch_specs_tree(tb, tr), f"batch {b}")
    assert tr.decisions == jr.decisions


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_memory_model_equal_jax(arch, mesh):
    jcfg, tcfg = jget(arch), tget(arch)
    for ssk in (False, True):
        for jcell, tcell in zip(JSHAPES, TSHAPES):
            if ssk and tcell.kind != "decode":
                continue  # seq_shard_kv shards only the decode cache
            assert dataclasses.astuple(jcell) == dataclasses.astuple(tcell)
            jr, tr = rules_pair(mesh)
            jin = jspecs.input_specs(jcfg, jcell, jr, JFlags(seq_shard_kv=ssk))
            tin = tspecs.input_specs(tcfg, tcell, tr, TFlags(seq_shard_kv=ssk))
            what = f"{arch} {tcell.name} seq_shard_kv={ssk}"
            assert list(sds_leaves(tin)) == list(sds_leaves(jin)), what
            assert all(leaf.device.type == "meta" for *_, leaf in _leaves(tin)), what
            assert tr.decisions == jr.decisions, what
            want = jmem.analytic_memory(jcfg, jcell, jr, JFlags(seq_shard_kv=ssk), jin)
            got = tmem.analytic_memory(tcfg, tcell, tr, TFlags(seq_shard_kv=ssk), tin, device_bytes=80 * GIB)
            want.pop("fits_v5e_16g")
            assert got.pop("device_bytes") == 80 * GIB
            assert got.pop("fits_device") == (want["analytic_peak_per_device"] < 80 * GIB)
            assert got == want, what


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def test_input_specs_without_rules_are_the_shapes():
    cfg, cell = tget("qwen2-0.5b"), TSHAPES[2]
    jin = jspecs.input_specs(jget("qwen2-0.5b"), JSHAPES[2])
    tin = tspecs.input_specs(cfg, cell)
    assert [x[:3] for x in sds_leaves(tin)] == [x[:3] for x in sds_leaves(jin)]
    assert all(x[3] is None for x in sds_leaves(tin))


def test_memory_model_holds_the_peak_to_the_device():
    """``fits_device`` against the size given, else the card, else None."""
    cfg, cell = tget("recurrentgemma-2b"), TSHAPES[0]
    _, tr = rules_pair("1x1")
    specs = tspecs.input_specs(cfg, cell, tr)
    small = tmem.analytic_memory(cfg, cell, tr, TFlags(), specs, device_bytes=GIB)
    assert (small["device_bytes"], small["fits_device"]) == (GIB, False)
    big = tmem.analytic_memory(cfg, cell, tr, TFlags(), specs, device_bytes=2**50)
    assert big["fits_device"] is True
    card = tmem.analytic_memory(cfg, cell, tr, TFlags(), specs)
    if not torch.cuda.is_available():
        assert (card["device_bytes"], card["fits_device"]) == (None, None)
    # the state bytes at dp = 1 are the whole train state's
    state = tsteps.train_state_shape(cfg, topt.AdamWConfig())
    assert card["state_bytes_per_device"] == sum(x.numel() * x.element_size() for _, x in _leaves(state))
