"""One train step of the port (``repro_torch/train/steps.py``:
``make_train_step`` on a state carried from JAX's ``make_train_state``)
against the JAX package's, for every arch at ``reduced_config`` in float32
(jitted JAX), with ``grad_accum`` 2, and the state's shapes, the sharding
refusal and ``train_state_from_numpy``.  Tolerances:
``tests/_torch_train_ref.py``; bfloat16 in ``test_torch_train_step_bf16.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_lm_ref import np_tree  # noqa: E402
from _torch_train_ref import check_step, leaf_pairs  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.configs import reduced_config as treduced  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402


@pytest.mark.parametrize("arch", list_archs())
def test_train_step_equal_jax_float32(arch):
    check_step(arch, "float32")


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "qwen2-0.5b", "dbrx-132b"])
def test_train_step_with_grad_accum_equal_jax(arch):
    """``grad_accum=2``: two microbatches of one row each, their gradients
    summed in float32 and divided by 2; the last microbatch's ce and aux."""
    check_step(arch, "float32", grad_accum=2)


def test_grad_accum_sums_the_microbatches():
    """The port's accumulated gradient is the mean of the microbatches'
    gradients: the moments after one step equal those of a step on the
    microbatches' averaged gradients, to float32 rounding."""
    from _torch_train_ref import port_state, setup

    _, tcfg, _, tfl, params, _, tb = setup("qwen2-0.5b", "float32")
    state = port_state(jsteps.make_train_state(params, jsteps.AdamWConfig()))
    g0 = tsteps._grads_of(state["params"], tcfg, {k: v[:1] for k, v in tb.items()}, tfl)[2]
    g1 = tsteps._grads_of(state["params"], tcfg, {k: v[1:] for k, v in tb.items()}, tfl)[2]
    new, metrics = tsteps.make_train_step(tcfg, dataclasses.replace(tfl, grad_accum=2))(state, tb)
    m_want = topt.tree_map(lambda a, b: (a / 2 + b / 2), g0, g1)
    gn = topt.global_norm(m_want)
    scale = min(1.0, 1.0 / max(float(gn), 1e-12))
    for a, b in zip(topt.tree_leaves(new["opt"]["m"]), topt.tree_leaves(m_want)):
        torch.testing.assert_close(a, (1 - 0.9) * b * scale, atol=1e-7, rtol=1e-5)


def test_train_state_shape_matches_jax_eval_shape():
    for arch in ("recurrentgemma-2b", "whisper-medium"):
        jcfg, tcfg = jreduced(jget(arch)), treduced(tget(arch))
        want = jsteps.train_state_shape(jcfg, jsteps.AdamWConfig())
        got = tsteps.train_state_shape(tcfg, topt.AdamWConfig())
        pairs = list(leaf_pairs(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), want), got))
        assert len(pairs) == len(jax.tree_util.tree_leaves(want))
        for path, w, g in pairs:
            assert g.device.type == "meta" and tuple(g.shape) == w.shape and str(g.dtype).endswith(str(w.dtype)), path
    full = tsteps.train_state_shape(tget("recurrentgemma-2b"), topt.AdamWConfig())
    n = sum(leaf.numel() for leaf in tt._tree_leaves(full["params"]))
    assert 2.85e9 < n < 2.95e9  # RecurrentGemma-2B's 2.894 B parameters


def test_train_state_from_numpy_carries_every_leaf_bit_for_bit():
    jcfg, tcfg = jreduced(jget("recurrentgemma-2b")), treduced(tget("recurrentgemma-2b"))
    jstate = jsteps.make_train_state(jt.init_params(jax.random.key(2), jcfg), jsteps.AdamWConfig())
    tstate = tsteps.train_state_from_numpy(np_tree(jstate), device="cpu")
    assert sorted(tstate) == ["opt", "params", "step"] and sorted(tstate["opt"]) == ["count", "m", "master", "v"]
    for path, w, g in leaf_pairs(jstate, tstate):
        assert str(g.dtype).endswith(str(w.dtype)), path
        if w.dtype == jnp.bfloat16:
            assert np.array_equal(g.view(torch.int16).numpy(), w.view(np.int16)), path
        else:
            assert np.array_equal(g.numpy(), w), path


def test_rules_raise_naming_s13():
    """S13 gave the step its sharding functions and S13b its tensor-parallel
    execution on a process mesh; a model axis wider than one on a mesh with
    no ranks raises ValueError naming ``make_host_mesh``, rules that are no
    MeshRules TypeError."""
    from repro_torch.dist.sharding import MeshRules
    from repro_torch.launch.mesh import MeshDescription

    cfg = treduced(tget("qwen2-0.5b"))
    with pytest.raises(ValueError, match="make_host_mesh"):
        tsteps.make_train_step(cfg, rules=MeshRules.from_mesh(MeshDescription((2, 2), ("data", "model"))))
    with pytest.raises(TypeError, match="MeshRules"):
        tsteps.make_train_step(cfg, rules=object())
    for name in ("zero1_spec", "train_state_specs", "batch_specs_tree", "jit_train_step"):
        assert callable(getattr(tsteps, name))
