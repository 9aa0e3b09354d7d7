"""``loss_fn``'s gradients in the port (autograd through every family, the
RG-LRU on its scan's ``autograd.Function``, each block rematerialized)
against ``jax.value_and_grad`` of the JAX package's ``loss_fn``, for every
arch at ``reduced_config`` on JAX's weights, in float32 (jitted JAX) and
bfloat16 (JAX op by op).  Tolerances: ``tests/_torch_train_ref.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_lm_ref import f32  # noqa: E402
from _torch_train_ref import GRAD_TOL, assert_tree_close, jax_grad_fn, port_state, setup  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.kernels import rglru_scan as trg  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", list_archs())
def test_loss_and_gradients_equal_jax(arch, dtype):
    jcfg, tcfg, jfl, tfl, params, jb, tb = setup(arch, dtype)
    (jloss, jparts), jgrads = jax_grad_fn(jcfg, jfl, dtype == "bfloat16")(params, jb)
    tp = port_state(params)
    loss, parts, grads = tsteps._grads_of(tp, tcfg, tb, tfl)
    rel = GRAD_TOL[dtype]
    assert loss.dtype == torch.float32 and loss.shape == () and not loss.requires_grad
    for got, want in ((loss, jloss), (parts["ce"], jparts["ce"]), (parts["aux"], jparts["aux"])):
        assert abs(float(got) - float(want)) <= rel * max(abs(float(want)), 1.0), (arch, got, want)
    assert (float(parts["aux"]) > 0) == jcfg.is_moe
    assert_tree_close(jgrads, grads, rel, f"{arch} {dtype} gradients")
    assert all(g.dtype == p.dtype for g, p in zip(tt._tree_leaves(grads), tt._tree_leaves(tp)))
    assert all(not p.requires_grad for p in tt._tree_leaves(tp))


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "qwen2-0.5b", "xlstm-1.3b"])
def test_remat_changes_no_bit_and_recomputes_each_scan(arch, monkeypatch):
    """Per-block remat (``RunFlags.remat``) recomputes each block in the
    backward: the gradients are bit-equal to a run without it, and the
    RG-LRU scan runs twice a layer in the forward (once, then its
    recompute) and its backward once."""
    import dataclasses

    _, tcfg, _, tfl, params, _, tb = setup(arch, "float32")
    calls = {"fwd": 0, "bwd": 0}
    scan, bwd = trg._scan, trg._scan_bwd

    def count_fwd(*a):
        calls["fwd"] += 1
        return scan(*a)

    def count_bwd(*a):
        calls["bwd"] += 1
        return bwd(*a)

    monkeypatch.setattr(trg, "_scan", count_fwd)
    monkeypatch.setattr(trg, "_scan_bwd", count_bwd)
    tp = port_state(params)
    on = tsteps._grads_of(tp, tcfg, tb, tfl)
    n_rglru = sum(kind == "rglru" for kind in tcfg.layer_kinds())
    assert calls == {"fwd": 2 * n_rglru, "bwd": n_rglru}
    off = tsteps._grads_of(tp, tcfg, tb, dataclasses.replace(tfl, remat=False))
    assert calls == {"fwd": 3 * n_rglru, "bwd": 2 * n_rglru}
    assert torch.equal(on[0], off[0])
    for a, b in zip(tt._tree_leaves(on[2]), tt._tree_leaves(off[2])):
        assert torch.equal(a, b)


def test_every_leaf_gets_a_gradient_and_unreached_leaves_get_zeros():
    """A leaf the loss does not reach gets a zero gradient, as JAX's
    ``value_and_grad`` gives: the vision adapter without patch embeddings."""
    _, tcfg, _, tfl, params, _, tb = setup("phi-3-vision-4.2b", "float32")
    tp = port_state(params)
    _, _, grads = tsteps._grads_of(tp, tcfg, {k: v for k, v in tb.items() if k != "patch_embeds"}, tfl)
    for leaf in tt._tree_leaves(grads["vision_adapter"]):
        assert not leaf.any()
    assert float(np.abs(f32(grads["embed"]["w"].numpy())).max()) > 0
