"""The RG-LRU scan's gradient in the port (``repro_torch.kernels.rglru_scan``:
``_RGLRUScan`` around the forward kernel, ``_scan_bwd`` with its plain
version ``_scan_bwd_plain``) against the JAX package.

The JAX package has no backward kernel: it differentiates its associative
scan.  ``jax.grad`` of ``ref.rglru_scan_ref`` (which adds ``a_0·h0`` into
``b_0`` and scans associatively) is the reference, within the forward's
tolerance (atol = rtol = 1e-4: both sum the same terms in another order).
The plain backward is also held to autograd of a naive loop (``a·h + b``
rounded twice a step) within 1e-5, and the registered wrapper's gradients
equal ``_scan_bwd_plain``'s bit for bit.  On the CPU nothing launches; a
CUDA operand takes the kernel or raises (shown with a launch that fails).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import api as tapi  # noqa: E402
from repro_torch.kernels import rglru_scan as trg  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
SHAPES = [(1, 1, 1), (2, 5, 3), (2, 33, 8), (1, 64, 40), (3, 97, 36)]


def operands(shape, seed):
    """a = sigmoid(normal) (as the RG-LRU's exp(log_a) in (0, 1)), b and h0
    normal, and a normal upstream gradient g."""
    rng = np.random.default_rng(seed)
    bsz, _, w = shape
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal(shape)))).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    h0 = rng.standard_normal((bsz, w)).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return a, b, h0, g


def jax_grads(a, b, h0, g, with_h0):
    def loss(a, b, h0):
        return jnp.sum(jref.rglru_scan_ref(a, b, h0 if with_h0 else None) * g)

    return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))


def torch_grads(fn, a, b, h0, g, h0_grad=True):
    at, bt = torch.from_numpy(a).requires_grad_(), torch.from_numpy(b).requires_grad_()
    ht = torch.from_numpy(h0).requires_grad_(h0_grad)
    hs = fn(at, bt, ht)
    hs.backward(torch.from_numpy(g))
    return hs.detach(), at.grad, bt.grad, ht.grad


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("with_h0", [True, False])
def test_scan_gradient_matches_jax_grad_of_the_oracle(shape, with_h0):
    """Without h0 the scan starts from zeros (the model's prefill);
    JAX's oracle then takes ``h0=None``."""
    a, b, h0, g = operands(shape, sum(shape) + with_h0)
    if not with_h0:
        h0 = np.zeros_like(h0)
    want = jax_grads(a, b, h0, g, with_h0)
    tapi.reset_launch_counts()
    _, ga, gb, gh = torch_grads(tapi.rglru_scan, a, b, h0, g)
    assert tapi.launch_counts() == {}
    np.testing.assert_allclose(ga.numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(gb.numpy(), np.asarray(want[1]), **TOL)
    if with_h0:
        np.testing.assert_allclose(gh.numpy(), np.asarray(want[2]), **TOL)
    else:  # d hs / d h0 = a_0 · d_0 regardless; JAX's oracle has no h0 to differentiate
        np.testing.assert_array_equal(gh.numpy(), (torch.from_numpy(a[:, 0]) * gb[:, 0]).numpy())


def naive_scan(a, b, h0):
    h, outs = h0, []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        outs.append(h)
    return torch.stack(outs, 1)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_autograd_of_a_naive_loop(shape):
    a, b, h0, g = operands(shape, 7 * sum(shape))
    _, ga, gb, gh = torch_grads(naive_scan, a, b, h0, g)
    hs = trg._scan_plain(*(torch.from_numpy(x) for x in (a, b, h0)))
    da, db, dh0 = trg._scan_bwd_plain(torch.from_numpy(a), torch.from_numpy(h0), hs, torch.from_numpy(g), True)
    for got, want in ((da, ga), (db, gb), (dh0, gh)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("h0_grad", [True, False])
def test_registered_wrapper_gradient_is_the_plain_backward(shape, h0_grad):
    """``api.rglru_scan`` under autograd: the forward is the plain scan and
    the gradients are ``_scan_bwd_plain``'s, bit for bit; ∂h0 only when h0
    needs it."""
    a, b, h0, g = operands(shape, 3 * sum(shape))
    hs, ga, gb, gh = torch_grads(tapi.rglru_scan, a, b, h0, g, h0_grad)
    ta, th0, tg = torch.from_numpy(a), torch.from_numpy(h0), torch.from_numpy(g)
    assert torch.equal(hs, trg._scan_plain(ta, torch.from_numpy(b), th0))
    da, db, dh0 = trg._scan_bwd_plain(ta, th0, hs, tg, h0_grad)
    assert torch.equal(ga, da) and torch.equal(gb, db)
    assert (gh is None and dh0 is None) if not h0_grad else torch.equal(gh, dh0)


def test_plain_backward_keeps_signed_zeros_and_subnormals():
    """d_{T-1} is g_{T-1} as it is (a -0 stays -0, where fma(0, 0, -0) would
    give +0); products are rounded once, subnormals kept."""
    a = torch.tensor([[[0.5], [2.0 ** -70]]])
    h0 = torch.tensor([[2.0 ** -70]])
    b = torch.zeros_like(a)
    g = torch.tensor([[[3.0], [-0.0]]])
    hs = trg._scan_plain(a, b, h0)
    da, db, dh0 = trg._scan_bwd_plain(a, h0, hs, g, True)
    assert db[0, 1, 0].item() == 0.0 and torch.signbit(db[0, 1, 0])
    assert db[0, 0, 0].item() == 3.0
    assert da[0, 0, 0].item() == 3.0 * 2.0 ** -70
    assert dh0[0, 0].item() == 1.5


def test_scan_gradient_through_the_model_block_matches_jax():
    """The RG-LRU block's sequence form (``rglru_block_apply`` on the scan)
    differentiates to JAX's block gradients (its associative scan) within
    1e-4 of the largest, float32, every leaf of the block."""
    from repro.configs import get_config as jget
    from repro.configs import reduced_config as jreduced
    from repro.models import recurrent as jrec
    from repro_torch.configs import get_config as tget
    from repro_torch.configs import reduced_config as treduced
    from repro_torch.models import recurrent as trec
    from repro_torch.models import transformer as tt
    import dataclasses

    jcfg = dataclasses.replace(jreduced(jget("recurrentgemma-2b")), dtype="float32")
    tcfg = dataclasses.replace(treduced(tget("recurrentgemma-2b")), dtype="float32")
    p = jrec.rglru_block_init(jax.random.key(3), jcfg, jnp.float32)
    x = np.random.default_rng(5).standard_normal((2, 11, jcfg.d_model)).astype(np.float32)
    w = np.random.default_rng(6).standard_normal((2, 11, jcfg.d_model)).astype(np.float32)
    want = jax.jit(jax.grad(lambda p, x: jnp.sum(jrec.rglru_block_apply(p, x, jcfg)[0] * w), argnums=(0, 1)))(p, jnp.asarray(x))
    tp = tt.params_from_numpy(jax.tree_util.tree_map(np.asarray, p), device="cpu")
    leaves = tt._tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_()
    y, _ = trec.rglru_block_apply(tp, xt, tcfg)
    torch.sum(y * torch.from_numpy(w)).backward()
    flat = jax.tree_util.tree_flatten_with_path(want[0])[0]
    scale = max(float(np.abs(np.asarray(v)).max()) for _, v in flat)
    for path, leaf in flat:
        node = tp
        for k in path:
            node = node[k.key]
        assert node.grad is not None, path
        np.testing.assert_allclose(node.grad.numpy(), np.asarray(leaf), atol=1e-4 * scale, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want[1]), atol=1e-4 * float(np.abs(want[1]).max()), rtol=0)


class _FakeCuda:
    """Stands for a CUDA device: a wrapper given one takes its kernel path."""
    type = "cuda"


def test_a_cuda_operand_never_takes_the_plain_backward(monkeypatch):
    """On a CUDA operand ``_scan_bwd`` launches ``rglru_scan_bwd_f32`` with
    the plan's arguments, counts one launch, and a launch that fails raises:
    the plain version is never called."""
    a, b, h0, g = (torch.from_numpy(x) for x in operands((2, 40, 8), 1))
    hs = trg._scan_plain(a, b, h0)
    calls = []

    def no_plain(*args):
        raise AssertionError("the plain backward ran for a CUDA operand")

    def fake_launch(name, dev, *args):
        calls.append((name, args))

    monkeypatch.setattr(trg, "kernel_device", lambda *ts: _FakeCuda())
    monkeypatch.setattr(trg, "_scan_bwd_plain", no_plain)
    monkeypatch.setattr(_build, "launch", fake_launch)
    tapi.reset_launch_counts()
    da, db, dh0 = trg._scan_bwd(a, h0, hs, g, False)
    assert dh0 is None and da.shape == db.shape == a.shape
    (name, args), = calls
    plan = trg.rglru_plan(2, 40, 8, (a.data_ptr(), hs.data_ptr(), h0.data_ptr(), g.data_ptr()))
    assert name == "rglru_scan_bwd_f32" and args[6] is None
    assert args[7:] == (2, 40, 8, plan.group, int(plan.vec), plan.blocks)
    assert tapi.launch_counts() == {"rglru_scan_bwd": 1}

    def failing_launch(name, dev, *args):
        raise _build.KernelLaunchError(f"CUDA kernel {name} failed to launch: error 1")

    monkeypatch.setattr(_build, "launch", failing_launch)
    with pytest.raises(_build.KernelLaunchError, match="rglru_scan_bwd_f32"):
        trg._scan_bwd(a, h0, hs, g, True)


def test_backward_refuses_other_dtypes():
    a, b, h0, g = (torch.from_numpy(x) for x in operands((1, 4, 2), 2))
    with pytest.raises(TypeError, match="float32"):
        trg._scan_bwd(a.double(), h0, a, g, True)
