"""The port's mixture-of-experts FFN (``repro_torch.models.moe``) against the
JAX package's ``models/moe.py``, at ``reduced_config`` of DBRX-132B and
Kimi-K2 (4 experts, top 2) on JAX's weights.

The integer routing (each routed pair's buffer slot, token and kept flag,
in the stable expert order) is held **equal** to JAX's on equal logits,
including the pairs dropped past the capacity; the gates and the
dispatched rows bit-equal, the gates within 1e-6.  ``moe_ffn``'s output and aux loss within 1e-5
of the largest reference value in float32 (the same float ops; the expert
products and the combine's adds may sum in another order).
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as jm  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.models import moe as tm  # noqa: E402

from _torch_lm_ref import assert_close, configs, to_np, to_torch  # noqa: E402

MOE_ARCHS = ("dbrx-132b", "kimi-k2-1t-a32b")


def _ffn(arch, dtype="float32", **cfg_kw):
    """Group 0's MoE FFN from JAX's init_params: (JAX params, port params,
    JAX config, port config)."""
    jcfg, tcfg = configs(arch, dtype)
    jcfg, tcfg = dataclasses.replace(jcfg, **cfg_kw), dataclasses.replace(tcfg, **cfg_kw)
    params = jt.init_params(jax.random.key(0), jcfg)
    p = jax.tree_util.tree_map(lambda l: l[0], params["blocks"]["00_attn"]["ffn"])
    return p, to_torch(p), jcfg, tcfg


def _capacity(tg, cfg):
    k, e = cfg.experts_per_token, cfg.n_experts
    return max(k, int(math.ceil(tg * k / e * cfg.moe_capacity_factor)))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5], ids=["cf1.25", "cf0.5-drops"])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_group_equals_jax(arch, groups, capacity_factor):
    """Each routing group of 24 tokens, fed the same float32 logits and
    rows: slot, st and keep equal, the buffer bit-equal, the gates within
    1e-6 (a softmax over the k top logits, an ulp apart); at capacity factor
    0.5 some pairs are dropped (to the overflow row)."""
    _, _, jcfg, _ = _ffn(arch, moe_capacity_factor=capacity_factor)
    tokens = 48
    tg = tokens // groups
    cap = _capacity(tg, jcfg)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((groups, tg, jcfg.d_model)).astype(np.float32)
    logits = rng.standard_normal((groups, tg, jcfg.n_experts)).astype(np.float32)
    dropped = 0
    for gi in range(groups):
        wbuf, (wslot, wst, wsg, wkeep) = jm._route_group(jnp.asarray(x[gi]), jnp.asarray(logits[gi]),
                                                          jcfg.experts_per_token, cap)
        gbuf, (gslot, gst, gsg, gkeep) = tm._route_group(torch.from_numpy(x[gi]), torch.from_numpy(logits[gi]),
                                                          jcfg.experts_per_token, cap)
        assert np.array_equal(gslot.numpy(), np.asarray(wslot))
        assert np.array_equal(gst.numpy(), np.asarray(wst))
        assert np.array_equal(gkeep.numpy(), np.asarray(wkeep))
        np.testing.assert_allclose(gsg.numpy(), np.asarray(wsg), rtol=1e-6)  # a softmax over k gates
        assert np.array_equal(gbuf.numpy(), np.asarray(wbuf))
        dropped += int((~gkeep).sum())
        assert (gslot.numpy()[~gkeep.numpy()] == jcfg.n_experts * cap).all()
    if capacity_factor < 1:
        assert dropped > 0


def test_route_group_ties_and_skew():
    """A skewed router (every token prefers expert 0) and exactly tied
    logits: JAX's top-k order and the stable sort keep the same pairs."""
    _, _, jcfg, _ = _ffn("dbrx-132b", moe_capacity_factor=1.0)
    k, e = jcfg.experts_per_token, jcfg.n_experts
    logits = np.tile(np.arange(e, 0, -1, dtype=np.float32), (16, 1))  # all prefer 0, then 1
    logits[::3] = 1.0  # ties: every expert equal on every third token
    x = np.random.default_rng(8).standard_normal((16, jcfg.d_model)).astype(np.float32)
    cap = _capacity(16, jcfg)
    _, want = jm._route_group(jnp.asarray(x), jnp.asarray(logits), k, cap)
    _, got = tm._route_group(torch.from_numpy(x), torch.from_numpy(logits), k, cap)
    for i in (0, 1, 3):  # slot, st, keep
        assert np.array_equal(got[i].numpy(), np.asarray(want[i]))
    assert not got[3].all()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_combine_group_equals_jax(arch):
    _, _, jcfg, _ = _ffn(arch, moe_capacity_factor=0.5)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((24, jcfg.d_model)).astype(np.float32)
    logits = rng.standard_normal((24, jcfg.n_experts)).astype(np.float32)
    cap = _capacity(24, jcfg)
    y = rng.standard_normal((jcfg.n_experts * cap, jcfg.d_model)).astype(np.float32)
    _, winfo = jm._route_group(jnp.asarray(x), jnp.asarray(logits), jcfg.experts_per_token, cap)
    _, ginfo = tm._route_group(torch.from_numpy(x), torch.from_numpy(logits), jcfg.experts_per_token, cap)
    want = jm._combine_group(jnp.asarray(y), winfo, 24)
    got = tm._combine_group(torch.from_numpy(y), ginfo, 24)
    assert_close(want, to_np(got), 1e-6, "combine")


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5], ids=["cf1.25", "cf0.5-drops"])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_equals_jax(arch, groups, capacity_factor):
    jp, tp, jcfg, tcfg = _ffn(arch, moe_capacity_factor=capacity_factor)
    x = np.random.default_rng(10).standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    want, want_aux = jm.moe_ffn(jp, jnp.asarray(x), jcfg, groups)
    got, aux = tm.moe_ffn(tp, torch.from_numpy(x), tcfg, groups)
    assert got.shape == (2, 12, jcfg.d_model) and aux.dtype == torch.float32
    assert_close(want, to_np(got), 1e-5, "out")
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_bfloat16_equals_jax_op_by_op(arch):
    """bfloat16 experts against JAX run op by op: equal routing (the
    router runs in float32 on the same rows), within 2**-8 of the largest
    output value (one bfloat16 rounding)."""
    jp, tp, jcfg, tcfg = _ffn(arch, "bfloat16")
    jx = jnp.asarray(np.random.default_rng(11).standard_normal((2, 12, jcfg.d_model)), jnp.bfloat16)
    want, want_aux = jm.moe_ffn(jp, jx, jcfg, 1)
    got, aux = tm.moe_ffn(tp, to_torch(jx), tcfg, 1)
    assert got.dtype == torch.bfloat16
    assert_close(want, to_np(got), 2.0 ** -8, "out")
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


def test_moe_ffn_refuses_groups_that_do_not_divide():
    _, tp, _, tcfg = _ffn("dbrx-132b")
    with pytest.raises(ValueError, match="routing groups"):
        tm.moe_ffn(tp, torch.zeros((1, 5, tcfg.d_model)), tcfg, 2)


@pytest.mark.parametrize("routing_groups,want", [(0, 1), (2, 2), (5, 4)])
def test_routing_groups_rule_equals_jax(routing_groups, want, monkeypatch):
    """The FFN's groups: RunFlags.routing_groups (one group without it and
    without sharding rules), lowered until it divides the 8 tokens."""
    from repro_torch.models import transformer as tt
    from repro_torch.models.runtime import RunFlags

    _, tp, _, tcfg = _ffn("kimi-k2-1t-a32b")
    seen = []
    monkeypatch.setattr(tt, "moe_ffn", lambda p, x, cfg, g: seen.append(g) or (x, torch.zeros(())))
    tt._ffn_apply(tp, torch.zeros((2, 4, tcfg.d_model)), tcfg, RunFlags(routing_groups=routing_groups))
    assert seen == [want]
    jseen = []
    monkeypatch.setattr(jt, "moe_ffn", lambda p, x, cfg, g: jseen.append(g) or (x, jnp.float32(0)))
    from repro.models.runtime import RunFlags as JFlags

    jt._ffn_apply({}, jnp.zeros((2, 4, tcfg.d_model)), tcfg, JFlags(routing_groups=routing_groups), None)
    assert jseen == seen


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_init_shapes_equal_jax(arch):
    jcfg, tcfg = configs(arch, "bfloat16")
    want = jax.eval_shape(lambda: jm.moe_init(jax.random.key(0), jcfg, jnp.bfloat16))
    got = tm.moe_init(None, tcfg, torch.bfloat16, device="meta")
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape and str(node.dtype).endswith(str(leaf.dtype)), path
    assert got["router"]["w"].dtype == torch.float32
