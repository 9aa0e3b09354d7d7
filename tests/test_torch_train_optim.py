"""The port's AdamW and learning-rate schedules (``repro_torch/train/
optimizer.py``) against the JAX package's on equal numpy trees.

Both run the same float32 ops in the same order; what may differ is the
order of the global norm's sums (XLA's reduction against torch's) and the
last bit of ``pow``, ``sqrt`` and ``cos``.  So the tolerances are stated in
float32 ulps: the norm and the schedules within 8 and 16 ulps of their
value; each leaf of the moments and master weights, after three steps,
within 16 ulps of the leaf's largest magnitude (every value carries the clip
scale's and the bias corrections' last bit, and a moment that nearly
cancels keeps that absolute error; the second moment carries the square
of the clip scale: observed up to 7.1e-7 of the largest, 11 ulps);
the bfloat16 parameters within one bfloat16 ulp of the leaf's largest
magnitude (masters an ulp apart may round the other way).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402

F32_ULPS = 16
LEAF_ULPS = 16


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {
        "embed": {"w": (rng.standard_normal((64, 16)) * scale).astype(np.float32)},
        "blocks": {"00_attn": {"wq": {"w": (rng.standard_normal((3, 16, 24)) * scale).astype(np.float32),
                                      "b": (rng.standard_normal((3, 24)) * scale).astype(np.float32)}},
                   "01_rglru": {"lambda": (rng.standard_normal((3, 16)) * scale).astype(np.float32)}},
        "final_norm": {"scale": (1 + rng.standard_normal(16) * scale).astype(np.float32)},
    }


def _jax(tree, dtype):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(dtype), tree)


def _torch(tree, dtype):
    return topt.tree_map(lambda a: torch.from_numpy(np.array(a)).to(dtype), tree)


def _np(t):
    if isinstance(t, torch.Tensor):
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t.astype(jnp.float32) if t.dtype == jnp.bfloat16 else t)


def _assert_trees(want, got, what):
    """Leaf for leaf, in JAX's order: within LEAF_ULPS float32 ulps of the
    leaf's largest magnitude."""
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    gl = topt.tree_leaves(got)
    assert len(wl) == len(gl), what
    for (path, w), g in zip(wl, gl):
        w, g = _np(w), _np(g)
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32, (what, path)
        err = float(np.abs(g - w).max())
        assert err <= LEAF_ULPS * np.spacing(np.abs(w).max()), (what, path, err, np.abs(w).max())


def test_tree_leaves_follow_jax_order():
    tree = _tree(0)
    want = jax.tree_util.tree_leaves(tree)
    got = topt.tree_leaves(tree)
    assert len(want) == len(got) and all(a is b for a, b in zip(want, got))


@pytest.mark.parametrize("scale", [1e-3, 1.0, 30.0])
def test_global_norm_equal_to_jax(scale):
    tree = _tree(1, scale)
    want = float(jopt.global_norm(_jax(tree, jnp.float32)))
    got = topt.global_norm(_torch(tree, torch.float32))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_array_max_ulp(np.float32(got), np.float32(want), maxulp=8)


@pytest.mark.parametrize("dtype,keep_master", [("float32", True), ("float32", False), ("bfloat16", True)])
@pytest.mark.parametrize("grad_scale", [1e-4, 10.0])  # below and above the clip
def test_adamw_update_equal_to_jax(dtype, keep_master, grad_scale):
    """Three steps from equal params and gradients: moments, master weights,
    count and parameters in JAX's op order."""
    cfg_kw = dict(lr=1e-2, keep_master=keep_master)
    jcfg, tcfg = jopt.AdamWConfig(**cfg_kw), topt.AdamWConfig(**cfg_kw)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    params = _tree(2)
    jp, tp = _jax(params, jdt), _torch(params, tdt)
    js, ts = jopt.adamw_init(jp, jcfg), topt.adamw_init(tp, tcfg)
    assert sorted(js) == sorted(ts)
    for step in range(3):
        grads = _tree(10 + step, grad_scale)
        lr = np.float32(1e-2 * (step + 1) / 3)
        jp, js = jax.jit(lambda g, s, p, l: jopt.adamw_update(g, s, p, jcfg, l))(
            _jax(grads, jdt), js, jp, jnp.float32(lr))
        tp, ts = topt.adamw_update(_torch(grads, tdt), ts, tp, tcfg, torch.tensor(lr))
        assert int(ts["count"]) == int(js["count"]) == step + 1 and ts["count"].dtype == torch.int32
        for name in ("m", "v") + (("master",) if keep_master else ()):
            _assert_trees(js[name], ts[name], name)
        assert all(t.dtype == tdt for t in topt.tree_leaves(tp))
        if dtype == "float32":
            _assert_trees(jp, tp, "params")
        else:
            for w, g in zip(jax.tree_util.tree_leaves(jp), topt.tree_leaves(tp)):
                assert np.abs(_np(g) - _np(w)).max() <= np.abs(_np(w)).max() * 2.0 ** -7


def test_adamw_update_updates_the_state_in_place():
    """The moments and master weights are updated in place (a donated
    state) and returned in the new state; the parameters are new tensors."""
    cfg = topt.AdamWConfig()
    tp = _torch(_tree(3), torch.bfloat16)
    ts = topt.adamw_init(tp, cfg)
    m0, master0 = topt.tree_leaves(ts["m"])[0], topt.tree_leaves(ts["master"])[0]
    new_p, new_s = topt.adamw_update(_torch(_tree(4), torch.bfloat16), ts, tp, cfg, torch.tensor(1e-3))
    assert topt.tree_leaves(new_s["m"])[0] is m0 and topt.tree_leaves(new_s["master"])[0] is master0
    assert float(m0.abs().max()) > 0
    assert all(a is not b for a, b in zip(topt.tree_leaves(new_p), topt.tree_leaves(tp)))


SCHEDULES = [
    ("wsd", dict(base_lr=3e-4, warmup=11, stable=80, decay=20)),
    ("wsd", dict(base_lr=1.0, warmup=10, stable=80, decay=10, floor=0.05)),
    ("cosine", dict(base_lr=3e-4, warmup=101, total=10_000)),
    ("cosine", dict(base_lr=1e-2, warmup=1, total=120, floor_frac=0.2)),
]


@pytest.mark.parametrize("kind,kw", SCHEDULES)
def test_schedules_equal_to_jax(kind, kw):
    jf = getattr(jopt, f"{kind}_schedule")(**kw)
    tf = getattr(topt, f"{kind}_schedule")(**kw)
    steps = np.array([0, 1, 5, 9, 10, 11, 50, 89, 90, 91, 95, 100, 101, 119, 120, 5000, 9999, 20000], np.int32)
    for s in steps:
        want = np.float32(jf(jnp.int32(s)))
        got = tf(torch.tensor(int(s), dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_array_max_ulp(np.float32(got), want, maxulp=F32_ULPS)


@pytest.mark.parametrize("arch", ["minicpm-2b", "qwen2-0.5b"])
@pytest.mark.parametrize("total", [8, 120, 10_000])
def test_schedule_for_equal_to_jax(arch, total):
    """MiniCPM takes the WSD schedule, the others the cosine one, with JAX's
    horizons."""
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget

    jf, tf = jopt.schedule_for(jget(arch), 3e-4, total), topt.schedule_for(tget(arch), 3e-4, total)
    for s in sorted({0, 1, total // 100, total // 2, int(total * 0.8) + total // 100 + 1, total - 1, total}):
        np.testing.assert_array_max_ulp(np.float32(tf(torch.tensor(s, dtype=torch.int32))),
                                        np.float32(jf(jnp.int32(s))), maxulp=F32_ULPS)
    assert math.isclose(float(tf(torch.tensor(total // 100 + 1, dtype=torch.int32))), 3e-4, rel_tol=1e-6)
