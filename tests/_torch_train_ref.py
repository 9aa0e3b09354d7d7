"""Shared helpers of the port's training tests (``tests/test_torch_train*.py``):
the JAX package's loss gradients and train step as the reference, run on
JAX's weights carried into the port, and the tolerances with their reasons.

* Gradients, float32: each leaf within 1e-5 of the tree's largest gradient
  (``_torch_lm_ref``'s 1e-5 class, relative to the largest value as the
  logits are).  Observed at most 7.4e-6 (xLSTM's mLSTM projections); the
  RG-LRU decay ``lambda`` gets a gradient that cancels (1.9e-4 of its own
  largest, 1.9e-9 of the tree's).
* Gradients, bfloat16: within 2**-4 of the tree's largest, against JAX run
  op by op (``_torch_lm_ref``'s bfloat16 class and reference); observed at
  most 0.059 (xLSTM's sLSTM recurrence).
* The train step: loss, ce and aux as the gradients' class; the first and
  second moments (0.1 · g and 0.05 · g² after one step) within the
  gradients' class of their tree's largest value (twice it for the second
  moment, a square); in float32 each master weight within half a step of
  JAX's (``lr / 2``: AdamW's first step moves a weight by about ``lr`` in
  the gradient's direction, so a flipped direction would differ by ``2
  lr``; observed at most 0.22 ``lr``); in bfloat16, where the gradients
  differ by 2**-4 and directions of the smallest ones do flip (observed up
  to 7.8% of a bias), each master weight within ``2 lr`` and each bfloat16
  parameter equal but for one bfloat16 ulp.  ``lr``, ``count`` and ``step``
  exactly.
"""
from __future__ import annotations

import functools

import jax
import numpy as np
import torch

from _torch_lm_ref import batch_pair, configs, f32, flags, np_tree, to_np
from repro.models import transformer as jt
from repro.train import steps as jsteps
from repro_torch.train import steps as tsteps

GRAD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -4}
B, S = 2, 12


def setup(arch: str, dtype: str, **flag_kw):
    """(JAX config, port config, JAX flags, port flags, JAX params, JAX
    batch, port batch) at ``reduced_config``; bfloat16 with JAX op by op."""
    jcfg, tcfg = configs(arch, dtype)
    jfl, tfl = flags(**flag_kw, **({"scan_layers": False} if dtype == "bfloat16" else {}))
    params = jt.init_params(jax.random.key(0), jcfg)
    jb, tb = batch_pair(jcfg, B, S, 1)
    return jcfg, tcfg, jfl, tfl, params, jb, tb


@functools.lru_cache(maxsize=None)
def jax_grad_fn(cfg, fl, eager: bool):
    f = jax.value_and_grad(lambda p, b: jt.loss_fn(p, cfg, b, fl), has_aux=True)
    return f if eager else jax.jit(f)


@functools.lru_cache(maxsize=None)
def jax_step_fn(cfg, fl, eager: bool):
    f = jsteps.make_train_step(cfg, fl)
    return f if eager else jax.jit(f)


def leaf_pairs(want_tree, got_tree):
    """(path, JAX leaf as numpy, port leaf) in JAX's flattening order."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(np_tree(want_tree))[0]:
        node = got_tree
        for k in path:
            node = node[k.key]
        yield "/".join(k.key for k in path), leaf, node


def assert_tree_close(want_tree, got_tree, rel: float, what: str) -> float:
    """Every leaf within ``rel`` of the largest magnitude over the JAX tree,
    shapes and dtypes equal; returns the largest gap relative to it."""
    pairs = list(leaf_pairs(want_tree, got_tree))
    scale = max(float(np.abs(f32(w)).max()) for _, w, _ in pairs)
    worst = 0.0
    for path, w, g in pairs:
        assert tuple(g.shape) == w.shape and str(g.dtype).endswith(str(w.dtype)), (what, path, g.dtype, w.dtype)
        got = to_np(g)
        assert np.isfinite(got).all(), (what, path)
        err = float(np.abs(got - f32(w)).max()) if w.size else 0.0
        worst = max(worst, err / scale)
        assert err <= rel * scale, f"{what} {path}: max |diff| {err} > {rel} x {scale}"
    return worst


def port_state(jstate):
    """The port's train state carried from JAX's (every leaf, on the CPU)."""
    return tsteps.train_state_from_numpy(np_tree(jstate), device="cpu")


def check_step(arch: str, dtype: str, **flag_kw):
    """One ``make_train_step`` from JAX's ``make_train_state`` in both
    packages: metrics, moments, master weights and parameters held as the
    module docstring states.  Returns the port's (new state, metrics)."""
    jcfg, tcfg, jfl, tfl, params, jb, tb = setup(arch, dtype, **flag_kw)
    jstate = jsteps.make_train_state(params, jsteps.AdamWConfig())
    tstate = port_state(jstate)
    old_master = {p: to_np(t).copy() for p, _, t in leaf_pairs(jstate["opt"]["master"], tstate["opt"]["master"])}
    jnew, jm = jax_step_fn(jcfg, jfl, dtype == "bfloat16")(jstate, jb)
    tnew, tm = tsteps.make_train_step(tcfg, tfl)(tstate, tb)
    rel = GRAD_TOL[dtype]
    assert sorted(tm) == sorted(jm) == ["aux", "ce", "loss", "lr"]
    assert float(tm["lr"]) == float(jm["lr"]) and tm["lr"].dtype == torch.float32
    for k in ("loss", "ce", "aux"):
        assert abs(float(tm[k]) - float(jm[k])) <= rel * max(abs(float(jm[k])), 1.0), (k, tm[k], jm[k])
    assert int(tnew["step"]) == int(jnew["step"]) == 1 and int(tnew["opt"]["count"]) == int(jnew["opt"]["count"]) == 1
    assert tnew["step"].dtype == tnew["opt"]["count"].dtype == torch.int32
    assert sorted(tnew["opt"]) == sorted(jnew["opt"])
    assert_tree_close(jnew["opt"]["m"], tnew["opt"]["m"], rel, "m")
    assert_tree_close(jnew["opt"]["v"], tnew["opt"]["v"], 2 * rel, "v")
    lr = float(jm["lr"])
    for path, want, got in leaf_pairs(jnew["opt"]["master"], tnew["opt"]["master"]):
        w, g = f32(want), to_np(got)
        # half a step (float32), or two steps and the master's rounding (bfloat16)
        limit = lr / 2 if dtype == "float32" else 2 * lr + 2 * np.spacing(np.abs(w))
        assert (np.abs(g - w) <= limit).all(), (path, float(np.abs(g - w).max()) / lr)
        if np.any(w != old_master[path]):  # where JAX's weights moved, the port's did
            assert not np.array_equal(g, old_master[path]), path
    for path, want, got in leaf_pairs(jnew["params"], tnew["params"]):
        assert str(got.dtype).endswith(str(want.dtype)), path
        w, g = f32(want), to_np(got)
        if dtype == "float32":
            assert np.abs(g - w).max(initial=0.0) <= lr / 2, path
        else:  # the master's two steps, and one bfloat16 ulp of the element
            assert (np.abs(g - w) <= 2 * lr + np.abs(w) * 2.0 ** -7).all(), path
        master = tnew["opt"]["master"]
        for k in path.split("/"):
            master = master[k]
        assert torch.equal(got, master.to(got.dtype)), path
    return tnew, tm
