"""Shared helpers of the port's sharding-spec tests
(``tests/test_torch_dist_sharding.py``, ``tests/test_torch_launch_specs.py``):
the five meshes, both packages' rules over them, the JAX package's
``jax.eval_shape`` trees cached (pure functions of their hashable
arguments, so each config is traced once a module), and spec-tree
comparison.

JAX's rules take a ``jax.sharding.AbstractMesh`` (its ``NamedSharding``
needs a mesh, and no devices are forced here); the port's a
``launch.mesh.MeshDescription`` or a fake with only ``.shape`` and
``.axis_names``, as JAX's own tests use.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.dist.sharding import MeshRules as JRules
from repro.models import transformer as jt
from repro.models.runtime import RunFlags as JFlags
from repro.serve import engine as jengine
from repro.train import steps as jsteps
from repro_torch.dist.sharding import MeshRules as TRules
from repro_torch.launch.mesh import MeshDescription
from repro_torch.models.runtime import RunFlags as TFlags
from repro_torch.serve import engine as tengine
from repro_torch.train import steps as tsteps

MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "4x4": {"data": 4, "model": 4},
    "8x1": {"data": 8, "model": 1},
    "1x1": {"data": 1, "model": 1},
}


class FakeMesh:
    """Only ``.shape`` and ``.axis_names``, as ``tests/test_dist.py``'s."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def rules_pair(mesh: str, fake: bool = False):
    """(JAX's MeshRules, the port's) from the same mesh."""
    shape = MESHES[mesh]
    port_mesh = FakeMesh(shape) if fake else MeshDescription(tuple(shape.values()), tuple(shape))
    return (JRules.from_mesh(AbstractMesh(tuple(shape.values()), tuple(shape))), TRules.from_mesh(port_mesh))


@pytest.fixture(scope="module", autouse=True)
def cached_shapes():
    """Both packages' shape trees made once a config in each module: JAX
    traces them, the port runs its ops on ``meta`` (the quantization's
    decompositions take seconds at full size)."""
    mp = pytest.MonkeyPatch()
    for mod, name in ((jsteps, "train_state_shape"), (jt, "params_shape"), (jengine, "cache_shape"),
                      (tsteps, "train_state_shape")):
        mp.setattr(mod, name, functools.lru_cache(maxsize=None)(getattr(mod, name)))
    # the serving parameters depend on the flags only through quant_serve
    for mod, flags in ((jengine, JFlags), (tengine, TFlags)):
        serve_shape = functools.lru_cache(maxsize=None)(
            lambda cfg, quant, f=mod.serve_params_shape, flags=flags: f(cfg, flags(quant_serve=quant)))
        mp.setattr(mod, "serve_params_shape",
                   lambda cfg, fl=flags(), s=serve_shape: s(cfg, fl.quant_serve))
    yield
    mp.undo()


def spec_leaves(tree, path=()):
    """(path, spec entries as a tuple) of a dict tree of specs, sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from spec_leaves(tree[k], path + (k,))
    else:
        yield path, tuple(tree)


def assert_specs_equal(want, got, what):
    w, g = list(spec_leaves(want)), list(spec_leaves(got))
    assert [p for p, _ in w] == [p for p, _ in g], what
    for (path, ws), (_, gs) in zip(w, g):
        assert gs == ws, f"{what} {'/'.join(path)}: {gs} != JAX's {ws}"


def sds_leaves(tree, path=()):
    """(path, shape, dtype name, spec) of a tree of JAX ShapeDtypeStructs or
    of the port's ``meta`` tensors (``.spec``), sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from sds_leaves(tree[k], path + (k,))
        return
    if hasattr(tree, "sharding"):
        spec = tree.sharding.spec if tree.sharding is not None else None
        yield path, tuple(tree.shape), np.dtype(tree.dtype).name, None if spec is None else tuple(spec)
    else:
        spec = getattr(tree, "spec", None)
        yield path, tuple(tree.shape), str(tree.dtype).replace("torch.", ""), None if spec is None else tuple(spec)
