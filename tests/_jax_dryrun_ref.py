"""The JAX package's side of the dry-run tests
(``tests/test_torch_launch_dryrun.py``), run as a process of its own:
``python tests/_jax_dryrun_ref.py SPEC.json OUT.json``.

``--xla_force_host_platform_device_count`` is set before JAX is imported,
for the small meshes of the spec; ``repro.launch.dryrun`` (which sets
``XLA_FLAGS`` to 512 devices when imported) is imported only after JAX has
started, so its flag reaches no backend.  Writes one JSON object:

* ``model_flops``: ``dryrun._model_flops_per_device`` of every arch × shape
  × production mesh size;
* ``cells``: for each reduced arch × cell × flags × mesh of the spec, what
  JAX's ``lower_cell`` records of it (status, skip reason, the sharding
  decisions of its input specs and of tracing the step and its 1- and
  2-group variants, the analytic memory);
* ``memory``: ``memory_analysis()`` of the compiled steps of the spec's
  ``memory_arch`` at its ``memory_mesh``, argument and output bytes a device.
"""
import dataclasses
import json
import os
import sys

spec = json.loads(open(sys.argv[1]).read())
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={spec['devices']}"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

assert len(jax.devices()) == spec["devices"], jax.devices()

from repro.configs import SHAPES, cell_supported, get_config, list_archs, reduced_config  # noqa: E402
from repro.configs.base import ShapeCell  # noqa: E402
from repro.dist.sharding import MeshRules  # noqa: E402
from repro.launch import dryrun  # noqa: E402
from repro.launch.memory_model import analytic_memory  # noqa: E402
from repro.models.runtime import RunFlags  # noqa: E402

out = {"model_flops": {}, "cells": {}, "memory": {}}
for arch in list_archs():
    cfg = get_config(arch)
    for cell in SHAPES:
        for n in (256, 512):
            out["model_flops"][f"{arch}/{cell.name}/{n}"] = dryrun._model_flops_per_device(cfg, cell, n)


def make_mesh(shape):
    """A ("data", "model") mesh of the first devices, its axes of JAX's
    default (auto) type, as ``tests/_jax_dist_ref.py`` makes them:
    ``jax.make_mesh`` in this JAX gives explicit axes, under which the
    model's embedding gather does not trace."""
    n = shape[0] * shape[1]
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))


def trace(cfg, cell, rules, flags):
    """Trace the step on its sharded specs, as ``lower_cell`` does before it
    lowers (the rules note their fallbacks while the step traces)."""
    step, args, specs = dryrun._build_step_args(cfg, cell, rules, flags)
    jax.jit(step).trace(*args)
    return specs


for case in spec["cells"]:
    cfg = reduced_config(get_config(case["arch"]))
    cell = ShapeCell(*case["cell"])
    flags = RunFlags(**case["flags"])
    mesh = make_mesh(tuple(case["mesh"]))
    rec = {}
    ok, why = cell_supported(cfg, cell)
    if not ok:
        rec.update(status="skipped", reason=why)
    else:
        rules = MeshRules.from_mesh(mesh)
        with mesh:
            specs = trace(cfg, cell, rules, flags)
            if case.get("groups"):  # _scan_corrected_costs' 1- and 2-group variants
                plen = len(cfg.block_pattern)
                for k in (1, 2):
                    small = dataclasses.replace(cfg, n_layers=plen * k, n_enc_layers=(k if cfg.n_enc_layers else 0))
                    trace(small, cell, rules, dataclasses.replace(flags, scan_layers=False))
        mem = analytic_memory(cfg, cell, rules, flags, specs)
        mem.pop("fits_v5e_16g")
        rec.update(status="ok", sharding_decisions=list(rules.decisions), analytic=mem)
    out["cells"][case["key"]] = rec

if spec.get("memory_arch"):
    cfg = reduced_config(get_config(spec["memory_arch"]))
    mesh = make_mesh(tuple(spec["memory_mesh"]))
    for c in spec["memory_cells"]:
        cell = ShapeCell(*c)
        rules = MeshRules.from_mesh(mesh)
        step, args, _ = dryrun._build_step_args(cfg, cell, rules, RunFlags())
        with mesh:
            m = jax.jit(step).lower(*args).compile().memory_analysis()
        out["memory"][cell.kind] = {"argument": m.argument_size_in_bytes, "output": m.output_size_in_bytes}

with open(sys.argv[2], "w") as f:
    json.dump(out, f)
