"""The JAX side of the port's distribution tests, run as a script of its own
(``python tests/_jax_dist_ref.py JOB SPEC.json OUT.npz``) so that
``XLA_FLAGS=--xla_force_host_platform_device_count`` is set before JAX is
imported (``tests/conftest.py``: never globally).  Every job reads its
inputs from the spec's ``.npz`` and writes JAX's outputs, keyed by case, to
``OUT.npz``.

* ``collectives`` — the four collectives of ``repro.dist.collectives`` on a
  forced (1, n) ("data", "model") mesh for each world size n of the spec.
* ``train`` — one ``make_train_step`` under ``MeshRules.from_mesh`` of a
  forced (dp, 1) mesh, jitted, for each (config, flags, dp) of the spec.
* ``tp_serve`` — for each case and mesh of the spec: the prefill step and
  the decode steps of ``serve.engine`` under ``MeshRules.from_mesh`` of the
  forced mesh, jitted, the parameters placed by ``param_specs``; float32
  cases only (bfloat16 runs op by op in the test's own process).
* ``tp_train`` — ``jit_train_step`` of each case on each forced mesh of the
  spec, the state placed by its specs.
"""
import json
import os
import sys

N_DEVICES = 8
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={N_DEVICES}"

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402


def _mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def collectives(spec, inputs):
    from repro.dist import collectives as jc

    out = {}
    for n in spec["worlds"]:
        mesh = _mesh((1, n), ("data", "model"))
        for key in (k for k in inputs if k.startswith(f"n{n}/")):
            case, arr = key.split("/", 1)[1], inputs[key]
            if case.startswith("htree"):
                out[key] = jc.htree_allreduce(jnp.asarray(arr), mesh, "model")
            elif case == "ring_a":
                out[f"n{n}/ring"] = jc.ring_allgather_matmul(
                    jnp.asarray(arr), jnp.asarray(inputs[f"n{n}/ring_w"]), mesh, "model")
            elif case.startswith("comp_g"):
                tag = case[len("comp_g"):]
                g, err = jnp.asarray(arr), jnp.asarray(inputs[f"n{n}/comp_e{tag}"])
                axes = ("model",) if tag == "1" else ("data", "model")
                red, new_err = jc.compressed_psum_with_feedback(g, err, mesh, axes)
                out[f"n{n}/comp_red{tag}"], out[f"n{n}/comp_err{tag}"] = red, new_err
                # the int8 payload of collectives.py's quantization, its ops on the same x
                x = g + err
                scale = jnp.maximum(jnp.max(jnp.abs(x)), 1e-30) / 127.0
                out[f"n{n}/comp_q{tag}"] = jnp.clip(jnp.round(x / scale), -127, 127).astype(jnp.int8)
            elif case.startswith("shuffle"):
                dim = int(case.rsplit("_d", 1)[1])
                out[key] = jc.shuffle(jnp.asarray(arr), mesh, "model", split_dim=dim)
    return out


def train(spec, inputs):
    from repro.configs import get_config, reduced_config
    from repro.dist.sharding import MeshRules
    from repro.models import transformer as jt
    from repro.models.runtime import RunFlags
    from repro.train import steps as js

    out = {}
    for case in spec["cases"]:
        cfg = dataclasses.replace(reduced_config(get_config(case["arch"])), dtype="float32")
        flags = RunFlags(**case["flags"])
        params = jt.init_params(jax.random.key(0), cfg)
        state = js.make_train_state(params, js.AdamWConfig())
        batch = {k: jnp.asarray(inputs[f"{case['name']}/batch/{k}"]) for k in ("tokens", "labels")}
        for dp in spec["dps"]:
            mesh = _mesh((dp, 1), ("data", "model"))
            rules = MeshRules.from_mesh(mesh)
            with mesh:
                new, metrics = jax.jit(js.make_train_step(cfg, flags, rules))(state, batch)
            tag = f"{case['name']}/dp{dp}"
            for path, leaf in jax.tree_util.tree_flatten_with_path(new)[0]:
                out[f"{tag}/state/" + "/".join(k.key for k in path)] = leaf
            for k, v in metrics.items():
                out[f"{tag}/metrics/{k}"] = v
    return out


def _placed(tree, specs, mesh):
    from jax.sharding import NamedSharding, PartitionSpec

    return jax.device_put(tree, jax.tree_util.tree_map(lambda sp: NamedSharding(mesh, sp), specs,
                                                       is_leaf=lambda x: isinstance(x, PartitionSpec)))


def tp_serve(spec, inputs):
    from repro.configs import get_config, reduced_config
    from repro.dist.sharding import MeshRules, param_specs
    from repro.models import common as jc
    from repro.models import transformer as jt
    from repro.models.runtime import RunFlags
    from repro.serve import engine

    out = {}
    for case in spec["cases"]:
        cfg = dataclasses.replace(reduced_config(get_config(case["arch"])), dtype="float32")
        flags = RunFlags(**case["flags"])
        params = jt.init_params(jax.random.key(0), cfg)
        if flags.quant_serve:
            params = jc.maybe_quantize_tree(params, cfg)
        name = case["name"]
        batch = {k[len(name) + 7:]: jnp.asarray(v) for k, v in inputs.items() if k.startswith(f"{name}/batch/")}
        feed = inputs[f"{name}/feed"]
        for shape in case["meshes"]:
            if tuple(shape) not in [tuple(m) for m in spec["meshes"]]:
                continue
            mesh = _mesh(tuple(shape), ("data", "model"))
            rules = MeshRules.from_mesh(mesh)
            with mesh:
                placed = _placed(params, param_specs(params, cfg, rules), mesh)
                cache, logits = jax.jit(engine.make_prefill_step(cfg, flags, rules, max_len=spec["max_len"]))(
                    placed, batch)
                tag = f"{name}/{shape[0]}x{shape[1]}"
                out[f"{tag}/prefill"] = logits
                dec = jax.jit(engine.make_decode_step(cfg, flags, rules))
                for i in range(feed.shape[0]):
                    cache, logits = dec(placed, cache, jnp.asarray(feed[i]))
                    out[f"{tag}/decode{i}"] = logits
                for path, leaf in jax.tree_util.tree_flatten_with_path(cache["blocks"])[0]:
                    out[f"{tag}/cache/" + "/".join(k.key for k in path)] = leaf
    return out


def tp_train(spec, inputs):
    from repro.configs import get_config, reduced_config
    from repro.dist.sharding import MeshRules
    from repro.models import transformer as jt
    from repro.models.runtime import RunFlags
    from repro.train import steps as js

    out = {}
    for case in spec["cases"]:
        cfg = dataclasses.replace(reduced_config(get_config(case["arch"])), dtype="float32")
        flags = RunFlags(**case["flags"])
        state = js.make_train_state(jt.init_params(jax.random.key(0), cfg), js.AdamWConfig())
        batch = {k: jnp.asarray(inputs[f"{case['name']}/batch/{k}"]) for k in ("tokens", "labels")}
        for shape in spec["meshes"]:
            mesh = _mesh(tuple(shape), ("data", "model"))
            rules = MeshRules.from_mesh(mesh)
            with mesh:
                step, sspecs = js.jit_train_step(cfg, rules, flags, donate=False)
                new, metrics = step(_placed(state, sspecs, mesh), batch)
            tag = f"{case['name']}/{shape[0]}x{shape[1]}"
            for path, leaf in jax.tree_util.tree_flatten_with_path(new)[0]:
                out[f"{tag}/state/" + "/".join(k.key for k in path)] = leaf
            for k, v in metrics.items():
                out[f"{tag}/metrics/{k}"] = v
    return out


if __name__ == "__main__":
    job, spec_path, out_path = sys.argv[1:4]
    spec = json.loads(open(spec_path).read())
    inputs = dict(np.load(spec["inputs"]))
    results = {"collectives": collectives, "train": train, "tp_serve": tp_serve, "tp_train": tp_train}[job](
        spec, inputs)
    np.savez(out_path, **{k: np.asarray(v) for k, v in results.items()})
    print("JAX_DIST_OK", len(results))
