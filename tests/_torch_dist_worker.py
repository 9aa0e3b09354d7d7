"""One rank of the port's distribution tests, run as a process of its own:
``python tests/_torch_dist_worker.py JOB SPEC.json WORLD RANK``.

It joins a gloo process group of WORLD ranks through a file rendezvous in
the test's temporary directory (``spec["rdzv"]``), builds the host mesh on
the CPU, runs the job and writes its results, keyed by case, to
``{spec["out"]}/rank{RANK}.pt``.  Jobs:

* ``collectives`` — the four collectives of ``repro_torch.dist.collectives``
  on this rank's shards of the inputs, mesh (1, WORLD).
* ``train`` — for each case, ``make_train_step`` under ``MeshRules`` of a
  (WORLD, 1) mesh with ZeRO-1 off and on, from JAX's initial state; the
  states gathered to the global layout.
* ``trainer`` — ``trainer.train`` on a (WORLD / model, model) mesh
  (``spec["model"]``, 1 by default) with ZeRO-1 and a checkpoint directory.
* ``tp_serve`` — for each mesh of the spec with WORLD ranks and each case:
  the prefill and decode steps under its ``MeshRules`` on this rank's
  slices of JAX's weights (``shard_params``), the cache gathered to the
  global layout and its shapes at rest; the same steps without rules on
  rank 0; and each quantized linear of block 0 sharded against unsharded.
* ``tp_train`` — for each mesh of the spec with WORLD ranks and each case,
  ``jit_train_step`` with ZeRO-1 off and on from JAX's initial state, the
  new state gathered; and the gradients through each conjugate collective.
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.dist import collectives as tc  # noqa: E402
from repro_torch.dist.sharding import MeshRules  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402


def unflatten(flat, prefix):
    """The nested dict of the ``prefix/...`` keys of a flat npz mapping."""
    tree = {}
    for key, arr in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        *parents, leaf = key[len(prefix) + 1:].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = torch.from_numpy(np.array(arr))
    return tree


def flatten(tree, prefix):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree.detach().clone()}


def bits(tree):
    """A tree whose bfloat16 leaves came as their uint16 bits."""
    if isinstance(tree, dict):
        return {k: bits(v) for k, v in tree.items()}
    return tree.view(torch.bfloat16) if tree.dtype == torch.uint16 else tree


def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def meshes_of(spec, world):
    return [tuple(m) for m in spec["meshes"] if m[0] * m[1] == world]


def collectives(spec, inputs, world, rank):
    mesh = make_host_mesh(world, device="cpu")
    n = mesh.shape["model"]
    out = {"backend": str(dist.get_backend(mesh.group("model")))}
    tc.reset_call_counts()
    for key in sorted(k for k in inputs if k.startswith(f"n{n}/")):
        case, x = key.split("/", 1)[1], torch.from_numpy(inputs[key])
        if case.startswith("htree"):
            m = x.shape[0] // n
            out[key] = tc.htree_allreduce(x[rank * m:(rank + 1) * m], mesh, "model")
        elif case == "ring_a":
            w = torch.from_numpy(inputs[f"n{n}/ring_w"])
            ka, kw = x.shape[1] // n, w.shape[0] // n
            out[f"n{n}/ring"] = tc.ring_allgather_matmul(x[:, rank * ka:(rank + 1) * ka],
                                                         w[rank * kw:(rank + 1) * kw], mesh, "model")
        elif case.startswith("comp_g"):
            tag = case[len("comp_g"):]
            err = torch.from_numpy(inputs[f"n{n}/comp_e{tag}"])
            axes = ("model",) if tag == "1" else ("data", "model")
            out[f"n{n}/comp_red{tag}"], out[f"n{n}/comp_err{tag}"] = tc.compressed_psum_with_feedback(
                x, err, mesh, axes)
            out[f"n{n}/comp_q{tag}"] = tc.quantize_int8(x + err)[0]
        elif case.startswith("shuffle"):
            dim = int(case.rsplit("_d", 1)[1])
            c = x.shape[dim] // n
            out[key] = tc.shuffle(x.narrow(dim, rank * c, c), mesh, "model", split_dim=dim)
    out["calls"] = tc.call_counts()
    return out


def train(spec, inputs, world, rank):
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models.runtime import RunFlags
    from repro_torch.train import steps
    from repro_torch.train.optimizer import AdamWConfig, tree_map

    rules = MeshRules.from_mesh(make_host_mesh(1, device="cpu"))
    out = {}
    for case in spec["cases"]:
        cfg = dataclasses.replace(reduced_config(get_config(case["arch"])), dtype="float32")
        batch = {k: torch.from_numpy(inputs[f"{case['name']}/batch/{k}"]) for k in ("tokens", "labels")}
        params = unflatten(inputs, f"{case['name']}/params")
        for zero1 in (False, True):
            flags = RunFlags(**case["flags"], zero1=zero1)
            specs = steps.train_state_specs(cfg, rules, AdamWConfig(), flags)
            state = steps.make_train_state(tree_map(torch.clone, params), AdamWConfig())
            if zero1:
                state = steps.shard_train_state(state, specs, rules)
                local = sum(x.numel() for k in ("m", "v", "master") for x in steps.tree_leaves(state["opt"][k]))
            new, metrics = steps.make_train_step(cfg, flags, rules)(state, batch)
            if zero1:
                out[f"{case['name']}/zero1_opt_numel"] = local
                new = steps.gather_train_state(new, specs, rules)
            tag = f"{case['name']}/dp{world}/zero1={zero1}"
            out.update(flatten(new, f"{tag}/state"))
            out.update(flatten(metrics, f"{tag}/metrics"))
    return out


def trainer(spec, inputs, world, rank):
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.runtime import RunFlags
    from repro_torch.train import trainer as ttrainer
    from repro_torch.train.optimizer import tree_leaves

    rules = MeshRules.from_mesh(make_host_mesh(spec.get("model", 1), device="cpu"))
    cfg = reduced_config(get_config(spec["arch"]))
    loop = ttrainer.TrainLoopConfig(steps=spec["steps"], ckpt_every=spec["steps"], ckpt_dir=spec["ckpt_dir"],
                                    log_every=1, schedule_steps=50)
    run = ttrainer.train(cfg, DataConfig(cfg.vocab_size, spec["seq"], spec["batch"]), loop,
                         RunFlags(**spec["flags"], zero1=True), rules=rules, device="cpu")
    return {"history": run["history"], "opt_numel": sum(x.numel() for x in tree_leaves(run["state"]["opt"]))}


def _serve_run(cfg, flags, params, batch, feed, rules, max_len):
    from repro_torch.serve import engine

    out = {}
    with torch.no_grad():
        cache, out["prefill"] = engine.make_prefill_step(cfg, flags, rules, max_len=max_len)(params, batch)
        dec = engine.make_decode_step(cfg, flags, rules)
        for i in range(feed.shape[0]):
            cache, out[f"decode{i}"] = dec(params, cache, feed[i])
    return cache, out


def _tp_linear_checks(cfg, params, local, rules):
    """Each quantized linear of block 0 (and the head), sharded, against the
    unsharded one on the same input: True where bit-equal."""
    from repro_torch.dist import sharding
    from repro_torch.kernels.api import PrecisionSpec
    from repro_torch.models import common

    ms = sharding.model_shard(rules)
    g = torch.Generator().manual_seed(5)
    out = {}
    layers = [(("attn", "wq"), cfg.d_model, cfg.q_dim), (("attn", "wk"), cfg.d_model, cfg.kv_dim),
              (("attn", "wo"), cfg.q_dim, cfg.d_model), (("ffn", "w_gate"), cfg.d_model, cfg.d_ff),
              (("ffn", "w_down"), cfg.d_ff, cfg.d_model)]
    cases = [(params["blocks"][b].get(sub, {}).get(name), local["blocks"][b].get(sub, {}).get(name),
              f"{b}.{sub}.{name}", d_in, d_out)
             for b in sorted(params["blocks"]) for (sub, name), d_in, d_out in layers]
    cases = [(p, lp, what, d_in, d_out) for p, lp, what, d_in, d_out in cases if isinstance(p, dict) and "w_q" in p]
    if "lm_head" in params and "w_q" in params["lm_head"]:
        cases.append((params["lm_head"], local["lm_head"], "lm_head", cfg.d_model, cfg.padded_vocab()))
    for p, lp, what, d_in, d_out in cases:
        if p["w_q"].dim() == 3:  # a stack over pattern groups: group 0
            p, lp = ({k: v[0] for k, v in t.items()} for t in (p, lp))
        x = torch.randn((2, 3, d_in), generator=g).to(common.dtype_of(cfg))
        for spec in (None, PrecisionSpec.w8a16):  # one slice pair (the model's), and two (api.matmul)
            with torch.no_grad():
                want = common.linear(p, x, spec)
                got = common.tp_gathered(common.tp_linear(lp, x, ms, d_in, d_out, spec), ms, d_out)
            out[what if spec is None else f"{what} w8a16"] = bool(torch.equal(got, want))
    return out


def tp_serve(spec, inputs, world, rank):
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.dist import collectives as dc
    from repro_torch.dist import sharding
    from repro_torch.models import transformer as tt
    from repro_torch.models.runtime import RunFlags
    from repro_torch.serve import engine

    out = {}
    for shape in meshes_of(spec, world):
        rules = MeshRules.from_mesh(make_host_mesh(shape[1], device="cpu"))
        tag_mesh = f"{shape[0]}x{shape[1]}"
        for case in spec["cases"]:
            name = case["name"]
            cfg = dataclasses.replace(reduced_config(get_config(case["arch"])), dtype=case["dtype"])
            flags = RunFlags(**case["flags"])
            params = bits(unflatten(inputs, f"{name}/params"))
            batch = bits(unflatten(inputs, f"{name}/batch"))
            feed = torch.from_numpy(inputs[f"{name}/feed"])
            if list(shape) not in [list(m) for m in case["meshes"]]:
                continue
            if rank == 0 and f"{name}/ref/prefill" not in out:
                _, ref = _serve_run(cfg, flags, params, batch, feed, None, spec["max_len"])
                out.update({f"{name}/ref/{k}": v for k, v in ref.items()})
            tag = f"{name}/{tag_mesh}"
            local = sharding.shard_params(params, cfg, rules)
            whole = sharding.gather_params(local, cfg, rules)
            out[f"{tag}/gathered_equal"] = all(torch.equal(a, b) for a, b in zip(leaves(whole), leaves(params)))
            dc.reset_call_counts()
            cache, got = _serve_run(cfg, flags, local, batch, feed, rules, spec["max_len"])
            out[f"{tag}/calls"] = dc.call_counts()
            out.update({f"{tag}/{k}": v for k, v in got.items()})
            out[f"{tag}/seq_sharded"] = sorted(f"{b}/{n}" for b, e in cache.get("seq_sharded", {}).items() for n in e)
            empty = tt.init_cache(cfg, batch["tokens"].shape[0], spec["max_len"], flags, device="cpu", rules=rules)
            out[f"{tag}/init_cache_layout"] = (
                sorted(f"{b}/{n}" for b, e in empty.get("seq_sharded", {}).items() for n in e),
                {f"{b}/{n}": tuple(x.shape) for b, e in empty["blocks"].items() for n, x in e.items()})
            specs = engine.cache_specs(cfg, batch["tokens"].shape[0], spec["max_len"], rules, flags)
            for b, entry in cache["blocks"].items():
                for n, leaf in entry.items():
                    out[f"{tag}/rest/{b}/{n}"] = tuple(leaf.shape)
                    out[f"{tag}/cache/{b}/{n}"] = sharding.gather_leaf(leaf, specs["blocks"][b][n], rules)
            if flags.quant_serve:
                out[f"{tag}/int32_equal"] = _tp_linear_checks(cfg, params, local, rules)
    return out


class _Conjugates:
    """``y = gather(row(col(x)) · c)`` of a small two-layer product, for the
    conjugates' gradients: ``col`` a column-parallel, ``row`` a
    row-parallel linear, ``c`` a column slice, the vocabulary-style gather
    last; the sum of squares is the loss."""

    @staticmethod
    def run(x, w1, w2, w3, ms):
        from repro_torch.dist import collectives as dc

        h = torch.tanh(dc.copy_to_model(x, ms) @ w1)  # column-parallel: this rank's columns
        y = dc.reduce_from_model(h @ w2, ms)  # row-parallel: partial sums added
        z = dc.gather_from_model(dc.copy_to_model(y, ms) @ w3, -1, ms)  # column-parallel, gathered
        return torch.sum(z * z)


def tp_train(spec, inputs, world, rank):
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.dist import collectives as dc
    from repro_torch.dist import sharding
    from repro_torch.models.runtime import RunFlags
    from repro_torch.train import steps
    from repro_torch.train.optimizer import AdamWConfig, tree_map

    out = {}
    for shape in meshes_of(spec, world):
        rules = MeshRules.from_mesh(make_host_mesh(shape[1], device="cpu"))
        tag_mesh = f"{shape[0]}x{shape[1]}"
        for case in spec["cases"]:
            cfg = dataclasses.replace(reduced_config(get_config(case["arch"])), dtype="float32")
            batch = {k: torch.from_numpy(inputs[f"{case['name']}/batch/{k}"]) for k in ("tokens", "labels")}
            params = unflatten(inputs, f"{case['name']}/params")
            for zero1 in (False, True):
                flags = RunFlags(**case["flags"], zero1=zero1)
                step, specs = steps.jit_train_step(cfg, rules, flags, donate=False)
                state = steps.shard_train_state(steps.make_train_state(tree_map(torch.clone, params), AdamWConfig()),
                                                specs, rules)
                dc.reset_call_counts()
                new, metrics = step(state, batch)
                tag = f"{case['name']}/{tag_mesh}/zero1={zero1}"
                out[f"{tag}/calls"] = dc.call_counts()
                out[f"{tag}/local_numel"] = sum(x.numel() for x in steps.tree_leaves(new))
                out.update(flatten(steps.gather_train_state(new, specs, rules), f"{tag}/state"))
                out.update(flatten(metrics, f"{tag}/metrics"))
        ms = sharding.model_shard(rules)  # the conjugates' gradients on this mesh's model axis
        x, w1, w2, w3 = (torch.from_numpy(inputs[f"conj/{k}"]) for k in ("x", "w1", "w2", "w3"))
        n1, n3 = w1.shape[1] // ms.tp, w3.shape[1] // ms.tp
        i = ms.index
        live = [t.clone().requires_grad_(True)
                for t in (x, w1[:, i * n1:(i + 1) * n1], w2[i * n1:(i + 1) * n1], w3[:, i * n3:(i + 1) * n3])]
        loss = _Conjugates.run(*live, ms)
        loss.backward()
        out[f"conj/{tag_mesh}/index"] = i
        out[f"conj/{tag_mesh}/loss"] = loss.detach()
        for k, t in zip(("x", "w1", "w2", "w3"), live):
            out[f"conj/{tag_mesh}/grad/{k}"] = t.grad
    return out


if __name__ == "__main__":
    job, spec_path, world, rank = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
    spec = json.loads(Path(spec_path).read_text())
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{spec['rdzv']}", world_size=world, rank=rank)
    inputs = dict(np.load(spec["inputs"])) if spec.get("inputs") else {}
    result = {"collectives": collectives, "train": train, "trainer": trainer, "tp_serve": tp_serve,
              "tp_train": tp_train}[job](spec, inputs, world, rank)
    torch.save(result, Path(spec["out"]) / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()
