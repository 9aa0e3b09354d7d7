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
* ``trainer`` — ``trainer.train`` at dp = WORLD with ZeRO-1 and a
  checkpoint directory.
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

    rules = MeshRules.from_mesh(make_host_mesh(1, device="cpu"))
    cfg = reduced_config(get_config(spec["arch"]))
    loop = ttrainer.TrainLoopConfig(steps=spec["steps"], ckpt_every=spec["steps"], ckpt_dir=spec["ckpt_dir"],
                                    log_every=1, schedule_steps=50)
    run = ttrainer.train(cfg, DataConfig(cfg.vocab_size, spec["seq"], spec["batch"]), loop,
                         RunFlags(**spec["flags"], zero1=True), rules=rules, device="cpu")
    return {"history": run["history"], "opt_numel": sum(x.numel() for x in tree_leaves(run["state"]["opt"]))}


if __name__ == "__main__":
    job, spec_path, world, rank = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
    spec = json.loads(Path(spec_path).read_text())
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{spec['rdzv']}", world_size=world, rank=rank)
    inputs = dict(np.load(spec["inputs"])) if spec.get("inputs") else {}
    result = {"collectives": collectives, "train": train, "trainer": trainer}[job](spec, inputs, world, rank)
    torch.save(result, Path(spec["out"]) / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()
