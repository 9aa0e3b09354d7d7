"""The port's tensor-parallel train step against the JAX package's: each case
runs ``jit_train_step`` under ``MeshRules`` on gloo process groups of CPU
processes, each rank holding its slices of the state (``shard_train_state``),
and JAX's ``jit_train_step`` on the same forced mesh with the state placed
by its specs, from JAX's initial state on the same global batch, at
``reduced_config`` in float32.

* Meshes (data, model): (1, 2) on a world of 2 ranks, (2, 2) on a world of 4.
* Cases: a dense config (Qwen2, its two KV heads split at tp = 2), DBRX
  (MoE: the experts split over the model axis) and RecurrentGemma (its one
  KV head and the RG-LRU mixers replicated, the FFN split).
* Loss, ce, aux and the new state within PR 27's float32 classes
  (``tests/_torch_train_ref.py``), as the data-parallel step is held
  (``tests/test_torch_train_dist.py``).
* ZeRO-1 on is bit-equal to ZeRO-1 off on the same mesh, every rank holding
  the same global state once gathered.
* The conjugate collectives: the gradients of a column-, a row-parallel
  and a gathered product on each mesh's model axis equal the unsharded ones.
* A checkpoint written by ``trainer.train`` at (1, 2) (rank 0 alone, the
  state gathered over both axes) restores at (1, 1) in the port, bit-equal
  in JAX, and a run resumes from it.
* ``host_collectives`` is taken only when asked for.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_dist_ref import start_jax, start_ranks, to_np  # noqa: E402
from _torch_lm_ref import FLAG_KW, assert_close  # noqa: E402
from _torch_train_ref import GRAD_TOL  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import reduced_config as treduced  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.models.runtime import RunFlags  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

CASES = (
    {"name": "dense", "arch": "qwen2-0.5b", "flags": dict(FLAG_KW)},
    {"name": "moe", "arch": "dbrx-132b", "flags": dict(FLAG_KW)},
    {"name": "rglru", "arch": "recurrentgemma-2b", "flags": dict(FLAG_KW)},
)
MESHES = ((1, 2), (2, 2))
B, S = 4, 12
REL = GRAD_TOL["float32"]
CKPT = {"arch": "qwen2-0.5b", "steps": 2, "seq": 12, "batch": 4, "flags": dict(FLAG_KW), "model": 2}
CONJ = {"x": (3, 8), "w1": (8, 16), "w2": (16, 8), "w3": (8, 12)}


def _inputs():
    out = {}
    rng = np.random.default_rng(29)
    for case in CASES:
        cfg = dataclasses.replace(jreduced(jget(case["arch"])), dtype="float32")
        params = jt.init_params(jax.random.key(0), cfg)
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            out[f"{case['name']}/params/" + "/".join(k.key for k in path)] = np.asarray(leaf)
        out[f"{case['name']}/batch/tokens"] = rng.integers(2, cfg.vocab_size, (B, S)).astype(np.int32)
        out[f"{case['name']}/batch/labels"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    for k, shape in CONJ.items():
        out[f"conj/{k}"] = rng.standard_normal(shape).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's outputs, the conjugates' inputs, {world: each rank's
    results}, the (1, 2) trainer's ranks and checkpoint directory); every
    group side by side under its own time limit."""
    tmp = tmp_path_factory.mktemp("tp_train")
    inputs = _inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    spec = {"inputs": str(tmp / "inputs.npz"), "cases": list(CASES), "meshes": [list(m) for m in MESHES]}
    jax_runs = []
    for m in MESHES:  # one JAX process a mesh, side by side
        (tmp / f"m{m[0]}x{m[1]}").mkdir()
        jax_runs.append(start_jax("tp_train", tmp / f"m{m[0]}x{m[1]}", dict(spec, meshes=[list(m)]), timeout=240))
    ranks = {w: start_ranks("tp_train", w, tmp, spec, timeout=240) for w in (2, 4)}
    ckpt_dir = tmp / "ckpt"
    trainer_run = start_ranks("trainer", 2, tmp, dict(CKPT, ckpt_dir=str(ckpt_dir)), timeout=240)
    want = {}
    for g in jax_runs:
        want.update(g.results())
    return want, inputs, {w: g.results() for w, g in ranks.items()}, trainer_run.results(), ckpt_dir


def _tree_scale(want, prefix):
    return max(float(np.abs(v).max()) for k, v in want.items() if k.startswith(prefix) and v.size)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("case", [c["name"] for c in CASES])
def test_tp_train_step_equals_jax_on_the_same_mesh(runs, case, mesh):
    want_all, _, ranks, _, _ = runs
    jtag = f"{case}/{mesh[0]}x{mesh[1]}"
    want = {k[len(jtag) + 1:]: v for k, v in want_all.items() if k.startswith(jtag + "/")}
    ptag = f"{jtag}/zero1=False"
    for res in ranks[mesh[0] * mesh[1]]:
        got = {k[len(ptag) + 1:]: to_np(v) for k, v in res.items()
               if k.startswith(ptag + "/state/") or k.startswith(ptag + "/metrics/")}
        assert sorted(got) == sorted(want)
        for k in ("loss", "ce", "aux"):
            w, g = float(want[f"metrics/{k}"]), float(got[f"metrics/{k}"])
            assert abs(g - w) <= REL * max(abs(w), 1.0), (k, g, w)
        assert float(got["metrics/lr"]) == float(want["metrics/lr"])
        assert int(got["state/step"]) == int(want["state/step"]) == 1
        if case == "moe":
            assert float(got["metrics/aux"]) > 0
        lr = float(want["metrics/lr"])
        for part, rel in (("state/opt/m/", REL), ("state/opt/v/", 2 * REL)):
            scale = _tree_scale(want, part)
            for k in (k for k in want if k.startswith(part)):
                assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
                err = float(np.abs(got[k] - want[k]).max()) if want[k].size else 0.0
                assert err <= rel * scale, f"{k}: {err} > {rel} x {scale}"
        for part in ("state/opt/master/", "state/params/"):
            for k in (k for k in want if k.startswith(part)):
                assert np.abs(got[k] - want[k]).max(initial=0.0) <= lr / 2, k
        calls = res[f"{ptag}/calls"]
        assert calls.get("copy_to_model", 0) > 0 and calls.get("reduce_from_model", 0) > 0, calls


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("case", [c["name"] for c in CASES])
def test_tp_zero1_is_bit_equal_to_zero1_off(runs, case, mesh):
    """ZeRO-1's shards, cut from each rank's model-axis slices and gathered,
    are the unsharded update bit for bit; every rank gathers the same state
    and holds less of it under ZeRO-1."""
    _, _, ranks, _, _ = runs
    off, on = f"{case}/{mesh[0]}x{mesh[1]}/zero1=False/", f"{case}/{mesh[0]}x{mesh[1]}/zero1=True/"
    first = ranks[mesh[0] * mesh[1]][0]
    for res in ranks[mesh[0] * mesh[1]]:
        keys = sorted(k[len(off):] for k in res if k.startswith(off + "state/"))
        assert keys == sorted(k[len(on):] for k in res if k.startswith(on + "state/"))
        for k in keys:
            assert torch.equal(res[off + k], res[on + k]), k
            assert torch.equal(res[on + k], first[on + k]), k
        if mesh[0] > 1:
            assert res[on + "local_numel"] < res[off + "local_numel"]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_gradients_through_each_conjugate_equal_tp1(runs, mesh):
    _, inputs, ranks, _, _ = runs
    from repro_torch.dist import collectives

    leaves = [torch.from_numpy(inputs[f"conj/{k}"]).requires_grad_(True) for k in CONJ]
    x, w1, w2, w3 = leaves
    z = (torch.tanh(x @ w1) @ w2) @ w3
    loss = torch.sum(z * z)
    loss.backward()
    assert collectives.copy_to_model(x, None) is x  # a model axis of one: the identities
    tag, tp = f"conj/{mesh[0]}x{mesh[1]}", mesh[1]
    n1, n3 = w1.shape[1] // tp, w3.shape[1] // tp
    for res in ranks[mesh[0] * mesh[1]]:
        r = res[f"{tag}/index"]
        assert torch.allclose(res[f"{tag}/loss"], loss.detach(), rtol=1e-6)
        # float32 sums in another order: within 1e-5 of each gradient's largest entry
        for k, want in (("x", x.grad), ("w1", w1.grad[:, r * n1:(r + 1) * n1]), ("w2", w2.grad[r * n1:(r + 1) * n1]),
                        ("w3", w3.grad[:, r * n3:(r + 1) * n3])):
            assert_close(to_np(want), to_np(res[f"{tag}/grad/{k}"]), 1e-5, f"{tag} gradient of {k}")


def test_checkpoint_at_tp2_restores_at_tp1_and_in_jax(runs):
    _, _, _, trainer_ranks, ckpt_dir = runs
    assert tckpt.latest_step(str(ckpt_dir)) == CKPT["steps"]
    h0 = [h["loss"] for h in trainer_ranks[0]["history"]]
    assert all(np.isfinite(h0)) and [h["loss"] for h in trainer_ranks[1]["history"]] == h0
    cfg = treduced(tget(CKPT["arch"]))
    template = tsteps.train_state_shape(cfg, topt.AdamWConfig())
    state, step, extra = tckpt.restore(str(ckpt_dir), template, device="cpu")
    assert step == CKPT["steps"] and extra == {"data_step": CKPT["steps"]}
    full = sum(x.numel() for x in topt.tree_leaves(state["opt"]))
    assert trainer_ranks[0]["opt_numel"] < full  # the ranks held slices; the checkpoint the whole state
    jcfg = jreduced(jget(CKPT["arch"]))
    jtemplate = jax.eval_shape(lambda: jsteps.make_train_state(jt.init_params(jax.random.key(0), jcfg),
                                                               jsteps.AdamWConfig()))
    jstate, jstep, _ = jckpt.restore(str(ckpt_dir), jtemplate)
    assert jstep == step
    for path, leaf in jax.tree_util.tree_flatten_with_path(jstate)[0]:
        node = state
        for k in path:
            node = node[k.key]
        w = np.asarray(leaf)
        got = node.view(torch.int16).numpy().view(np.uint16) if node.dtype == torch.bfloat16 else node.numpy()
        assert np.array_equal(got, w.view(np.uint16) if w.dtype.name == "bfloat16" else w), path
    # the same run at (1, 1), rules-free: the same data, the same losses within the bfloat16 step's class ...
    data = DataConfig(cfg.vocab_size, CKPT["seq"], CKPT["batch"])
    flags = RunFlags(**CKPT["flags"])
    kw = dict(log_every=1, schedule_steps=50, ckpt_every=100)
    one = ttrainer.train(cfg, data, ttrainer.TrainLoopConfig(steps=CKPT["steps"], **kw), flags, device="cpu")
    for a, b in zip(h0, [h["loss"] for h in one["history"]]):
        assert abs(a - b) <= 2.0 ** -8 * abs(b), (a, b)
    # ... and resuming the (1, 2) checkpoint at (1, 1) continues from its step
    rerun = ttrainer.train(cfg, data, ttrainer.TrainLoopConfig(steps=CKPT["steps"] + 1, ckpt_dir=str(ckpt_dir), **kw),
                           flags, device="cpu")
    assert rerun["resumed_from"] == CKPT["steps"] and [h["step"] for h in rerun["history"]] == [CKPT["steps"] + 1]


def test_host_collectives_only_when_asked(tmp_path):
    """A gloo group takes a CUDA tensor only once ``stage_through_host``
    registered it, which ``make_host_mesh`` does only under
    ``host_collectives=True``; that flag needs a CUDA device and a gloo
    process group."""
    import types

    import torch.distributed as dist

    from repro_torch.dist import collectives
    from repro_torch.launch.mesh import make_host_mesh

    cuda = types.SimpleNamespace(device=torch.device("cuda"))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdzv'}", world_size=1, rank=0)
    try:
        mesh = make_host_mesh(device="cpu")
        for axis in mesh.axis_names:
            group = mesh.group(axis)
            assert not collectives.host_staged(group)
            with pytest.raises(RuntimeError, match="a cuda tensor on a gloo process group"):
                collectives._checked(group, cuda)
        with pytest.raises(ValueError, match="host_collectives"):
            make_host_mesh(device="cpu", host_collectives=True)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make_host_mesh(host_collectives=True)
        group = mesh.group("model")
        collectives.stage_through_host(group)
        assert collectives.host_staged(group) and collectives._checked(group, cuda) is group
        with pytest.raises(ValueError, match="does not divide"):
            make_host_mesh(3, device="cpu")
    finally:
        dist.destroy_process_group()
    assert not collectives.host_staged(group)
