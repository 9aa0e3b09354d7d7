"""The port's data-parallel train step against the JAX package's: each case
runs ``make_train_step`` under ``MeshRules`` on a gloo process group of dp
CPU processes (a (dp, 1) host mesh) and JAX's jitted step under
``MeshRules.from_mesh`` of a forced (dp, 1) mesh, from JAX's initial state
on the same global batch, at ``reduced_config`` in float32.

* Cases: a dense config (Qwen2), RecurrentGemma, and DBRX (MoE) with
  ``routing_groups`` 0 (one group a data shard: routed where the rows lie)
  and 3 (groups that straddle the ranks at dp 2 and 4: gathered, routed
  globally), each at dp = 2 and 4.
* Loss, ce, aux and the new state within PR 27's float32 classes
  (``tests/_torch_train_ref.py``): metrics within 1e-5, the first moment
  (0.1 · the clipped gradient) within 1e-5 of its tree's largest value and
  the second within 2e-5, master weights and parameters within half a step.
* ZeRO-1 on is bit-equal to ZeRO-1 off at the same dp, and keeps a dp-th
  of the optimizer state on a rank.
* A checkpoint written by ``trainer.train`` at dp = 2 under ZeRO-1 (rank 0
  alone, in the global layout) restores at dp = 1 in the port, bit-equal in
  JAX, and a run resumes from it.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_dist_ref import start_jax, start_ranks, to_np  # noqa: E402
from _torch_lm_ref import FLAG_KW  # noqa: E402
from _torch_train_ref import GRAD_TOL  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import reduced_config as treduced  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_at  # noqa: E402
from repro_torch.models.runtime import RunFlags  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

CASES = (
    {"name": "dense", "arch": "qwen2-0.5b", "flags": dict(FLAG_KW)},
    {"name": "rglru", "arch": "recurrentgemma-2b", "flags": dict(FLAG_KW)},
    {"name": "moe_g0", "arch": "dbrx-132b", "flags": dict(FLAG_KW, routing_groups=0)},
    {"name": "moe_g3", "arch": "dbrx-132b", "flags": dict(FLAG_KW, routing_groups=3)},
)
DPS = (2, 4)
B, S = 4, 12
REL = GRAD_TOL["float32"]
CKPT = {"arch": "dbrx-132b", "steps": 2, "seq": 12, "batch": 4, "flags": dict(FLAG_KW, routing_groups=3)}


def _inputs():
    out = {}
    rng = np.random.default_rng(7)
    for case in CASES:
        cfg = dataclasses.replace(jreduced(jget(case["arch"])), dtype="float32")
        params = jt.init_params(jax.random.key(0), cfg)
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            out[f"{case['name']}/params/" + "/".join(k.key for k in path)] = np.asarray(leaf)
        out[f"{case['name']}/batch/tokens"] = rng.integers(2, cfg.vocab_size, (B, S)).astype(np.int32)
        out[f"{case['name']}/batch/labels"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's outputs, {dp: each rank's results}, the dp = 2 trainer's
    ranks and checkpoint directory); every group side by side under its own
    time limit."""
    tmp = tmp_path_factory.mktemp("train_dist")
    np.savez(tmp / "inputs.npz", **_inputs())
    spec = {"inputs": str(tmp / "inputs.npz"), "cases": list(CASES), "dps": list(DPS)}
    jax_run = start_jax("train", tmp, spec)
    ranks = {dp: start_ranks("train", dp, tmp, spec) for dp in DPS}
    ckpt_dir = tmp / "ckpt"
    trainer_run = start_ranks("trainer", 2, tmp, dict(CKPT, ckpt_dir=str(ckpt_dir)))
    return jax_run.results(), {dp: g.results() for dp, g in ranks.items()}, trainer_run.results(), ckpt_dir


def _tree_scale(want, prefix):
    return max(float(np.abs(v).max()) for k, v in want.items() if k.startswith(prefix) and v.size)


@pytest.mark.parametrize("dp", DPS)
@pytest.mark.parametrize("case", [c["name"] for c in CASES])
def test_train_step_under_mesh_rules_equals_jax(runs, case, dp):
    want_all, ranks, _, _ = runs
    jtag = f"{case}/dp{dp}"
    want = {k[len(jtag) + 1:]: v for k, v in want_all.items() if k.startswith(jtag + "/")}
    ptag = f"{case}/dp{dp}/zero1=False"
    for res in ranks[dp]:
        got = {k[len(ptag) + 1:]: to_np(v) for k, v in res.items() if k.startswith(ptag + "/")}
        assert sorted(got) == sorted(want)
        for k in ("loss", "ce", "aux"):
            w, g = float(want[f"metrics/{k}"]), float(got[f"metrics/{k}"])
            assert abs(g - w) <= REL * max(abs(w), 1.0), (k, g, w)
        assert float(got["metrics/lr"]) == float(want["metrics/lr"])
        assert int(got["state/step"]) == int(want["state/step"]) == 1
        assert int(got["state/opt/count"]) == int(want["state/opt/count"]) == 1
        if case.startswith("moe"):
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


@pytest.mark.parametrize("dp", DPS)
@pytest.mark.parametrize("case", [c["name"] for c in CASES])
def test_zero1_is_bit_equal_to_zero1_off(runs, case, dp):
    """ZeRO-1's sharded update, gathered, is the replicated update bit for
    bit, on every rank, with a dp-th of the optimizer state on each."""
    _, ranks, _, _ = runs
    off, on = f"{case}/dp{dp}/zero1=False/", f"{case}/dp{dp}/zero1=True/"
    first = ranks[dp][0]
    for res in ranks[dp]:
        keys = sorted(k[len(off):] for k in res if k.startswith(off))
        assert keys == sorted(k[len(on):] for k in res if k.startswith(on))
        for k in keys:
            assert torch.equal(res[off + k], res[on + k]), k
            assert torch.equal(res[on + k], first[on + k]), k  # every rank holds the same state
    # zero1_spec shards the first dim that dp divides (the model axis is 1 wide)
    want = sum(v.numel() // dp if any(n % dp == 0 for n in v.shape) else v.numel()
               for k, v in first.items() if k.startswith(off + "state/opt/") and not k.endswith("/count"))
    assert [res[f"{case}/zero1_opt_numel"] for res in ranks[dp]] == [want] * dp


def test_checkpoint_at_dp2_zero1_restores_at_dp1_and_in_jax(runs, tmp_path):
    _, _, trainer_ranks, ckpt_dir = runs
    assert tckpt.latest_step(str(ckpt_dir)) == CKPT["steps"]
    h0 = [h["loss"] for h in trainer_ranks[0]["history"]]
    assert all(np.isfinite(h0)) and [h["loss"] for h in trainer_ranks[1]["history"]] == h0
    cfg = treduced(tget(CKPT["arch"]))
    template = tsteps.train_state_shape(cfg, topt.AdamWConfig())
    state, step, extra = tckpt.restore(str(ckpt_dir), template, device="cpu")
    assert step == CKPT["steps"] and extra == {"data_step": CKPT["steps"]}
    full = sum(x.numel() for x in topt.tree_leaves(state["opt"]))
    assert trainer_ranks[0]["opt_numel"] < full  # the ranks kept shards; the checkpoint the whole state
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
    # the same run at dp = 1, rules-free: the same data, the same losses within the float32 class ...
    data = DataConfig(cfg.vocab_size, CKPT["seq"], CKPT["batch"])
    flags = RunFlags(**CKPT["flags"])
    kw = dict(log_every=1, schedule_steps=50, ckpt_every=100)
    one = ttrainer.train(cfg, data, ttrainer.TrainLoopConfig(steps=CKPT["steps"], **kw), flags, device="cpu")
    for a, b in zip(h0, [h["loss"] for h in one["history"]]):
        assert abs(a - b) <= 2.0 ** -8 * abs(b), (a, b)
    # ... and resuming the dp = 2 checkpoint at dp = 1 continues from its step
    rerun = ttrainer.train(cfg, data, ttrainer.TrainLoopConfig(steps=CKPT["steps"] + 1, ckpt_dir=str(ckpt_dir), **kw),
                           flags, device="cpu")
    assert rerun["resumed_from"] == CKPT["steps"] and [h["step"] for h in rerun["history"]] == [CKPT["steps"] + 1]


def test_a_one_rank_mesh_is_bit_equal_to_no_rules(tmp_path):
    """The CPU form of the card's one-rank check: on a (1, 1) gloo mesh,
    ``trainer.train`` under ZeRO-1 and the serving steps under rules go
    through the collectives and give the rules-free results bit for bit;
    ``jit_train_step(donate=False)`` leaves its input state as it was."""
    import torch.distributed as dist

    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import MeshRules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import common as tcommon
    from repro_torch.models import transformer as tt
    from repro_torch.serve import engine as tengine

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdzv'}", world_size=1, rank=0)
    try:
        rules = MeshRules.from_mesh(make_host_mesh(device="cpu"))
        cfg = treduced(tget("recurrentgemma-2b"))
        data = DataConfig(cfg.vocab_size, 16, 2)
        loop = ttrainer.TrainLoopConfig(steps=2, log_every=1, schedule_steps=50)
        flags = RunFlags(**FLAG_KW, zero1=True)
        plain = ttrainer.train(cfg, data, loop, RunFlags(**FLAG_KW), device="cpu")
        collectives.reset_call_counts()
        run = ttrainer.train(cfg, data, loop, flags, rules=rules, device="cpu")
        calls = collectives.call_counts()
        assert calls["all_reduce"] >= 2 * len(topt.tree_leaves(plain["state"]["params"])) and \
            calls["all_gather_into_tensor"] > 0, calls
        assert [h["loss"] for h in run["history"]] == [h["loss"] for h in plain["history"]]
        state = tsteps.gather_train_state(run["state"], tsteps.train_state_specs(cfg, rules, topt.AdamWConfig(),
                                                                                  flags), rules)
        for a, b in zip(topt.tree_leaves(plain["state"]), topt.tree_leaves(state)):
            assert a.dtype == b.dtype and torch.equal(a, b)

        qcfg = treduced(tget("qwen2-0.5b"))
        qflags = RunFlags(**FLAG_KW)
        params = tcommon.maybe_quantize_tree(tt.init_params(qcfg, 0, device="cpu"), qcfg)
        batch = {"tokens": torch.randint(2, qcfg.vocab_size, (2, 8), dtype=torch.int32,
                                         generator=torch.Generator().manual_seed(3))}
        outs = []
        for r in (None, rules):
            cache, logits = tengine.make_prefill_step(qcfg, qflags, r, max_len=16)(params, batch)
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
            outs.append((logits, tengine.make_decode_step(qcfg, qflags, r)(params, cache, tok)[1]))
        assert all(torch.equal(a, b) for a, b in zip(*outs))

        step, sspecs = tsteps.jit_train_step(cfg, rules, flags, donate=False)
        assert tsteps.train_state_specs(cfg, rules, topt.AdamWConfig(), flags) == sspecs
        s0 = tsteps.shard_train_state(tsteps.make_train_state(tt.init_params(cfg, 0, device="cpu"),
                                                              topt.AdamWConfig()), sspecs, rules)
        before = [x.clone() for x in topt.tree_leaves(s0)]
        new, _ = step(s0, {k: torch.from_numpy(v) for k, v in batch_at(data, 0).items()})
        assert all(torch.equal(a, b) for a, b in zip(before, topt.tree_leaves(s0)))
        assert int(new["step"]) == 1
    finally:
        dist.destroy_process_group()
