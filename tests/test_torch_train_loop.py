"""The port's checkpoints, training loop and launcher
(``repro_torch/train/{checkpoint,trainer}.py``, ``repro_torch/launch/
train.py``, ``examples/torch_elastic_restart.py``) on the CPU, against the
JAX package.

* Checkpoints cross both ways bit for bit: a state saved by either package
  restores in the other with every leaf's bits (bfloat16 as its uint16
  view), and both write the same manifest and the same ``.npy`` bytes.
* Resume: JAX's ``test_train_resume_matches_uninterrupted`` (8 steps
  straight against 4, a restore and 4 more), bit-exact on the CPU.
* ``train``'s history against JAX's ``train`` from one checkpoint JAX wrote
  at step 0 (the two packages draw different initial weights): the same
  logged steps, each loss within 1e-5 relative in float32.
"""
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_lm_ref import np_tree  # noqa: E402
from _torch_train_ref import leaf_pairs  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.models.runtime import RunFlags as JFlags  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import reduced_config as treduced  # noqa: E402
from repro_torch.data.pipeline import DataConfig as TDataConfig  # noqa: E402
from repro_torch.launch import train as ttrain_cli  # noqa: E402
from repro_torch.models.runtime import RunFlags as TFlags  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FLAG_KW = dict(attn_chunk=32, flash_threshold=128)  # JAX's tests/test_substrate.py FLAGS


def _configs(arch, dtype=None):
    jcfg, tcfg = jreduced(jget(arch)), treduced(tget(arch))
    if dtype:
        jcfg, tcfg = dataclasses.replace(jcfg, dtype=dtype), dataclasses.replace(tcfg, dtype=dtype)
    return jcfg, tcfg


def _jax_state(arch, seed=0, dtype=None):
    jcfg, _ = _configs(arch, dtype)
    return jsteps.make_train_state(jt.init_params(jax.random.key(seed), jcfg), jsteps.AdamWConfig())


def _bits(x):
    """A leaf's bits as numpy (bfloat16 as int16)."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _assert_bit_equal(jtree, ttree):
    pairs = list(leaf_pairs(jtree, ttree))
    assert len(pairs) == len(jax.tree_util.tree_leaves(jtree))
    for path, w, g in pairs:
        assert str(g.dtype).endswith(str(w.dtype)) and tuple(g.shape) == w.shape, path
        assert np.array_equal(_bits(g), _bits(w)), path


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "whisper-medium"])
def test_checkpoint_written_by_jax_restores_in_the_port(arch, tmp_path):
    _, tcfg = _configs(arch)
    jstate = _jax_state(arch)
    jckpt.save(str(tmp_path), jstate, 7, extra={"data_step": 9})
    assert tckpt.latest_step(str(tmp_path)) == 7
    state, step, extra = tckpt.restore(str(tmp_path), tsteps.train_state_shape(tcfg, topt.AdamWConfig()),
                                       device="cpu")
    assert step == 7 and extra == {"data_step": 9}
    assert all(leaf.device.type == "cpu" for leaf in topt.tree_leaves(state))
    _assert_bit_equal(jstate, state)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "dbrx-132b"])
def test_checkpoint_written_by_the_port_restores_in_jax_with_the_same_files(arch, tmp_path):
    """The port's save of JAX's state writes JAX's manifest and the same
    ``.npy`` bytes; JAX restores it bit for bit."""
    jcfg, _ = _configs(arch)
    jstate = _jax_state(arch, seed=1)
    tstate = tsteps.train_state_from_numpy(np_tree(jstate), device="cpu")
    tdir, jdir = tmp_path / "port", tmp_path / "jax"
    tpath = Path(tckpt.save(str(tdir), tstate, 3, extra={"data_step": 3}))
    jpath = Path(jckpt.save(str(jdir), jstate, 3, extra={"data_step": 3}))
    assert tpath.name == jpath.name == "step_00000003"
    tman, jman = (json.loads((p / "manifest.json").read_text()) for p in (tpath, jpath))
    assert tman == jman
    assert any(e["dtype"] == "bfloat16" for e in tman["leaves"])
    for e in tman["leaves"]:
        assert (tpath / e["file"]).read_bytes() == (jpath / e["file"]).read_bytes(), e["key"]
    template = jax.eval_shape(lambda: jsteps.make_train_state(jt.init_params(jax.random.key(0), jcfg),
                                                              jsteps.AdamWConfig()))
    restored, step, extra = jckpt.restore(str(tdir), template)
    assert step == 3 and extra == {"data_step": 3}
    _assert_bit_equal(restored, tstate)


def test_checkpoint_prune_latest_and_refusals(tmp_path):
    tstate = tsteps.train_state_from_numpy(np_tree(_jax_state("qwen2-0.5b")), device="cpu")
    for step in (1, 2, 3, 4, 5):
        tckpt.save(str(tmp_path), {"params": tstate["params"]}, step)
    (tmp_path / "step_00000009").mkdir()  # no manifest: not a checkpoint
    assert tckpt.latest_step(str(tmp_path)) == 5
    tckpt.prune(str(tmp_path), keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000005", "step_00000009"]
    assert tckpt.latest_step(str(tmp_path)) == 5
    with pytest.raises(FileNotFoundError):
        tckpt.restore(str(tmp_path / "none"), tstate, device="cpu")
    _, tcfg = _configs("qwen2-0.5b")
    wrong = tsteps.train_state_shape(dataclasses.replace(tcfg, d_model=2 * tcfg.d_model), topt.AdamWConfig())
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(str(tmp_path), {"params": wrong["params"]}, device="cpu")


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-2b"])
def test_train_resume_matches_uninterrupted(arch, tmp_path):
    """JAX's ``test_train_resume_matches_uninterrupted`` on the port: 8
    steps straight against 4, a checkpoint, a restore and 4 more give the
    same parameters and optimizer state, bit for bit on the CPU."""
    _, cfg = _configs(arch)
    flags = TFlags(**FLAG_KW)
    data_cfg = TDataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)
    loop_a = ttrainer.TrainLoopConfig(steps=8, ckpt_every=100, ckpt_dir=str(tmp_path / "a"), log_every=4,
                                      schedule_steps=8)
    out_a = ttrainer.train(cfg, data_cfg, loop_a, flags, device="cpu")
    loop_b1 = ttrainer.TrainLoopConfig(steps=4, ckpt_every=4, ckpt_dir=str(tmp_path / "b"), log_every=4,
                                       schedule_steps=8)
    out_b1 = ttrainer.train(cfg, data_cfg, loop_b1, flags, device="cpu")
    assert out_b1["resumed_from"] is None
    loop_b2 = ttrainer.TrainLoopConfig(steps=8, ckpt_every=100, ckpt_dir=str(tmp_path / "b"), log_every=4,
                                       schedule_steps=8)
    out_b = ttrainer.train(cfg, data_cfg, loop_b2, flags, device="cpu")
    assert out_b["resumed_from"] == 4
    assert [h["step"] for h in out_a["history"]] == [4, 8] and [h["step"] for h in out_b["history"]] == [8]
    assert out_a["history"][-1]["loss"] == out_b["history"][-1]["loss"]
    for a, b in zip(topt.tree_leaves(out_a["state"]), topt.tree_leaves(out_b["state"])):
        assert torch.equal(a, b)
    assert int(out_b["state"]["step"]) == 8


def test_train_history_matches_jax_from_one_checkpoint(tmp_path):
    """Both trainers resume from a checkpoint JAX wrote at step 0 (float32
    RecurrentGemma at ``reduced_config``) and train 6 steps: the same
    logged steps and losses within 1e-5 relative."""
    jcfg, tcfg = _configs("recurrentgemma-2b", "float32")
    jstate = _jax_state("recurrentgemma-2b", dtype="float32")
    for d in ("jax", "port"):
        jckpt.save(str(tmp_path / d), jstate, 0, extra={"data_step": 0})
    jdata = JDataConfig(vocab_size=jcfg.vocab_size, seq_len=16, global_batch=2)
    tdata = TDataConfig(vocab_size=tcfg.vocab_size, seq_len=16, global_batch=2)
    kw = dict(steps=6, ckpt_every=100, log_every=2, schedule_steps=50)
    want = jtrainer.train(jcfg, jdata, jtrainer.TrainLoopConfig(ckpt_dir=str(tmp_path / "jax"), **kw),
                          JFlags(**FLAG_KW))
    got = ttrainer.train(tcfg, tdata, ttrainer.TrainLoopConfig(ckpt_dir=str(tmp_path / "port"), **kw),
                         TFlags(**FLAG_KW), device="cpu")
    assert got["resumed_from"] == want["resumed_from"] == 0
    assert [h["step"] for h in got["history"]] == [h["step"] for h in want["history"]] == [2, 4, 6]
    for g, w in zip(got["history"], want["history"]):
        assert sorted(g) == sorted(w) == ["loss", "s_per_step", "step"] and g["s_per_step"] > 0
        assert abs(g["loss"] - w["loss"]) <= 1e-5 * abs(w["loss"]), (g, w)
    # the port's own last checkpoint restores in JAX
    restored, step, extra = jckpt.restore(str(tmp_path / "port"), jax.eval_shape(lambda: jstate))
    assert step == 6 and extra == {"data_step": 6}
    _assert_bit_equal(restored, got["state"])


def test_train_refuses_rules_naming_s13():
    """The trainer takes rules on a process mesh (ROADMAP S13, S13b); a
    model axis wider than one on a mesh with no ranks raises ValueError
    naming ``make_host_mesh``, rules that are no MeshRules TypeError."""
    from repro_torch.dist.sharding import MeshRules
    from repro_torch.launch.mesh import MeshDescription

    _, cfg = _configs("qwen2-0.5b")
    tp = MeshRules.from_mesh(MeshDescription((1, 2), ("data", "model")))
    for rules, err, match in ((tp, ValueError, "make_host_mesh"), (object(), TypeError, "MeshRules")):
        with pytest.raises(err, match=match):
            ttrainer.train(cfg, TDataConfig(cfg.vocab_size, 8, 2), ttrainer.TrainLoopConfig(steps=1), rules=rules,
                           device="cpu")


def test_cli_trains_on_the_cpu_when_asked(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ttrain_cli.main(["--arch", "recurrentgemma-2b", "--reduced", "--steps", "2", "--seq", "16", "--batch", "2",
                         "--device", "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("{'step': 2, 'loss': ")
    assert tckpt.latest_step(str(tmp_path)) == 2
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ttrain_cli.main(["--arch", "recurrentgemma-2b", "--reduced", "--steps", "3", "--seq", "16", "--batch", "2",
                         "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert out.getvalue().splitlines()[-1] == "(resumed from step 2)"


def test_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card refusal cannot be shown here")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen2-0.5b", "--reduced",
                        "--steps", "1"], capture_output=True, text=True, timeout=300, cwd=str(REPO),
                       env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert r.returncode != 0 and "CUDA is not available" in r.stderr and "step" not in r.stdout


def test_torch_elastic_restart_example_on_the_cpu():
    """``examples/torch_elastic_restart.py --device cpu``: 60 steps, a
    failure plan, a restart from step 60 and a falling loss."""
    r = subprocess.run([sys.executable, str(REPO / "examples" / "torch_elastic_restart.py"), "--device", "cpu"],
                       capture_output=True, text=True, timeout=600, cwd=str(REPO),
                       env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "resumed from 60" in r.stdout and r.stdout.rstrip().endswith("elastic restart drill: OK")
