"""The PyTorch port stands alone: ``repro_torch``, ``chip_smoke.py`` and the
port's examples (``examples/torch_*.py``) import neither ``jax`` nor any
module of the JAX package, and its entry points refuse to fall back to the
CPU when the card was asked for."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.configs import reduced_config as treduced  # noqa: E402
from repro_torch.kernels import api as tapi  # noqa: E402
from repro_torch.data.pipeline import DataConfig as tDataConfig  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain_cli  # noqa: E402
from repro_torch.models import resnet as tres  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve import scheduler as tsched  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(REPO / "src").with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


def _forbidden(name: str) -> bool:
    return name == "jax" or name.startswith(("jax.", "jaxlib")) or name == "repro" \
        or name.startswith("repro.")


def test_importing_every_port_module_loads_no_jax_or_repro():
    mods = _port_modules()
    assert "repro_torch.kernels.conv" in mods and "repro_torch.models.resnet" in mods
    assert {"repro_torch.configs", "repro_torch.configs.base", "repro_torch.configs.qwen2_0_5b",
            "repro_torch.models.runtime", "repro_torch.models.common", "repro_torch.models.attention",
            "repro_torch.models.frontend", "repro_torch.models.transformer", "repro_torch.serve.engine",
            "repro_torch.launch.serve", "repro_torch.models.recurrent", "repro_torch.models.moe",
            "repro_torch.data.pipeline", "repro_torch.train.fault", "repro_torch.train.optimizer",
            "repro_torch.train.steps", "repro_torch.train.checkpoint", "repro_torch.train.trainer",
            "repro_torch.launch.train", "repro_torch.dist", "repro_torch.dist.sharding",
            "repro_torch.dist.collectives", "repro_torch.launch.mesh", "repro_torch.launch.specs",
            "repro_torch.launch.memory_model", "repro_torch.launch.hlo_analysis",
            "repro_torch.launch.dryrun"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith(('jax.', 'jaxlib'))"
        " or n == 'repro' or n.startswith('repro.'))\n"
        "print('FORBIDDEN', bad)\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=str(REPO),
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
    )
    assert r.returncode == 0, r.stderr
    assert "FORBIDDEN []" in r.stdout, r.stdout


@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py"))
                         + ["chip_smoke.py"]
                         + sorted(str(p.relative_to(REPO)) for p in (REPO / "examples").glob("torch_*.py")))
def test_source_imports_nothing_of_jax_or_repro(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


ENTRY_POINTS = {
    "resolve_device": lambda: tapi.resolve_device(),
    "init_params": lambda: tres.init_params(tres.TINY),
    "make_input": lambda: tres.make_input(tres.TINY),
    "params_from_numpy": lambda: tres.params_from_numpy(
        tres._numpy_params(tres.TINY, 0), device="cuda"),
    "ResNet": lambda: tres.ResNet(tres.TINY),
    "ResNet-cuda:0": lambda: tres.ResNet(tres.TINY, device="cuda:0"),
    "transformer.init_params": lambda: ttf.init_params(treduced(tget_config("qwen2-0.5b"))),
    "transformer.params_from_numpy": lambda: ttf.params_from_numpy({"embed": {"w": np.zeros((4, 2), np.float32)}}),
    "transformer.init_cache": lambda: ttf.init_cache(treduced(tget_config("qwen2-0.5b")), 1, 8),
    "launch.serve": lambda: tserve.main(["--arch", "qwen2-0.5b", "--reduced"]),
    "launch.serve-recurrentgemma": lambda: tserve.main(["--arch", "recurrentgemma-2b", "--reduced"]),
    "transformer.init_params-whisper": lambda: ttf.init_params(treduced(tget_config("whisper-medium"))),
    "scheduler.ContinuousBatcher": lambda: tsched.ContinuousBatcher(),
    "launch.train": lambda: ttrain_cli.main(["--arch", "recurrentgemma-2b", "--reduced", "--steps", "1"]),
    "train.trainer.train": lambda: ttrainer.train(treduced(tget_config("qwen2-0.5b")), tDataConfig(256, 8, 2),
                                                  ttrainer.TrainLoopConfig(steps=1)),
    "train.checkpoint.restore": lambda: tckpt.restore("/nonexistent", {}, step=0),
    "launch.mesh.make_host_mesh": lambda: tmesh.make_host_mesh(),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_raise_without_cuda_instead_of_falling_back(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card refusal cannot be shown here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[entry]()


def test_entry_points_run_on_the_cpu_when_asked():
    model = tres.ResNet(tres.TINY, device="cpu")
    out = model(tres.make_input(tres.TINY, 1, device="cpu"))
    assert out.device.type == "cpu" and out.shape == (1, 10)


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    """``chip_smoke.py`` exits non-zero and prints no result without a card,
    both in the repository and copied alone into an empty directory."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card failure cannot be shown here")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for script, cwd in ((REPO / "chip_smoke.py", REPO), (alone, tmp_path)):
        r = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                           timeout=300, cwd=str(cwd))
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout
