"""Shared helpers of the port's multi-process distribution tests
(``tests/test_torch_dist_collectives.py``, ``tests/test_torch_train_dist.py``).

Both sides run in processes of their own, each group under a time limit of
its own after which every process of the group is killed, so that a rank
that hangs fails its test instead of holding the suite:

* the port: WORLD processes of ``tests/_torch_dist_worker.py``, a gloo
  process group joined through a file rendezvous in the test's temporary
  directory (no TCP port to collide with another test worker);
* JAX: one process of ``tests/_jax_dist_ref.py`` with
  ``--xla_force_host_platform_device_count`` set before JAX is imported.

Start every group first (:func:`start_ranks`, :func:`start_jax`), then
collect them (:meth:`Group.results`): the groups run side by side.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent


def _env() -> Dict[str, str]:
    return dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")


class Group:
    """Processes started together and collected under one time limit."""

    def __init__(self, what: str, procs: List[subprocess.Popen], out: Path, timeout: float, collect):
        self.what, self.procs, self.out, self.timeout, self.collect = what, procs, out, timeout, collect
        self.t0 = time.monotonic()

    def results(self):
        deadline = self.t0 + self.timeout
        try:
            for p in self.procs:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            for p in self.procs:
                p.kill()
            for p in self.procs:
                p.wait()
            raise AssertionError(f"{self.what}: not done within {self.timeout} s; every process killed")
        logs = []
        for p in self.procs:
            stdout, stderr = p.communicate()
            logs.append(stdout[-2000:] + stderr[-4000:])
        bad = [i for i, p in enumerate(self.procs) if p.returncode != 0]
        assert not bad, f"{self.what}: processes {bad} failed:\n" + "\n".join(logs[i] for i in bad)
        return self.collect(self.out)


def _spec(tmp: Path, name: str, spec: Dict[str, Any]) -> Path:
    path = tmp / f"{name}.json"
    path.write_text(json.dumps(spec))
    return path


def start_ranks(job: str, world: int, tmp: Path, spec: Dict[str, Any], timeout: float = 120) -> Group:
    """WORLD ranks of the port's worker on ``job``; their results, one dict
    a rank, come from :meth:`Group.results`."""
    out = tmp / f"{job}_w{world}"
    out.mkdir()
    spec = dict(spec, rdzv=str(out / "rdzv"), out=str(out))
    path = _spec(tmp, f"{job}_w{world}", spec)
    procs = [subprocess.Popen([sys.executable, str(TESTS / "_torch_dist_worker.py"), job, str(path), str(world),
                               str(r)], cwd=str(REPO), env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for r in range(world)]
    return Group(f"port {job} at world {world}", procs, out,
                 timeout, lambda o: [torch.load(o / f"rank{r}.pt", weights_only=False) for r in range(world)])


def start_jax(job: str, tmp: Path, spec: Dict[str, Any], timeout: float = 180) -> Group:
    """The JAX side of ``job``; its results (a dict of arrays) come from
    :meth:`Group.results`."""
    out = tmp / f"jax_{job}.npz"
    path = _spec(tmp, f"jax_{job}", spec)
    proc = subprocess.Popen([sys.executable, str(TESTS / "_jax_dist_ref.py"), job, str(path), str(out)],
                            cwd=str(REPO), env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return Group(f"JAX {job}", [proc], out, timeout, lambda o: dict(np.load(o)))


def to_np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
