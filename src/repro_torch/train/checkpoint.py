"""Checkpointing of the PyTorch port, in the JAX package's on-disk format
(``train/checkpoint.py``): a checkpoint written by either package restores
in the other.

Format: one .npy per leaf + a JSON manifest (paths, shapes, dtypes, step,
data-pipeline cursor).  A leaf's key is its path of dict keys joined by
``/`` (``params/blocks/00_attn/attn/wq/w``), its file that key with ``/``
written ``__``; leaves are listed in sorted key order, as ``jax.tree_util``
flattens a dict.  bfloat16 (which numpy lacks) is stored as a ``uint16``
view, its logical dtype in the manifest.  Writes go
to a temp dir that is atomically renamed — a crash mid-save never corrupts
the latest checkpoint.  ``restore`` places every leaf on the ``device`` the
caller names (JAX's ``sharding_for``), in the template's dtype.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import api



def _flatten_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten_with_paths(tree[k], f"{prefix}/{k}" if prefix else str(k)))
        return out
    return [(prefix, tree)]


def _unflatten(tree: Any, values: Dict[str, Any], prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _unflatten(v, values, f"{prefix}/{k}" if prefix else str(k)) for k, v in tree.items()}
    return values[prefix]


def _to_numpy(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(the array written, its logical dtype)."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, logical: str) -> torch.Tensor:
    if logical == "bfloat16" and arr.dtype == np.uint16:  # byte-view round-trip
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(ckpt_dir: str, state: Any, step: int, extra: Optional[Dict] = None) -> str:
    """Write checkpoint ``step`` atomically; returns the final path."""
    base = Path(ckpt_dir)
    base.mkdir(parents=True, exist_ok=True)
    final = base / f"step_{step:08d}"
    tmp = Path(tempfile.mkdtemp(dir=base, prefix=".tmp_"))
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for key, leaf in _flatten_with_paths(state):
        arr, logical = _to_numpy(leaf)
        fname = key.replace("/", "__") + ".npy"
        np.save(tmp / fname, arr)
        manifest["leaves"].append({"key": key, "file": fname, "shape": list(arr.shape), "dtype": logical})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic commit
    return str(final)


def latest_step(ckpt_dir: str) -> Optional[int]:
    base = Path(ckpt_dir)
    if not base.exists():
        return None
    steps = sorted(
        int(p.name.split("_")[1]) for p in base.iterdir()
        if p.is_dir() and p.name.startswith("step_") and (p / "manifest.json").exists()
    )
    return steps[-1] if steps else None


def restore(ckpt_dir: str, state_template: Any, step: Optional[int] = None,
            device: Any = "cuda") -> Tuple[Any, int, Dict]:
    """Restore onto the template's structure (a tree of tensors, e.g. on the
    ``meta`` device), every leaf on ``device`` in the template's dtype.
    Returns ``(state, step, extra)``."""
    dev = api.resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    by_key = {e["key"]: e for e in manifest["leaves"]}
    values = {}
    for key, tmpl in _flatten_with_paths(state_template):
        e = by_key[key]
        t = _from_numpy(np.load(path / e["file"]), e["dtype"])
        if tuple(t.shape) != tuple(tmpl.shape):
            raise ValueError(f"checkpoint leaf {key}: shape {tuple(t.shape)}, template {tuple(tmpl.shape)}")
        values[key] = t.to(device=dev, dtype=tmpl.dtype)
    return _unflatten(state_template, values), manifest["step"], manifest["extra"]


def prune(ckpt_dir: str, keep: int = 3) -> None:
    base = Path(ckpt_dir)
    if not base.exists():
        return
    steps = sorted(
        p for p in base.iterdir() if p.is_dir() and p.name.startswith("step_")
    )
    for p in steps[:-keep]:
        shutil.rmtree(p)
