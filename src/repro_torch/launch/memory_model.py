"""Analytic per-device memory model, the port of the JAX package's
``launch/memory_model.py``, with its arithmetic:

* params / optimizer / cache / batch bytes — **exact**, from the sharded
  ``meta`` trees of ``launch.specs`` (leaf bytes ÷ shard factor of its
  partition spec);
* training activations — the remat-policy bound: one bf16 block-input
  checkpoint per layer + the logits/CE working set + one block's live
  working set.

The JAX package holds the peak against a TPU's 16 GiB; here ``fits_device``
holds it against a size the caller gives, or else the card's
``total_memory``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.dist.sharding import MeshRules


def _shard_factor(spec, shape, mesh) -> int:
    if spec is None:
        return 1
    f = 1
    for entry in spec:
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        for ax in axes:
            f *= mesh.shape[ax]
    return f


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def sharded_bytes(shapes_tree: Any, mesh) -> int:
    """Total per-device bytes of a ``meta`` tree whose leaves carry their
    partition spec (as produced by ``launch.specs.sharded_tree``)."""
    total = 0
    for leaf in _leaves(shapes_tree):
        n = leaf.numel() * leaf.element_size()
        total += n // max(_shard_factor(getattr(leaf, "spec", None), leaf.shape, mesh), 1)
    return total


def activation_bytes(cfg: ModelConfig, cell: ShapeCell, rules: MeshRules, flags) -> Dict[str, int]:
    """Remat-policy activation bound for one train step (per device)."""
    dp = rules.dp
    tokens_dev = cell.tokens // dp
    d = cfg.d_model
    # one bf16 checkpoint (the block input) per layer
    ckpt = cfg.n_layers * tokens_dev * d * 2
    if cfg.is_encdec:
        ckpt += cfg.n_enc_layers * (cell.global_batch // dp) * cfg.enc_seq_len * d * 2
    # logits + CE working set: bf16 logits, fp32 logsumexp chain, fp32 grad
    vp_dev = cfg.padded_vocab() // rules.tp
    logits = tokens_dev * vp_dev * (2 + 4 + 4)
    # one block's live working set during its backward (fp32-heavy)
    widths = [4 * d]  # attention qkv+proj working margin
    if cfg.d_ff:
        widths.append(2 * cfg.d_ff if not cfg.is_moe else 2 * cfg.d_ff)
    if "mlstm" in cfg.block_pattern:
        widths.append(8 * d)
    chunk_att = getattr(flags, "attn_chunk", 1024)
    att_scores = (cell.global_batch // dp) * cfg.n_heads * chunk_att * chunk_att * 4 * 3
    block_live = tokens_dev * max(widths) * 4 * 2 + att_scores
    return {
        "checkpoint_bytes": ckpt,
        "logits_bytes": logits,
        "block_live_bytes": block_live,
        "total": ckpt + logits + block_live,
    }


def _device_bytes(device_bytes: Optional[int]) -> Optional[int]:
    if device_bytes is not None:
        return int(device_bytes)
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(torch.cuda.current_device()).total_memory
    return None


def analytic_memory(cfg, cell, rules, flags, specs: Dict[str, Any],
                    device_bytes: Optional[int] = None) -> Dict[str, Any]:
    """JAX's per-device memory model of a cell, with ``fits_device`` (the
    peak below ``device_bytes``, or the card's memory; None with neither)
    and ``device_bytes`` in place of its TPU check."""
    mesh = rules.mesh
    out: Dict[str, Any] = {}
    if cell.kind == "train":
        out["state_bytes_per_device"] = sharded_bytes(specs["state"], mesh)
        out["batch_bytes_per_device"] = sharded_bytes(specs["batch"], mesh)
        acts = activation_bytes(cfg, cell, rules, flags)
        out["activation_bytes_per_device"] = acts
        out["analytic_peak_per_device"] = (
            # state twice (in + out; donation would alias, we report undonated)
            out["state_bytes_per_device"]
            + out["batch_bytes_per_device"]
            + acts["total"]
        )
    else:
        out["params_bytes_per_device"] = sharded_bytes(specs["params"], mesh)
        if "cache" in specs:
            out["cache_bytes_per_device"] = sharded_bytes(specs["cache"], mesh)
        if "batch" in specs:
            out["batch_bytes_per_device"] = sharded_bytes(specs["batch"], mesh)
        total = sum(v for v in out.values() if isinstance(v, int))
        # decode/prefill working set is small relative to weights+cache; add 10%
        out["analytic_peak_per_device"] = int(total * 1.1)
    cap = _device_bytes(device_bytes)
    out["device_bytes"] = cap
    out["fits_device"] = None if cap is None else bool(out["analytic_peak_per_device"] < cap)
    return out
