"""Input stand-ins for every (arch × shape × step) cell, the port of the JAX
package's ``launch/specs.py``: trees of ``meta``-device tensors (shape and
dtype, no storage) that carry their partition spec as ``.spec`` — the
counterpart of sharded ``jax.ShapeDtypeStruct``s.  Nothing is allocated.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.dist.sharding import MeshRules, P, param_specs
from repro_torch.models.common import dtype_of
from repro_torch.models.runtime import DEFAULT_FLAGS, RunFlags


def _meta(shape, dtype: torch.dtype, spec: Optional[P]) -> torch.Tensor:
    t = torch.empty(tuple(shape), dtype=dtype, device="meta")
    t.spec = spec
    return t


def _sds(shape, dtype, rules: Optional[MeshRules], spec: Optional[P]) -> torch.Tensor:
    return _meta(shape, dtype, spec if rules is not None else None)


def batch_specs(
    cfg: ModelConfig, cell: ShapeCell, rules: Optional[MeshRules] = None, with_labels: bool = True
) -> Dict[str, Any]:
    """The token batch (+ frontend stub embeddings) for train/prefill."""
    b, s = cell.global_batch, cell.seq_len
    axes = rules.batch_axes(b) if rules else None
    dt = dtype_of(cfg)
    out: Dict[str, Any] = {
        "tokens": _sds((b, s), torch.int32, rules, P(axes, None) if rules else None)
    }
    if with_labels:
        out["labels"] = _sds((b, s), torch.int32, rules, P(axes, None) if rules else None)
    if cfg.is_encdec:
        out["enc_embeds"] = _sds(
            (b, cfg.enc_seq_len, cfg.d_model), dt, rules, P(axes, None, None) if rules else None
        )
    if cfg.frontend == "vision":
        out["patch_embeds"] = _sds(
            (b, cfg.n_patches, cfg.d_model), dt, rules, P(axes, None, None) if rules else None
        )
    return out


def sharded_tree(shapes: Any, specs: Any, rules: Optional[MeshRules]) -> Any:
    """A ``meta`` tree of ``shapes`` with each leaf's spec of ``specs``
    attached."""
    if rules is None:
        return shapes
    if isinstance(shapes, dict):
        return {k: sharded_tree(v, specs[k], rules) for k, v in shapes.items()}
    return _meta(shapes.shape, shapes.dtype, specs)


def input_specs(
    cfg: ModelConfig,
    cell: ShapeCell,
    rules: Optional[MeshRules] = None,
    flags: RunFlags = DEFAULT_FLAGS,
) -> Dict[str, Any]:
    """All inputs for the cell's step function, as (sharded) ``meta`` trees.

    train  → {"state": ..., "batch": ...}               for train_step
    prefill→ {"params": ..., "batch": ...}              for prefill
    decode → {"params": ..., "cache": ..., "tokens":..} for decode_step
    """
    from repro_torch.models.transformer import cache_shape
    from repro_torch.serve.engine import cache_specs, serve_params_shape
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.steps import train_state_shape, train_state_specs

    if cell.kind == "train":
        opt_cfg = AdamWConfig()
        sshapes = train_state_shape(cfg, opt_cfg)
        sspecs = train_state_specs(cfg, rules, opt_cfg, flags) if rules else None
        state = sharded_tree(sshapes, sspecs, rules)
        return {"state": state, "batch": batch_specs(cfg, cell, rules, with_labels=True)}

    pshapes = serve_params_shape(cfg, flags)
    pspecs = param_specs(pshapes, cfg, rules) if rules else None
    params = sharded_tree(pshapes, pspecs, rules)
    if cell.kind == "prefill":
        return {"params": params, "batch": batch_specs(cfg, cell, rules, with_labels=False)}

    # decode: one new token against a cache of seq_len
    b = cell.global_batch
    cshapes = cache_shape(cfg, b, cell.seq_len, flags)
    cspecs = cache_specs(cfg, b, cell.seq_len, rules, flags) if rules else None
    cache = sharded_tree(cshapes, cspecs, rules)
    axes = rules.batch_axes(b) if rules else None
    tokens = _sds((b, 1), torch.int32, rules, P(axes, None) if rules else None)
    return {"params": params, "cache": cache, "tokens": tokens}
