"""Registry of assigned architectures and shape cells: the port's copy of the
JAX package's ``configs`` (the same data, imported from nowhere else).

>>> from repro_torch.configs import get_config, list_archs, SHAPES
>>> cfg = get_config("qwen2-0.5b")
>>> tiny = reduced_config(cfg)   # for CPU smoke tests
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    ModelConfig,
    QuantConfig,
    ShapeCell,
    SHAPES,
    SHAPES_BY_NAME,
    cell_supported,
)

from repro_torch.configs.internlm2_20b import CONFIG as _internlm2
from repro_torch.configs.qwen2_0_5b import CONFIG as _qwen2
from repro_torch.configs.granite_20b import CONFIG as _granite
from repro_torch.configs.minicpm_2b import CONFIG as _minicpm
from repro_torch.configs.recurrentgemma_2b import CONFIG as _rgemma
from repro_torch.configs.kimi_k2_1t import CONFIG as _kimi
from repro_torch.configs.dbrx_132b import CONFIG as _dbrx
from repro_torch.configs.whisper_medium import CONFIG as _whisper
from repro_torch.configs.xlstm_1_3b import CONFIG as _xlstm
from repro_torch.configs.phi_3_vision import CONFIG as _phi3v

_REGISTRY: Dict[str, ModelConfig] = {
    c.name: c
    for c in (
        _internlm2,
        _qwen2,
        _granite,
        _minicpm,
        _rgemma,
        _kimi,
        _dbrx,
        _whisper,
        _xlstm,
        _phi3v,
    )
}


def list_archs() -> List[str]:
    return sorted(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    return _REGISTRY[name]


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests.

    Shrinks depth/width/experts/vocab but keeps the block pattern family,
    GQA ratio, bias/tie/frontend flags — i.e. everything that changes code
    paths — intact.
    """
    pat = tuple(dict.fromkeys(cfg.block_pattern))  # unique kinds, order kept
    # keep at least one of each kind; two pattern groups
    n_layers = 2 * len(pat)
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    head_dim = 16
    d_model = n_heads * head_dim * 2  # d_model != q_dim to exercise projections
    return dataclasses.replace(
        cfg,
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=0 if cfg.d_ff == 0 else 4 * head_dim,
        vocab_size=256,
        block_pattern=pat,
        window=min(cfg.window, 8) if cfg.window else 0,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2) if cfg.n_experts else 0,
        n_enc_layers=2 if cfg.n_enc_layers else 0,
        enc_seq_len=8,
        n_patches=4,
    )


SMOKE_SHAPE = ShapeCell("smoke", "train", 16, 2)
