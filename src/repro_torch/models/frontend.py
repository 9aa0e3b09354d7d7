"""Modality frontend stubs of the PyTorch port (the JAX package's
``models/frontend.py``).

The audio (whisper conv-mel) and vision (CLIP) frontends are not reproduced;
callers supply precomputed frame/patch embeddings.  Only the thin adapter
projections that fuse those embeddings into the backbone live here.  The
audio adapter is reached through the encoder–decoder (whisper-medium).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.common import Params, linear, linear_init


def vision_adapter_init(gen, cfg, dtype, *, device: Any) -> Params:
    d = cfg.d_model
    return {"proj": linear_init(gen, d, d, dtype, device=device)}


def fuse_patches(p: Params, x: torch.Tensor, patch_embeds: torch.Tensor) -> torch.Tensor:
    """Add projected patch embeddings into the first n_patches positions."""
    n = min(patch_embeds.shape[1], x.shape[1])
    proj = linear(p["proj"], patch_embeds[:, :n].to(x.dtype))
    out = x.clone()
    out[:, :n] += proj
    return out


def audio_adapter_init(gen, cfg, dtype, *, device: Any) -> Params:
    d = cfg.d_model
    return {"proj": linear_init(gen, d, d, dtype, device=device)}


def embed_frames(p: Params, frame_embeds: torch.Tensor) -> torch.Tensor:
    """Project precomputed (B, T_frames, D) mel-frame embeddings."""
    return linear(p["proj"], frame_embeds)
