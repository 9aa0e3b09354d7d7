"""Decoder-only transformer of the PyTorch port: the attention half of the JAX
package's ``models/transformer.py``.

The layer stack is the config's ``block_pattern`` tiled to ``n_layers``, its
parameters and cache stacked on a leading pattern-group axis ``(G, ...)``
key for key as in the JAX package (``"blocks"/"00_attn"/"attn"/"wq"/...``),
so weights carry across leaf by leaf (:func:`params_from_numpy`).  JAX's
``lax.scan`` over the groups is a Python loop over ``G`` here; ``scan_layers``
changes nothing.  Three entry points:

* ``forward``     — full-sequence logits.
* ``prefill``     — full-sequence forward that also returns the decode cache.
* ``decode_step`` — one token in, logits out, and a new cache.

Covered: configs whose blocks are all ``"attn"`` with a dense FFN (Qwen2,
MiniCPM, Granite, InternLM2, and Phi-3-Vision with its vision stub).  The
mixture-of-experts FFN, the recurrent and local-attention blocks and the
encoder–decoder raise ``NotImplementedError`` (ROADMAP S11b); sharding
``rules`` raise too (ROADMAP S13).  Every quantized linear runs the bit-sliced
GEMM (``models/common.int_matmul``); under ``RunFlags.quant_kv`` the int8
scores run the row-dot kernel (``models/attention.int8_scores``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import api
from repro_torch.kernels.api import PrecisionSpec
from repro_torch.models import frontend
from repro_torch.models.attention import (
    decode_attention,
    decode_attention_int8,
    full_attention,
    quantize_kv,
)
from repro_torch.models.common import (
    Params,
    apply_rope,
    dense_init,
    dtype_of,
    linear,
    linear_init,
    rmsnorm,
    rmsnorm_init,
    swiglu,
)
from repro_torch.models.runtime import DEFAULT_FLAGS, RunFlags

# Decode-state precision (PIMSAB adaptive precision on the KV cache): int8
# payloads, one slice pair per score contraction.
KV_SPEC = PrecisionSpec.int8


def check_supported(cfg: ModelConfig, rules: Any = None) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet:
    sharding rules (ROADMAP S13) and every block or family other than
    decoder-only attention with a dense FFN (ROADMAP S11b)."""
    if rules is not None:
        raise NotImplementedError(
            "sharding rules (MeshRules) are not ported yet (ROADMAP S13, dist/sharding.py); pass rules=None")
    missing = [f"block kind {k!r}" for k in dict.fromkeys(cfg.block_pattern) if k != "attn"]
    if cfg.is_moe:
        missing.append("the mixture-of-experts FFN (moe)")
    if cfg.is_encdec:
        missing.append("the encoder-decoder (is_encdec)")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (ROADMAP S11b); the port runs "
            "decoder-only attention blocks with a dense FFN")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _device(device: Any) -> torch.device:
    """The ``meta`` device, or the device an entry point runs on."""
    return torch.device("meta") if str(device) == "meta" else api.resolve_device(device)


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _tree_leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _attn_init(gen, cfg, dtype, lead, device) -> Params:
    d = cfg.d_model
    return {
        "wq": linear_init(gen, d, cfg.q_dim, dtype, bias=cfg.qkv_bias, lead=lead, device=device),
        "wk": linear_init(gen, d, cfg.kv_dim, dtype, bias=cfg.qkv_bias, lead=lead, device=device),
        "wv": linear_init(gen, d, cfg.kv_dim, dtype, bias=cfg.qkv_bias, lead=lead, device=device),
        "wo": linear_init(gen, cfg.q_dim, d, dtype, lead=lead, device=device),
    }


def _ffn_init(gen, cfg, dtype, lead, device) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": linear_init(gen, d, f, dtype, lead=lead, device=device),
        "w_up": linear_init(gen, d, f, dtype, lead=lead, device=device),
        "w_down": linear_init(gen, f, d, dtype, lead=lead, device=device),
    }


def _block_init(gen, cfg, kind: str, dtype, lead, device) -> Params:
    """One block = norm + attention (+ norm + FFN), each leaf ``(*lead, ...)``."""
    p: Params = {"ln1": rmsnorm_init(cfg.d_model, dtype, lead=lead, device=device),
                 "attn": _attn_init(gen, cfg, dtype, lead, device)}
    if cfg.d_ff > 0:
        p["ln2"] = rmsnorm_init(cfg.d_model, dtype, lead=lead, device=device)
        p["ffn"] = _ffn_init(gen, cfg, dtype, lead, device)
    return p


def _stack_groups(gen, cfg, dtype, n_groups: int, pattern, device) -> Params:
    """Parameters of every group, stacked on a leading (G, ...) axis."""
    return {f"{i:02d}_{kind}": _block_init(gen, cfg, kind, dtype, (n_groups,), device)
            for i, kind in enumerate(pattern)}


def init_params(cfg: ModelConfig, seed: int = 0, *, device: Any = "cuda") -> Params:
    """Random parameters for ``cfg`` on ``device``, drawn from a
    ``torch.Generator`` seeded with ``seed`` on that device (the draws differ
    from the JAX package's; :func:`params_from_numpy` carries JAX's).  On the
    ``meta`` device nothing is drawn."""
    check_supported(cfg)
    dev = _device(device)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    dtype = dtype_of(cfg)
    vp = cfg.padded_vocab()
    params: Params = {
        "embed": {"w": dense_init(gen, vp, cfg.d_model, dtype, scale=0.02, device=dev)},
        "blocks": _stack_groups(gen, cfg, dtype, cfg.pattern_groups(), cfg.block_pattern, dev),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": dense_init(gen, cfg.d_model, vp, dtype, scale=0.02, device=dev)}
    if cfg.frontend == "vision":
        params["vision_adapter"] = frontend.vision_adapter_init(gen, cfg, dtype, device=dev)
    return params


def params_shape(cfg: ModelConfig) -> Params:
    """The parameter tree on the ``meta`` device: shapes and dtypes, no
    storage."""
    return init_params(cfg, device="meta")


def param_bytes(tree) -> int:
    return sum(leaf.numel() * leaf.element_size() for leaf in _tree_leaves(tree))


def _leaf_from_numpy(a: Any, dev: torch.device) -> torch.Tensor:
    a = np.array(a)  # a writable copy (JAX's arrays are read-only)
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 (JAX's arrays come as ml_dtypes.bfloat16,
        # which torch.from_numpy refuses): carry the bits as uint16
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def params_from_numpy(tree: Any, device: Any = "cuda") -> Any:
    """The port's tree from a nested dict of arrays with the JAX package's
    keys and dtypes (``jax.tree_util.tree_map(np.asarray, ...)`` of its
    ``init_params``, ``maybe_quantize_tree`` or cache), every leaf on
    ``device`` with the same dtype and bits."""
    dev = api.resolve_device(device)
    return _tree_map(lambda a: _leaf_from_numpy(a, dev), tree)


# ---------------------------------------------------------------------------
# block application (sequence form)
# ---------------------------------------------------------------------------


def _attn_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, flags: RunFlags, positions: torch.Tensor,
                causal: bool) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = linear(p["wq"], x).reshape(b, s, cfg.n_heads, hd)
    k = linear(p["wk"], x).reshape(b, s, cfg.n_kv_heads, hd)
    v = linear(p["wv"], x).reshape(b, s, cfg.n_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = full_attention(q, k, v, causal=causal, chunk=flags.attn_chunk, triangular=flags.triangular_attn,
                         flash_threshold=flags.flash_threshold)
    y = linear(p["wo"], out.reshape(b, s, cfg.q_dim))
    return y, {"k": k, "v": v}


def _ffn_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    return linear(p["w_down"], swiglu(linear(p["w_gate"], x), linear(p["w_up"], x)))


def _block_apply_seq(p: Params, x: torch.Tensor, cfg: ModelConfig, flags: RunFlags,
                     positions: torch.Tensor, causal: bool) -> Tuple[torch.Tensor, Params]:
    """Returns (x_out, new cache entries)."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    y, kv = _attn_apply(p["attn"], h, cfg, flags, positions, causal)
    x = x + y
    if "ffn" in p:
        x = x + _ffn_apply(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x, kv


def _group(tree: Params, gi: int) -> Params:
    return _tree_map(lambda leaf: leaf[gi], tree)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _embed_tokens(params: Params, tokens: torch.Tensor, cfg) -> torch.Tensor:
    x = params["embed"]["w"][tokens]
    # JAX multiplies by jnp.asarray(sqrt(d), x.dtype): a constant rounded to
    # the activation dtype first (a bfloat16 29.93 is 30.0), not the float32 value
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)


def _embed_batch(params: Params, cfg, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    x = _embed_tokens(params, batch["tokens"], cfg)
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        x = frontend.fuse_patches(params["vision_adapter"], x, batch["patch_embeds"])
    return x


def _lm_head(params: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed"]["w"].T
    return linear(params["lm_head"], x)  # the quantized head runs the bit-sliced GEMM


def forward(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], flags: RunFlags = DEFAULT_FLAGS,
            rules: Any = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits.  Returns (logits, aux_loss); the aux loss is 0
    (no mixture-of-experts FFN is ported)."""
    check_supported(cfg, rules)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    x = _embed_batch(params, cfg, batch)
    positions = torch.arange(s, device=tokens.device)[None]
    for gi in range(cfg.pattern_groups()):
        gp = _group(params["blocks"], gi)
        for i, kind in enumerate(cfg.block_pattern):
            x, _ = _block_apply_seq(gp[f"{i:02d}_{kind}"], x, cfg, flags, positions, causal=True)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _lm_head(params, x, cfg), torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def _cache_entry_shape(cfg, kind: str, batch: int, max_len: int, flags=DEFAULT_FLAGS,
                       lead: tuple = (), device: Any = None) -> Dict[str, torch.Tensor]:
    hd, hkv = cfg.resolved_head_dim, cfg.n_kv_heads
    shp = (*lead, batch, max_len, hkv, hd)
    if flags.quant_kv:
        # int8 payload + per-(b, t, h) scales (PIMSAB adaptive precision on state)
        return {
            "k": torch.zeros(shp, dtype=torch.int8, device=device),
            "v": torch.zeros(shp, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shp[:-1], dtype=torch.float32, device=device),
            "v_scale": torch.zeros(shp[:-1], dtype=torch.float32, device=device),
        }
    dt = dtype_of(cfg)
    return {"k": torch.zeros(shp, dtype=dt, device=device), "v": torch.zeros(shp, dtype=dt, device=device)}


def _host_pos(pos: int) -> torch.Tensor:
    # The position lives on the host: every layer of a decode step indexes
    # the cache with it, and a device scalar would cost a sync per layer.
    return torch.tensor(pos, dtype=torch.int32)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, flags: RunFlags = DEFAULT_FLAGS, *,
               device: Any = "cuda") -> Params:
    """Decode cache: stacked (G, ...) per pattern position, plus the
    position, an int32 scalar on the host."""
    check_supported(cfg)
    dev = _device(device)
    g = cfg.pattern_groups()
    return {
        "pos": _host_pos(0),
        "blocks": {f"{i:02d}_{kind}": _cache_entry_shape(cfg, kind, batch, max_len, flags, (g,), dev)
                   for i, kind in enumerate(cfg.block_pattern)},
    }


def cache_shape(cfg: ModelConfig, batch: int, max_len: int, flags: RunFlags = DEFAULT_FLAGS) -> Params:
    """The cache tree on the ``meta`` device (the position stays a host scalar)."""
    return init_cache(cfg, batch, max_len, flags, device="meta")


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


def _seq_cache_to_decode_cache(entries: Params, s: int, max_len: int, flags: RunFlags = DEFAULT_FLAGS) -> Params:
    """Full-sequence K/V (B,S,Hkv,hd) → decode-cache layout: zero-padded to
    ``max_len`` rows (a longer prompt keeps its S rows, as in JAX), int8
    payloads and scales under ``quant_kv``."""
    out = {}
    for n in ("k", "v"):
        kv = entries[n]
        pad = max_len - s
        if pad > 0:
            kv = torch.cat([kv, kv.new_zeros((kv.shape[0], pad, *kv.shape[2:]))], dim=1)
        out[n] = kv
    if not flags.quant_kv:
        return out
    q = {}
    for n in ("k", "v"):
        q[n], q[f"{n}_scale"] = quantize_kv(out[n], KV_SPEC)
    return q


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], flags: RunFlags = DEFAULT_FLAGS,
            rules: Any = None, max_len: Optional[int] = None) -> Tuple[Params, torch.Tensor]:
    """Run the prompt, return (cache, last-token logits)."""
    check_supported(cfg, rules)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    max_len = max_len or s
    x = _embed_batch(params, cfg, batch)
    positions = torch.arange(s, device=tokens.device)[None]
    per_group = []
    for gi in range(cfg.pattern_groups()):
        gp = _group(params["blocks"], gi)
        entries = {}
        for i, kind in enumerate(cfg.block_pattern):
            key = f"{i:02d}_{kind}"
            x, kv = _block_apply_seq(gp[key], x, cfg, flags, positions, causal=True)
            entries[key] = _seq_cache_to_decode_cache(kv, s, max_len, flags)
        per_group.append(entries)
    blocks = {key: {n: torch.stack([e[key][n] for e in per_group]) for n in per_group[0][key]}
              for key in per_group[0]}
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = _lm_head(params, x[:, -1:], cfg)[:, 0]
    return {"pos": _host_pos(s), "blocks": blocks}, logits


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------


def _write_row(cache: torch.Tensor, new: torch.Tensor, slot: int) -> None:
    """Row ``slot`` of axis 1 of ``cache`` ← ``new`` (one row), in place."""
    cache[:, slot:slot + 1] = new


def _attn_decode(p: Params, h: torch.Tensor, cfg, entry: Params, pos: int) -> torch.Tensor:
    """One token of attention; writes its K/V row into ``entry`` (a group's
    views of the step's fresh cache) in place and returns the block output."""
    b = h.shape[0]
    hd = cfg.resolved_head_dim
    q = linear(p["wq"], h).reshape(b, 1, cfg.n_heads, hd)
    k = linear(p["wk"], h).reshape(b, 1, cfg.n_kv_heads, hd)
    v = linear(p["wv"], h).reshape(b, 1, cfg.n_kv_heads, hd)
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=h.device)
    q = apply_rope(q, posb, cfg.rope_theta)
    k = apply_rope(k, posb, cfg.rope_theta)
    t = entry["k"].shape[1]
    # jax.lax.dynamic_update_slice clamps its start into range: past the
    # cache's end (a prompt plus its new tokens longer than max_len) JAX
    # overwrites the last row, where torch indexing would raise
    slot = min(max(pos, 0), t - 1)
    valid = torch.full((b,), pos + 1, dtype=torch.int32, device=h.device)
    if "k_scale" in entry:  # int8 KV cache (PIMSAB adaptive precision)
        kq, ks = quantize_kv(k, KV_SPEC)
        vq, vs = quantize_kv(v, KV_SPEC)
        for n, new in (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs)):
            _write_row(entry[n], new, slot)
        out = decode_attention_int8(q, entry["k"], entry["v"], entry["k_scale"], entry["v_scale"], valid,
                                    KV_SPEC)
    else:
        _write_row(entry["k"], k, slot)
        _write_row(entry["v"], v, slot)
        out = decode_attention(q, entry["k"], entry["v"], valid)
    return linear(p["wo"], out.reshape(b, 1, cfg.q_dim))


def decode_step(params: Params, cfg: ModelConfig, cache: Params, tokens: torch.Tensor,
                flags: RunFlags = DEFAULT_FLAGS, rules: Any = None) -> Tuple[Params, torch.Tensor]:
    """tokens: (B, 1).  Returns (new_cache, logits (B, vocab)).

    The given cache is left as it was: the step clones each cache leaf once
    and writes the new K/V rows into the clones.  ``cache["pos"]`` is read
    once, on the host (see :func:`init_cache`)."""
    check_supported(cfg, rules)
    pos = int(cache["pos"])
    x = _embed_tokens(params, tokens, cfg)
    blocks = _tree_map(torch.clone, cache["blocks"])
    for gi in range(cfg.pattern_groups()):
        gp, gc = _group(params["blocks"], gi), _group(blocks, gi)
        for i, kind in enumerate(cfg.block_pattern):
            key = f"{i:02d}_{kind}"
            p = gp[key]
            x = x + _attn_decode(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps), cfg, gc[key], pos)
            if "ffn" in p:
                x = x + _ffn_apply(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = _lm_head(params, x, cfg)[:, 0]
    return {"pos": _host_pos(pos + 1), "blocks": blocks}, logits
