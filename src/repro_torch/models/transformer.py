"""Composable transformer of the PyTorch port: one model assembly for every
architecture of ``repro_torch.configs`` (dense GQA, MoE, the RG-LRU hybrid,
xLSTM, the encoder–decoder audio model, the VLM stub), the port's copy of
the JAX package's ``models/transformer.py``.

The layer stack is the config's ``block_pattern`` tiled to ``n_layers``, its
parameters and cache stacked on a leading pattern-group axis ``(G, ...)``
key for key as in the JAX package (``"blocks"/"00_attn"/"attn"/"wq"/...``),
so weights carry across leaf by leaf (:func:`params_from_numpy`).  JAX's
``lax.scan`` over the groups is a Python loop over ``G`` here; ``scan_layers``
changes nothing.  Four entry points:

* ``forward``     — full-sequence logits and the summed MoE aux loss.
* ``loss_fn``     — the training loss (cross-entropy + 0.01 · aux).
* ``prefill``     — full-sequence forward that also returns the decode cache.
* ``decode_step`` — one token in, logits out, and a new cache.

Sharding ``rules`` raise ``NotImplementedError`` (ROADMAP S13).  Every
quantized linear runs the bit-sliced GEMM (``models/common.int_matmul``);
under ``RunFlags.quant_kv`` the int8 scores run the row-dot kernel
(``models/attention.int8_scores``); an RG-LRU prefill runs the RG-LRU scan
kernel (``models/recurrent.rglru_block_apply``).
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
    local_attention,
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
    softmax_cross_entropy,
    swiglu,
)
from repro_torch.models.moe import moe_ffn, moe_init
from repro_torch.models.recurrent import (
    mlstm_block_apply,
    mlstm_block_init,
    mlstm_full_state_init,
    rglru_block_apply,
    rglru_block_init,
    rglru_state_init,
    slstm_block_apply,
    slstm_block_init,
    slstm_state_init,
)
from repro_torch.models.runtime import DEFAULT_FLAGS, RunFlags

# Decode-state precision (PIMSAB adaptive precision on the KV cache): int8
# payloads, one slice pair per score contraction.
KV_SPEC = PrecisionSpec.int8


def check_supported(cfg: ModelConfig, rules: Any = None) -> None:
    """Raise ``NotImplementedError`` for sharding rules, which the port does
    not run yet (ROADMAP S13); every block kind and family of the configs
    runs."""
    if rules is not None:
        raise NotImplementedError(
            f"{cfg.name}: sharding rules (MeshRules) are not ported yet (ROADMAP S13, dist/sharding.py); "
            "pass rules=None")


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


def _zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=device)


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


_MIXER_INIT = {"rglru": rglru_block_init, "mlstm": mlstm_block_init, "slstm": slstm_block_init}
_MIXER_APPLY = {"rglru": rglru_block_apply, "mlstm": mlstm_block_apply, "slstm": slstm_block_apply}


def _block_init(gen, cfg, kind: str, dtype, lead, device, decoder: bool) -> Params:
    """One block = norm + temporal mixer (+ cross-attention) (+ norm + FFN),
    each leaf ``(*lead, ...)``."""
    p: Params = {"ln1": rmsnorm_init(cfg.d_model, dtype, lead=lead, device=device)}
    if kind in ("attn", "local_attn"):
        p["attn"] = _attn_init(gen, cfg, dtype, lead, device)
    elif kind in _MIXER_INIT:
        p["mixer"] = _MIXER_INIT[kind](gen, cfg, dtype, lead=lead, device=device)
    else:
        raise ValueError(kind)
    if decoder and cfg.is_encdec:
        p["lnx"] = rmsnorm_init(cfg.d_model, dtype, lead=lead, device=device)
        p["cross"] = _attn_init(gen, cfg, dtype, lead, device)
    if cfg.d_ff > 0 and kind in ("attn", "local_attn", "rglru"):
        p["ln2"] = rmsnorm_init(cfg.d_model, dtype, lead=lead, device=device)
        p["ffn"] = (moe_init(gen, cfg, dtype, lead=lead, device=device) if cfg.is_moe
                    else _ffn_init(gen, cfg, dtype, lead, device))
    return p


def _stack_groups(gen, cfg, dtype, n_groups: int, pattern, device, decoder: bool) -> Params:
    """Parameters of every group, stacked on a leading (G, ...) axis."""
    return {f"{i:02d}_{kind}": _block_init(gen, cfg, kind, dtype, (n_groups,), device, decoder)
            for i, kind in enumerate(pattern)}


def init_params(cfg: ModelConfig, seed: int = 0, *, device: Any = "cuda") -> Params:
    """Random parameters for ``cfg`` on ``device``, drawn from a
    ``torch.Generator`` seeded with ``seed`` on that device (the draws differ
    from the JAX package's; :func:`params_from_numpy` carries JAX's).  On the
    ``meta`` device nothing is drawn."""
    dev = _device(device)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    dtype = dtype_of(cfg)
    vp = cfg.padded_vocab()
    params: Params = {
        "embed": {"w": dense_init(gen, vp, cfg.d_model, dtype, scale=0.02, device=dev)},
        "blocks": _stack_groups(gen, cfg, dtype, cfg.pattern_groups(), cfg.block_pattern, dev, decoder=True),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": dense_init(gen, cfg.d_model, vp, dtype, scale=0.02, device=dev)}
    if cfg.is_encdec:
        params["enc_blocks"] = _stack_groups(gen, cfg, dtype, cfg.n_enc_layers, ("attn",), dev, decoder=False)
        params["enc_norm"] = rmsnorm_init(cfg.d_model, dtype, device=dev)
        params["audio_adapter"] = frontend.audio_adapter_init(gen, cfg, dtype, device=dev)
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
                kind: str, causal: bool) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = linear(p["wq"], x).reshape(b, s, cfg.n_heads, hd)
    k = linear(p["wk"], x).reshape(b, s, cfg.n_kv_heads, hd)
    v = linear(p["wv"], x).reshape(b, s, cfg.n_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if kind == "local_attn":
        # both keep w + 1 keys (qpos - kpos <= window), one more than decode's ring
        if s <= 2 * cfg.window and s <= flags.flash_threshold:
            out = local_attention(q, k, v, cfg.window)  # small-S direct band
        else:
            out = full_attention(q, k, v, causal=causal, chunk=min(flags.attn_chunk, cfg.window),
                                 triangular=flags.triangular_attn, flash_threshold=0, window=cfg.window)
    else:
        out = full_attention(q, k, v, causal=causal, chunk=flags.attn_chunk, triangular=flags.triangular_attn,
                             flash_threshold=flags.flash_threshold)
    y = linear(p["wo"], out.reshape(b, s, cfg.q_dim))
    return y, {"k": k, "v": v}


def _cross_apply(p: Params, x: torch.Tensor, enc_kv: Dict[str, torch.Tensor], cfg) -> torch.Tensor:
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = linear(p["wq"], x).reshape(b, s, cfg.n_heads, hd)
    out = full_attention(q, enc_kv["k"], enc_kv["v"], causal=False, chunk=2048, triangular=False,
                         flash_threshold=8192)
    return linear(p["wo"], out.reshape(b, s, cfg.q_dim))


def _cross_kv(p: Params, enc_out: torch.Tensor, cfg) -> Dict[str, torch.Tensor]:
    b, t, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    return {
        "k": linear(p["wk"], enc_out).reshape(b, t, cfg.n_kv_heads, hd),
        "v": linear(p["wv"], enc_out).reshape(b, t, cfg.n_kv_heads, hd),
    }


def _ffn_apply(p: Params, x: torch.Tensor, cfg, flags: RunFlags) -> Tuple[torch.Tensor, torch.Tensor]:
    """(output, aux loss).  MoE routes per group: ``flags.routing_groups``
    (else one group, JAX's rule without sharding rules), lowered until it
    divides the tokens."""
    if cfg.is_moe:
        groups = flags.routing_groups or 1
        tokens = x.shape[0] * x.shape[1]
        while tokens % groups:
            groups -= 1
        return moe_ffn(p, x, cfg, groups)
    return linear(p["w_down"], swiglu(linear(p["w_gate"], x), linear(p["w_up"], x))), _zero(x.device)


def _block_apply_seq(p: Params, x: torch.Tensor, kind: str, cfg: ModelConfig, flags: RunFlags,
                     positions: torch.Tensor, enc_out: Optional[torch.Tensor],
                     causal: bool) -> Tuple[torch.Tensor, Params, torch.Tensor]:
    """Returns (x_out, new cache entries, aux loss).  A recurrent block starts
    from a zero state; the mLSTM chunk is ``attn_chunk`` capped at 256."""
    aux = _zero(x.device)
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind in ("attn", "local_attn"):
        y, cache_out = _attn_apply(p["attn"], h, cfg, flags, positions, kind, causal)
    else:
        kw = {"chunk": min(flags.attn_chunk, 256)} if kind == "mlstm" else {}
        y, cache_out = _MIXER_APPLY[kind](p["mixer"], h, cfg, None, **kw)
    x = x + y
    if "cross" in p and enc_out is not None:
        hx = rmsnorm(p["lnx"], x, cfg.norm_eps)
        kvx = _cross_kv(p["cross"], enc_out, cfg)
        x = x + _cross_apply(p["cross"], hx, kvx, cfg)
        cache_out["cross_k"], cache_out["cross_v"] = kvx["k"], kvx["v"]
    if "ffn" in p:
        y2, a = _ffn_apply(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg, flags)
        x = x + y2
        aux = aux + a
    return x, cache_out, aux


def _group(tree: Params, gi: int) -> Params:
    return _tree_map(lambda leaf: leaf[gi], tree)


# ---------------------------------------------------------------------------
# forward and loss
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


def _run_encoder(params: Params, cfg, flags: RunFlags, frame_embeds: torch.Tensor) -> torch.Tensor:
    """The encoder of an encoder–decoder model: the audio adapter over the
    frame embeddings, non-causal attention blocks, then ``enc_norm``."""
    x = frontend.embed_frames(params["audio_adapter"], frame_embeds.to(dtype_of(cfg)))
    positions = torch.arange(x.shape[1], device=x.device)[None]
    for gi in range(cfg.n_enc_layers):
        gp = _group(params["enc_blocks"], gi)
        x, _, _ = _block_apply_seq(gp["00_attn"], x, "attn", cfg, flags, positions, None, causal=False)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _encoder_out(params: Params, cfg, flags: RunFlags, batch: Dict[str, torch.Tensor]) -> Optional[torch.Tensor]:
    return _run_encoder(params, cfg, flags, batch["enc_embeds"]) if cfg.is_encdec else None


def _lm_head(params: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed"]["w"].T
    return linear(params["lm_head"], x)  # the quantized head runs the bit-sliced GEMM


def forward(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], flags: RunFlags = DEFAULT_FLAGS,
            rules: Any = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits.  Returns (logits, aux_loss): the float32 sum of
    the MoE load-balance losses over blocks (0 without MoE).  An
    encoder–decoder batch carries ``enc_embeds`` (B, T_frames, d)."""
    check_supported(cfg, rules)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    x = _embed_batch(params, cfg, batch)
    enc_out = _encoder_out(params, cfg, flags, batch)
    positions = torch.arange(s, device=tokens.device)[None]
    aux = _zero(x.device)
    for gi in range(cfg.pattern_groups()):
        gp = _group(params["blocks"], gi)
        for i, kind in enumerate(cfg.block_pattern):
            x, _, a = _block_apply_seq(gp[f"{i:02d}_{kind}"], x, kind, cfg, flags, positions, enc_out, causal=True)
            aux = aux + a
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _lm_head(params, x, cfg), aux


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], flags: RunFlags = DEFAULT_FLAGS,
            rules: Any = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(ce + 0.01 · aux, {"ce": ce, "aux": aux}) over ``batch["labels"]``."""
    logits, aux = forward(params, cfg, batch, flags, rules)
    ce = softmax_cross_entropy(logits, batch["labels"], cfg.vocab_size)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# KV / state cache
# ---------------------------------------------------------------------------


def _cache_entry_shape(cfg, kind: str, batch: int, max_len: int, flags=DEFAULT_FLAGS,
                       lead: tuple = (), device: Any = None) -> Dict[str, torch.Tensor]:
    hd, hkv = cfg.resolved_head_dim, cfg.n_kv_heads
    dt = dtype_of(cfg)

    def kv_entry(length):
        shp = (*lead, batch, length, hkv, hd)
        if flags.quant_kv:
            # int8 payload + per-(b, t, h) scales (PIMSAB adaptive precision on state)
            return {
                "k": torch.zeros(shp, dtype=torch.int8, device=device),
                "v": torch.zeros(shp, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shp[:-1], dtype=torch.float32, device=device),
                "v_scale": torch.zeros(shp[:-1], dtype=torch.float32, device=device),
            }
        return {"k": torch.zeros(shp, dtype=dt, device=device), "v": torch.zeros(shp, dtype=dt, device=device)}

    if kind == "attn":
        entry = kv_entry(max_len)
    elif kind == "local_attn":
        entry = kv_entry(min(cfg.window, max_len))
    elif kind == "rglru":
        entry = rglru_state_init(cfg, batch, lead=lead, device=device)
    elif kind == "mlstm":
        entry = mlstm_full_state_init(cfg, batch, lead=lead, device=device)
    elif kind == "slstm":
        entry = slstm_state_init(cfg, batch, lead=lead, device=device)
    else:
        raise ValueError(kind)
    if cfg.is_encdec and kind == "attn":
        # the encoder's K/V stay in the activation dtype, also under quant_kv
        xshp = (*lead, batch, cfg.enc_seq_len, hkv, hd)
        entry["cross_k"] = torch.zeros(xshp, dtype=dt, device=device)
        entry["cross_v"] = torch.zeros(xshp, dtype=dt, device=device)
    return entry


def _host_pos(pos: int) -> torch.Tensor:
    # The position lives on the host: every layer of a decode step indexes
    # the cache with it, and a device scalar would cost a sync per layer.
    return torch.tensor(pos, dtype=torch.int32)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, flags: RunFlags = DEFAULT_FLAGS, *,
               device: Any = "cuda") -> Params:
    """Decode cache: stacked (G, ...) per pattern position, plus the
    position, an int32 scalar on the host."""
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


def _pad_rows(kv: torch.Tensor, rows: int) -> torch.Tensor:
    """``kv`` (B,S,...) zero-padded on axis 1 by ``rows``."""
    return torch.cat([kv, kv.new_zeros((kv.shape[0], rows, *kv.shape[2:]))], dim=1)


def _seq_cache_to_decode_cache(entries: Params, kind: str, cfg, s: int, max_len: int,
                               flags: RunFlags = DEFAULT_FLAGS) -> Params:
    """Full-sequence block outputs → decode-cache layout.

    ``attn``: K/V (B,S,Hkv,hd) zero-padded to ``max_len`` rows (a longer
    prompt keeps its S rows, as in JAX).  ``local_attn``: the last
    ``w = min(window, max_len)`` rows from slot 0, or the prompt padded to
    ``w`` (decode then writes slot ``pos % w``: once ``s > w`` and
    ``s % w != 0`` its first step evicts a token that is not the oldest, a
    property of the JAX package kept here).  Under ``quant_kv`` int8
    payloads and scales; ``cross_k``/``cross_v`` stay as they are.
    Recurrent states pass through."""
    if kind not in ("attn", "local_attn"):
        return dict(entries)
    out = {}
    if kind == "attn":
        for n in ("k", "v"):
            out[n] = _pad_rows(entries[n], max_len - s) if max_len > s else entries[n]
    else:
        w = min(cfg.window, max_len)
        for n in ("k", "v"):
            out[n] = entries[n][:, s - w:s] if s >= w else _pad_rows(entries[n], w - s)
    if flags.quant_kv:
        for n in ("k", "v"):
            out[n], out[f"{n}_scale"] = quantize_kv(out[n], KV_SPEC)
    for n in ("cross_k", "cross_v"):
        if n in entries:
            out[n] = entries[n]
    return out


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], flags: RunFlags = DEFAULT_FLAGS,
            rules: Any = None, max_len: Optional[int] = None) -> Tuple[Params, torch.Tensor]:
    """Run the prompt, return (cache, last-token logits)."""
    check_supported(cfg, rules)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    max_len = max_len or s
    x = _embed_batch(params, cfg, batch)
    enc_out = _encoder_out(params, cfg, flags, batch)
    positions = torch.arange(s, device=tokens.device)[None]
    per_group = []
    for gi in range(cfg.pattern_groups()):
        gp = _group(params["blocks"], gi)
        entries = {}
        for i, kind in enumerate(cfg.block_pattern):
            key = f"{i:02d}_{kind}"
            x, new, _ = _block_apply_seq(gp[key], x, kind, cfg, flags, positions, enc_out, causal=True)
            entries[key] = _seq_cache_to_decode_cache(new, kind, cfg, s, max_len, flags)
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


def _attn_decode(p: Params, h: torch.Tensor, cfg, entry: Params, pos: int, kind: str) -> torch.Tensor:
    """One token of attention; writes its K/V row into ``entry`` (a group's
    views of the step's fresh cache) in place and returns the block output.

    ``local_attn`` keeps a ring of ``w`` rows: the row goes to slot
    ``pos % w`` and the ``min(pos + 1, w)`` rows from slot 0 are live (RoPE
    was applied at insert, so their order does not matter)."""
    b = h.shape[0]
    hd = cfg.resolved_head_dim
    q = linear(p["wq"], h).reshape(b, 1, cfg.n_heads, hd)
    k = linear(p["wk"], h).reshape(b, 1, cfg.n_kv_heads, hd)
    v = linear(p["wv"], h).reshape(b, 1, cfg.n_kv_heads, hd)
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=h.device)
    q = apply_rope(q, posb, cfg.rope_theta)
    k = apply_rope(k, posb, cfg.rope_theta)
    t = entry["k"].shape[1]
    if kind == "local_attn":
        slot, live = pos % t, min(pos + 1, t)
    else:
        # jax.lax.dynamic_update_slice clamps its start into range: past the
        # cache's end (a prompt plus its new tokens longer than max_len) JAX
        # overwrites the last row, where torch indexing would raise
        slot, live = min(max(pos, 0), t - 1), pos + 1
    valid = torch.full((b,), live, dtype=torch.int32, device=h.device)
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


def _cross_decode(p: Params, hx: torch.Tensor, cfg, entry: Params) -> torch.Tensor:
    """One token of cross-attention over the cached encoder K/V."""
    b = hx.shape[0]
    xq = linear(p["wq"], hx).reshape(b, 1, cfg.n_heads, cfg.resolved_head_dim)
    out = decode_attention(xq, entry["cross_k"], entry["cross_v"])
    return linear(p["wo"], out.reshape(b, 1, cfg.q_dim))


def decode_step(params: Params, cfg: ModelConfig, cache: Params, tokens: torch.Tensor,
                flags: RunFlags = DEFAULT_FLAGS, rules: Any = None) -> Tuple[Params, torch.Tensor]:
    """tokens: (B, 1).  Returns (new_cache, logits (B, vocab)).

    The given cache is left as it was: the step clones each cache leaf once,
    writes the new K/V rows into the clones and copies each recurrent
    block's new state over its clone.  ``cache["pos"]`` is read once, on the
    host (see :func:`init_cache`)."""
    check_supported(cfg, rules)
    pos = int(cache["pos"])
    x = _embed_tokens(params, tokens, cfg)
    blocks = _tree_map(torch.clone, cache["blocks"])
    for gi in range(cfg.pattern_groups()):
        gp, gc = _group(params["blocks"], gi), _group(blocks, gi)
        for i, kind in enumerate(cfg.block_pattern):
            key = f"{i:02d}_{kind}"
            p, entry = gp[key], gc[key]
            h = rmsnorm(p["ln1"], x, cfg.norm_eps)
            if kind in ("attn", "local_attn"):
                y = _attn_decode(p["attn"], h, cfg, entry, pos, kind)
            else:
                y, st = _MIXER_APPLY[kind](p["mixer"], h, cfg, entry)
                for n, leaf in st.items():
                    entry[n].copy_(leaf)
            x = x + y
            if "cross" in p:
                x = x + _cross_decode(p["cross"], rmsnorm(p["lnx"], x, cfg.norm_eps), cfg, entry)
            if "ffn" in p:
                y2, _ = _ffn_apply(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg, flags)
                x = x + y2
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = _lm_head(params, x, cfg)[:, 0]
    return {"pos": _host_pos(pos + 1), "blocks": blocks}, logits
