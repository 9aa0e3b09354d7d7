"""Composable transformer of the PyTorch port: one model assembly for every
architecture of ``repro_torch.configs`` (dense GQA, MoE, the RG-LRU hybrid,
xLSTM, the encoder–decoder audio model, the VLM stub), the port's copy of
the JAX package's ``models/transformer.py``; beside them the DeepSeek-V3
architecture (``configs.base.MLAMoEConfig``, which the JAX package lacks):
latent attention (kinds ``"mla"`` and ``"mla_moe"``) whose decode cache
holds the normed latent and the RoPE'd shared key part (``c_kv``, ``k_pe``)
and expands them through ``wkv_b`` each step, a dense SwiGLU in the leading
layers and dropless routed plus shared experts (``moe.dropless_moe_ffn``)
in the rest; no sharding rules, no ``quant_kv``.

The layer stack is the config's ``block_pattern`` tiled to ``n_layers``, its
parameters and cache stacked on a leading pattern-group axis ``(G, ...)``
key for key as in the JAX package (``"blocks"/"00_attn"/"attn"/"wq"/...``),
so weights carry across leaf by leaf (:func:`params_from_numpy`).  JAX's
``lax.scan`` over the groups is a Python loop over ``G`` here; ``scan_layers``
changes nothing.  Four entry points:

* ``forward``     — full-sequence logits and the summed MoE aux loss.
* ``loss_fn``     — the training loss (cross-entropy + 0.01 · aux); under
  ``RunFlags.remat`` each block is rematerialized in the backward.
* ``prefill``     — full-sequence forward that also returns the decode cache.
* ``decode_step`` — one token in, logits out, and a new cache.

Sharding ``rules`` (``dist.sharding.MeshRules``) run SPMD: each entry
point takes the global batch, this rank keeps its rows
(``sharding.batch_shard``) and returns JAX's global values (logits
gathered over the data axes, the aux loss their mean); a decode cache stays
this rank's shard.  MoE routes per data shard as JAX does (``_ffn_apply``).
On a model axis wider than one each rank holds its slices of the leaves
``param_specs`` shards (``sharding.shard_params``) and runs them
Megatron-style (``common.tp_linear``): the query heads, and the KV heads
when they divide, column-parallel with ``wo`` row-parallel, the FFN
likewise, the experts split over the axis, the embedding vocab-parallel
(a masked lookup summed over the axis) and the head column-parallel with
its vocabulary gathered.  A rank whose KV heads replicate takes the ones
its query heads need (``_local_kv``).  The cache follows
``serve.engine.cache_specs``: KV heads on the axis when they divide, else,
under ``RunFlags.seq_shard_kv``, the rows of each leaf the specs shard on
it, which a decode step gathers and gives back (``cache["seq_sharded"]``
names them).  Every quantized linear runs
the bit-sliced GEMM (``models/common.int_matmul``); under
``RunFlags.quant_kv`` the int8 scores run the row-dot kernel
(``models/attention.int8_scores``); an RG-LRU prefill runs the RG-LRU scan
kernel (``models/recurrent.rglru_block_apply``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import obs
from repro_torch.configs.base import MLA_KINDS, MLAMoEConfig, ModelConfig
from repro_torch.dist import collectives, sharding
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
    cross_entropy_sum,
    swiglu,
    tp_gathered,
    tp_linear,
)
from repro_torch.models.moe import dropless_moe_ffn, dropless_moe_init, moe_ffn, moe_init
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
    """Every block kind and family of the configs runs, without rules or
    under a ``MeshRules`` on a process mesh (ROADMAP S13, S13b).  Rules of
    another type raise ``TypeError``; a mesh with no ranks and a model axis
    wider than one describes a layout and cannot run (``ValueError``
    naming ``launch.mesh.make_host_mesh``)."""
    if rules is None:
        return
    if any(kind in MLA_KINDS for kind in cfg.block_pattern):
        raise NotImplementedError(f"{cfg.name}: latent attention does not run under sharding rules")
    if not isinstance(rules, sharding.MeshRules):
        raise TypeError(f"{cfg.name}: rules must be a dist.sharding.MeshRules (ROADMAP S13), "
                        f"not {type(rules).__name__}")
    try:
        sharding.model_group(rules)
    except ValueError as e:
        raise ValueError(f"{cfg.name}: {e}") from None


def _shard_of(cfg: ModelConfig, rules: Any, batch: int
              ) -> Tuple[Optional[sharding.BatchShard], Optional[sharding.ModelShard]]:
    """This rank's rows of a ``batch``-row global batch and its place on the
    model axis under ``rules`` (None, None without rules), after
    :func:`check_supported`."""
    check_supported(cfg, rules)
    if rules is None:
        return None, None
    return sharding.batch_shard(rules, batch), sharding.model_shard(rules)


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
    if kind in MLA_KINDS:
        p["attn"] = _mla_init(gen, cfg, dtype, lead, device)
        p["ln2"] = rmsnorm_init(cfg.d_model, dtype, lead=lead, device=device)
        p["ffn"] = (_ffn_init(gen, cfg, dtype, lead, device) if kind == "mla"
                    else dropless_moe_init(gen, cfg, dtype, lead=lead, device=device))
        return p
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


def _local_kv(kv: Tuple[torch.Tensor, ...], cfg, ms, hq: int) -> Tuple[torch.Tensor, ...]:
    """The KV heads (dim 2 of each of ``kv``) that this rank's ``hq`` query
    heads attend with under GQA.  They are the tensors themselves unless the
    query heads are split over the model axis and the KV heads are not:
    then the heads its query heads need, contiguous when each of them serves
    as many local query heads, else one a query head."""
    if ms is None or hq == cfg.n_heads or kv[0].shape[2] != cfg.n_kv_heads:
        return kv
    g = cfg.n_heads // cfg.n_kv_heads
    heads = [(ms.start(cfg.n_heads) + i) // g for i in range(hq)]
    lo, hi = heads[0], heads[-1] + 1
    kv = tuple(collectives.copy_to_model(t, ms) for t in kv)
    if len({heads.count(j) for j in range(lo, hi)}) == 1:
        return tuple(t[:, :, lo:hi] for t in kv)
    idx = torch.tensor(heads, device=kv[0].device)
    return tuple(t.index_select(2, idx) for t in kv)


def _qkv(p: Params, x: torch.Tensor, cfg, ms) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Query, key and value heads (B, S, heads, hd): this rank's heads of
    each projection that the model axis splits."""
    b, s, d = x.shape
    hd = cfg.resolved_head_dim
    q = tp_linear(p["wq"], x, ms, d, cfg.q_dim).reshape(b, s, -1, hd)
    k = tp_linear(p["wk"], x, ms, d, cfg.kv_dim).reshape(b, s, -1, hd)
    v = tp_linear(p["wv"], x, ms, d, cfg.kv_dim).reshape(b, s, -1, hd)
    return q, k, v


def _attn_out(p: Params, out: torch.Tensor, cfg, ms) -> torch.Tensor:
    """``wo`` over the attention output of this rank's query heads."""
    b, s = out.shape[:2]
    return tp_linear(p["wo"], out.reshape(b, s, -1), ms, cfg.q_dim, cfg.d_model)


def _attn_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, flags: RunFlags, positions: torch.Tensor,
                kind: str, causal: bool, ms=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    q, k, v = _qkv(p, x, cfg, ms)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    cache = {"k": k, "v": v}
    with obs.span("model.attention"):
        k, v = _local_kv((k, v), cfg, ms, q.shape[2])
        s = x.shape[1]
        if kind == "local_attn":
            # both keep w + 1 keys (qpos - kpos <= window), one more than decode's ring
            if s <= 2 * cfg.window and s <= flags.flash_threshold:
                out = local_attention(q, k, v, cfg.window)  # small-S direct band
            else:
                out = full_attention(q, k, v, causal=causal, chunk=min(flags.attn_chunk, cfg.window),
                                     triangular=flags.triangular_attn, flash_threshold=0, window=cfg.window)
        else:
            out = full_attention(q, k, v, causal=causal, chunk=flags.attn_chunk,
                                 triangular=flags.triangular_attn, flash_threshold=flags.flash_threshold)
    return _attn_out(p, out, cfg, ms), cache


def _mla_init(gen, cfg, dtype, lead, device) -> Params:
    """Latent attention's linears (``q_lora_rank`` null) and the latent's
    norm, each ``(*lead, ...)``."""
    d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    return {
        "wq": linear_init(gen, d, h * cfg.resolved_head_dim, dtype, lead=lead, device=device),
        "wkv_a": linear_init(gen, d, r + cfg.qk_rope_head_dim, dtype, lead=lead, device=device),
        "kv_norm": rmsnorm_init(r, dtype, lead=lead, device=device),
        "wkv_b": linear_init(gen, r, h * (cfg.qk_nope_head_dim + cfg.v_head_dim), dtype, lead=lead, device=device),
        "wo": linear_init(gen, h * cfg.v_head_dim, d, dtype, lead=lead, device=device),
    }


def _mla_query(p: Params, h: torch.Tensor, cfg, positions: torch.Tensor) -> torch.Tensor:
    """The query heads (B, S, H, nope + rope), their rope part RoPE'd."""
    b, s, _ = h.shape
    q = linear(p["wq"], h).reshape(b, s, cfg.n_heads, -1)
    nope = cfg.qk_nope_head_dim
    return torch.cat([q[..., :nope], apply_rope(q[..., nope:], positions, cfg.rope_theta)], dim=-1)


def _mla_latent(p: Params, h: torch.Tensor, cfg, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The latent cache's rows of ``h``'s positions: ``c_kv`` (B, S,
    kv_lora_rank) after its norm and ``k_pe`` (B, S, rope), the key part
    every head shares, after RoPE."""
    kv = linear(p["wkv_a"], h)
    r = cfg.kv_lora_rank
    c_kv = rmsnorm(p["kv_norm"], kv[..., :r], cfg.norm_eps)
    return c_kv, apply_rope(kv[..., None, r:], positions, cfg.rope_theta)[..., 0, :]


def _mla_expand(p: Params, c_kv: torch.Tensor, k_pe: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each head's keys (B, T, H, nope + rope) and values (B, T, H, v) of
    latent rows, through ``wkv_b``."""
    b, t, _ = c_kv.shape
    kv = linear(p["wkv_b"], c_kv).reshape(b, t, cfg.n_heads, -1)
    nope = cfg.qk_nope_head_dim
    k = torch.cat([kv[..., :nope], k_pe[:, :, None].expand(b, t, cfg.n_heads, k_pe.shape[-1])], dim=-1)
    return k, kv[..., nope:]


def _mla_apply(p: Params, x: torch.Tensor, cfg, flags: RunFlags, positions: torch.Tensor,
               causal: bool) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Latent attention over a sequence: (block output, its latent cache
    rows).  The scores are scaled by 1/sqrt(nope + rope)."""
    b, s, _ = x.shape
    q = _mla_query(p, x, cfg, positions)
    with obs.span("model.mla.latent"):
        c_kv, k_pe = _mla_latent(p, x, cfg, positions)
        k, v = _mla_expand(p, c_kv, k_pe, cfg)
    with obs.span("model.attention"):
        out = full_attention(q, k, v, causal=causal, chunk=flags.attn_chunk, triangular=flags.triangular_attn,
                             flash_threshold=flags.flash_threshold)
    return linear(p["wo"], out.reshape(b, s, -1)), {"c_kv": c_kv, "k_pe": k_pe}


def _cross_apply(p: Params, x: torch.Tensor, enc_kv: Dict[str, torch.Tensor], cfg, ms=None) -> torch.Tensor:
    b, s, d = x.shape
    q = tp_linear(p["wq"], x, ms, d, cfg.q_dim).reshape(b, s, -1, cfg.resolved_head_dim)
    k, v = _local_kv((enc_kv["k"], enc_kv["v"]), cfg, ms, q.shape[2])
    out = full_attention(q, k, v, causal=False, chunk=2048, triangular=False, flash_threshold=8192)
    return _attn_out(p, out, cfg, ms)


def _cross_kv(p: Params, enc_out: torch.Tensor, cfg, ms=None) -> Dict[str, torch.Tensor]:
    b, t, d = enc_out.shape
    hd = cfg.resolved_head_dim
    return {
        "k": tp_linear(p["wk"], enc_out, ms, d, cfg.kv_dim).reshape(b, t, -1, hd),
        "v": tp_linear(p["wv"], enc_out, ms, d, cfg.kv_dim).reshape(b, t, -1, hd),
    }


def _ffn_apply(p: Params, x: torch.Tensor, cfg, flags: RunFlags,
               shard: Optional[sharding.BatchShard] = None, ms=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(output, aux loss) of this rank's rows ``x``.  MoE routes per group,
    JAX's global rule: ``flags.routing_groups`` or one group a data shard,
    lowered until it divides the global token count.  Groups that align with
    the ranks' rows (a multiple of dp) are routed where the rows lie, the
    aux loss the mean over this rank's groups; otherwise the rank gathers
    the block's rows of every rank, routes them all and keeps its own (its
    aux loss then the global one).  Dropless experts (``p["experts"]``,
    :class:`MLAMoEConfig`) route every row of the rank where it lies."""
    if "experts" in p:
        return dropless_moe_ffn(p, x, cfg)
    if "router" in p:
        dp = shard.dp if shard is not None else 1
        split = shard is not None and shard.sharded and dp > 1
        groups = flags.routing_groups or dp
        tokens = x.shape[0] * x.shape[1] * (dp if split else 1)
        while tokens % groups:
            groups -= 1
        if not split:
            return moe_ffn(p, x, cfg, groups, ms)
        if groups % dp == 0:
            return moe_ffn(p, x, cfg, groups // dp, ms)
        out, aux = moe_ffn(p, collectives.gather_rows(x, shard), cfg, groups, ms)
        return out[shard.start:shard.start + shard.rows], aux
    d, f = cfg.d_model, cfg.d_ff
    act = swiglu(tp_linear(p["w_gate"], x, ms, d, f), tp_linear(p["w_up"], x, ms, d, f))
    return tp_linear(p["w_down"], act, ms, f, d), _zero(x.device)


def _block_apply_seq(p: Params, x: torch.Tensor, kind: str, cfg: ModelConfig, flags: RunFlags,
                     positions: torch.Tensor, enc_out: Optional[torch.Tensor], causal: bool,
                     shard: Optional[sharding.BatchShard] = None, ms=None) -> Tuple[torch.Tensor, Params, torch.Tensor]:
    """Returns (x_out, new cache entries, aux loss).  A recurrent block starts
    from a zero state; the mLSTM chunk is ``attn_chunk`` capped at 256."""
    aux = _zero(x.device)
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind in MLA_KINDS:
        y, cache_out = _mla_apply(p["attn"], h, cfg, flags, positions, causal)
    elif kind in ("attn", "local_attn"):
        y, cache_out = _attn_apply(p["attn"], h, cfg, flags, positions, kind, causal, ms)
    else:
        kw = {"chunk": min(flags.attn_chunk, 256)} if kind == "mlstm" else {}
        y, cache_out = _MIXER_APPLY[kind](p["mixer"], h, cfg, None, **kw, ms=ms)
    x = x + y
    if "cross" in p and enc_out is not None:
        hx = rmsnorm(p["lnx"], x, cfg.norm_eps)
        kvx = _cross_kv(p["cross"], enc_out, cfg, ms)
        x = x + _cross_apply(p["cross"], hx, kvx, cfg, ms)
        cache_out["cross_k"], cache_out["cross_v"] = kvx["k"], kvx["v"]
    if "ffn" in p:
        y2, a = _ffn_apply(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg, flags, shard, ms)
        x = x + y2
        aux = aux + a
    return x, cache_out, aux


def _group(tree: Params, gi: int) -> Params:
    return _tree_map(lambda leaf: leaf[gi], tree)


# ---------------------------------------------------------------------------
# forward and loss
# ---------------------------------------------------------------------------


def _embed_tokens(params: Params, tokens: torch.Tensor, cfg, ms=None) -> torch.Tensor:
    """The token embeddings, ``* sqrt(d)`` (unscaled for an
    :class:`MLAMoEConfig`, as published).  A rank holding a slice of the
    vocabulary looks up its own ids, zeros for the rest, summed over the
    model axis (exact: one rank gives each id)."""
    w = params["embed"]["w"]
    vp = cfg.padded_vocab()
    if ms is None or w.shape[0] == vp:
        x = w[tokens]
    else:
        local = tokens.to(torch.int64) - ms.start(vp)
        hit = (local >= 0) & (local < w.shape[0])
        rows = w[torch.clamp(local, 0, w.shape[0] - 1)]
        x = collectives.reduce_from_model(torch.where(hit[..., None], rows, torch.zeros((), dtype=w.dtype,
                                                                                     device=w.device)), ms)
    if isinstance(cfg, MLAMoEConfig):
        return x
    # JAX multiplies by jnp.asarray(sqrt(d), x.dtype): a constant rounded to
    # the activation dtype first (a bfloat16 29.93 is 30.0), not the float32 value
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)


def _embed_batch(params: Params, cfg, batch: Dict[str, torch.Tensor], ms=None) -> torch.Tensor:
    x = _embed_tokens(params, batch["tokens"], cfg, ms)
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        x = frontend.fuse_patches(params["vision_adapter"], x, batch["patch_embeds"])
    return x


def _run_encoder(params: Params, cfg, flags: RunFlags, frame_embeds: torch.Tensor,
                 shard: Optional[sharding.BatchShard], ms=None) -> torch.Tensor:
    """The encoder of an encoder–decoder model: the audio adapter over the
    frame embeddings, non-causal attention blocks, then ``enc_norm``."""
    x = frontend.embed_frames(params["audio_adapter"], frame_embeds.to(dtype_of(cfg)))
    positions = torch.arange(x.shape[1], device=x.device)[None]
    for gi in range(cfg.n_enc_layers):
        gp = _group(params["enc_blocks"], gi)
        x, _, _ = _block_apply_seq(gp["00_attn"], x, "attn", cfg, flags, positions, None, False, shard, ms)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _encoder_out(params: Params, cfg, flags: RunFlags, batch: Dict[str, torch.Tensor],
                 shard: Optional[sharding.BatchShard], ms=None) -> Optional[torch.Tensor]:
    return _run_encoder(params, cfg, flags, batch["enc_embeds"], shard, ms) if cfg.is_encdec else None


def _lm_head(params: Params, x: torch.Tensor, cfg, ms=None) -> torch.Tensor:
    """The logits over the padded vocabulary: column-parallel on a rank
    holding a slice of the vocabulary, then gathered over the model axis."""
    vp = cfg.padded_vocab()
    if cfg.tie_embeddings:
        w = params["embed"]["w"]
        if ms is None or w.shape[0] == vp:
            return x @ w.T
        return collectives.gather_from_model(collectives.copy_to_model(x, ms) @ w.T, -1, ms)
    # the quantized head runs the bit-sliced GEMM
    return tp_gathered(tp_linear(params["lm_head"], x, ms, cfg.d_model, vp), ms, vp)


def forward(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], flags: RunFlags = DEFAULT_FLAGS,
            rules: Any = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits.  Returns (logits, aux_loss): the float32 sum of
    the MoE load-balance losses over blocks (0 without MoE).  An
    encoder–decoder batch carries ``enc_embeds`` (B, T_frames, d).  Under
    ``rules`` this rank runs its rows of the global batch and returns the
    global logits and aux loss (not differentiable across ranks: the train
    step differentiates :func:`local_loss`)."""
    shard, ms = _shard_of(cfg, rules, batch["tokens"].shape[0])
    if shard is None:
        return _forward(params, cfg, batch, flags, None)
    logits, aux = _forward(params, cfg, shard.take(batch), flags, shard, ms)
    return collectives.gather_rows(logits, shard), collectives.mean_over(aux, shard)


def _forward(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], flags: RunFlags,
             shard: Optional[sharding.BatchShard], ms=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`forward` on this rank's rows ``batch``: their logits and this
    rank's aux loss."""
    tokens = batch["tokens"]
    s = tokens.shape[1]
    x = _embed_batch(params, cfg, batch, ms)
    enc_out = _encoder_out(params, cfg, flags, batch, shard, ms)
    positions = torch.arange(s, device=tokens.device)[None]
    aux = _zero(x.device)
    # Remat per block, as JAX's jax.checkpoint around each block: the
    # backward recomputes a block's intermediates from its input (RG-LRU
    # blocks run the scan kernel again).  Only where a graph is recorded.
    remat = flags.remat and torch.is_grad_enabled()
    for gi in range(cfg.pattern_groups()):
        gp = _group(params["blocks"], gi)
        for i, kind in enumerate(cfg.block_pattern):
            args = (gp[f"{i:02d}_{kind}"], x, kind, cfg, flags, positions, enc_out, shard, ms)
            if remat:
                x, a = checkpoint(_one_block, *args, use_reentrant=False, preserve_rng_state=False)
            else:
                x, a = _one_block(*args)
            aux = aux + a
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _lm_head(params, x, cfg, ms), aux


def _one_block(p: Params, x: torch.Tensor, kind: str, cfg: ModelConfig, flags: RunFlags, positions: torch.Tensor,
               enc_out: Optional[torch.Tensor], shard: Optional[sharding.BatchShard],
               ms=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One causal block of :func:`forward`: (x_out, aux loss)."""
    x, _, a = _block_apply_seq(p, x, kind, cfg, flags, positions, enc_out, True, shard, ms)
    return x, a


def local_loss(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], flags: RunFlags,
               shard: Optional[sharding.BatchShard], ms=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss, ce, aux) of this rank's rows ``batch``, such that the sums over
    the data shards are the global ``loss`` and ``ce`` and ``dp`` times the
    global ``aux``: ce is the rows' summed token cross-entropy over the
    global token count, and the loss adds ``0.01 · aux / dp``.  Summing its
    gradients over the data axes gives the gradients of the global loss.
    Without ``shard``, :func:`loss_fn`'s values.  On a model axis (``ms``)
    every rank of it computes the same loss from the gathered logits, and
    the gradients of the leaves it holds slices of are those slices'."""
    logits, aux = _forward(params, cfg, batch, flags, shard, ms)
    total, count = cross_entropy_sum(logits, batch["labels"], cfg.vocab_size)
    if shard is None or not shard.sharded:
        return total / count + 0.01 * aux, total / count, aux
    ce = total / (count * shard.dp)
    return ce + 0.01 * (aux / shard.dp), ce, aux


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], flags: RunFlags = DEFAULT_FLAGS,
            rules: Any = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(ce + 0.01 · aux, {"ce": ce, "aux": aux}) over ``batch["labels"]``.
    Under ``rules``, JAX's global values: the summed token losses and the
    aux losses of every rank's rows reduced over the data axes."""
    shard, ms = _shard_of(cfg, rules, batch["tokens"].shape[0])
    if shard is None:
        loss, ce, aux = local_loss(params, cfg, batch, flags, None)
        return loss, {"ce": ce, "aux": aux}
    _, ce, aux = local_loss(params, cfg, shard.take(batch), flags, shard, ms)
    if shard.sharded:
        ce = collectives.all_reduce_(ce.detach().clone(), shard.group)
        aux = collectives.mean_over(aux.detach(), shard)
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

    if kind in MLA_KINDS:
        if flags.quant_kv:
            raise NotImplementedError(f"{cfg.name}: the latent cache has no int8 form (RunFlags.quant_kv)")
        # the latent cache: the normed latent and the RoPE'd shared key part
        return {"c_kv": torch.zeros((*lead, batch, max_len, cfg.kv_lora_rank), dtype=dt, device=device),
                "k_pe": torch.zeros((*lead, batch, max_len, cfg.qk_rope_head_dim), dtype=dt, device=device)}
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
               device: Any = "cuda", rules: Any = None) -> Params:
    """Decode cache: stacked (G, ...) per pattern position, plus the
    position, an int32 scalar on the host.  Under ``rules``, this rank's
    shard of it by ``serve.engine.cache_specs`` (with ``seq_sharded``
    naming the leaves whose rows are split, as :func:`prefill` gives it)."""
    dev = _device(device)
    g = cfg.pattern_groups()
    cache = {
        "pos": _host_pos(0),
        "blocks": {f"{i:02d}_{kind}": _cache_entry_shape(cfg, kind, batch, max_len, flags, (g,), dev)
                   for i, kind in enumerate(cfg.block_pattern)},
    }
    if rules is None:
        return cache
    check_supported(cfg, rules)
    seq = {}
    for key, entry in cache["blocks"].items():
        for name, leaf in entry.items():
            spec = sharding.P(None, *sharding.cache_entry_spec(tuple(leaf.shape[1:]), cfg, rules,
                                                               seq_shard_kv=flags.seq_shard_kv))
            entry[name] = sharding.shard_leaf(leaf, spec, rules)
            if spec[2] == rules.tp_axis:
                seq.setdefault(key, {})[name] = _host_pos(leaf.shape[2])
    if seq:
        cache["seq_sharded"] = seq
    return cache


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
    Recurrent states pass through.  Latent attention's ``c_kv`` and
    ``k_pe`` (B,S,·) are zero-padded to ``max_len`` rows as ``attn``'s K/V
    (no ``quant_kv`` form: ``NotImplementedError``)."""
    if kind in MLA_KINDS:
        if flags.quant_kv:
            raise NotImplementedError(f"{cfg.name}: the latent cache has no int8 form (RunFlags.quant_kv)")
        return {n: _pad_rows(entries[n], max_len - s) if max_len > s else entries[n] for n in ("c_kv", "k_pe")}
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


_KV_LEAVES = ("k", "v", "k_scale", "v_scale", "cross_k", "cross_v")


def _shard_rows(blocks: Params, cfg: ModelConfig, flags: RunFlags, rules: sharding.MeshRules,
                ms: sharding.ModelShard, batch: int) -> Params:
    """Cut each stacked cache leaf that ``cache_entry_spec`` shards by rows
    on the model axis to this rank's rows, in place; returns
    ``{block: {leaf: global rows}}`` of the leaves cut.  The spec is taken
    of the global entry shape: the global batch, and all KV heads where this
    rank holds its slice of them."""
    seq = {}
    for key, entry in blocks.items():
        for name, leaf in entry.items():
            shape = [batch, *leaf.shape[2:]]
            if name in _KV_LEAVES and cfg.n_kv_heads % ms.tp == 0 and shape[2] * ms.tp == cfg.n_kv_heads:
                shape[2] = cfg.n_kv_heads
            spec = sharding.cache_entry_spec(tuple(shape), cfg, rules, seq_shard_kv=flags.seq_shard_kv)
            if spec[1] == rules.tp_axis:
                c = leaf.shape[2] // ms.tp
                entry[name] = leaf.narrow(2, ms.index * c, c).clone()
                seq.setdefault(key, {})[name] = _host_pos(leaf.shape[2])
    return seq


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], flags: RunFlags = DEFAULT_FLAGS,
            rules: Any = None, max_len: Optional[int] = None) -> Tuple[Params, torch.Tensor]:
    """Run the prompt, return (cache, last-token logits).  Under ``rules``
    this rank runs its rows of the global batch: the cache is its shard
    (``serve.engine.cache_specs``), the logits the global ones."""
    shard, ms = _shard_of(cfg, rules, batch["tokens"].shape[0])
    if shard is None:
        return _prefill(params, cfg, batch, flags, None, max_len)
    cache, logits = _prefill(params, cfg, shard.take(batch), flags, shard, max_len, ms)
    if ms is not None and flags.seq_shard_kv:
        seq = _shard_rows(cache["blocks"], cfg, flags, rules, ms, shard.batch)
        if seq:
            cache["seq_sharded"] = seq
    return cache, collectives.gather_rows(logits, shard)


def _prefill(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], flags: RunFlags,
             shard: Optional[sharding.BatchShard], max_len: Optional[int], ms=None) -> Tuple[Params, torch.Tensor]:
    tokens = batch["tokens"]
    s = tokens.shape[1]
    max_len = max_len or s
    x = _embed_batch(params, cfg, batch, ms)
    enc_out = _encoder_out(params, cfg, flags, batch, shard, ms)
    positions = torch.arange(s, device=tokens.device)[None]
    per_group = []
    for gi in range(cfg.pattern_groups()):
        gp = _group(params["blocks"], gi)
        entries = {}
        for i, kind in enumerate(cfg.block_pattern):
            key = f"{i:02d}_{kind}"
            x, new, _ = _block_apply_seq(gp[key], x, kind, cfg, flags, positions, enc_out, True, shard, ms)
            entries[key] = _seq_cache_to_decode_cache(new, kind, cfg, s, max_len, flags)
        per_group.append(entries)
    blocks = {key: {n: torch.stack([e[key][n] for e in per_group]) for n in per_group[0][key]}
              for key in per_group[0]}
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = _lm_head(params, x[:, -1:], cfg, ms)[:, 0]
    return {"pos": _host_pos(s), "blocks": blocks}, logits


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------


def _write_row(cache: torch.Tensor, new: torch.Tensor, slot: int) -> None:
    """Row ``slot`` of axis 1 of ``cache`` ← ``new`` (one row), in place."""
    cache[:, slot:slot + 1] = new


def _attn_decode(p: Params, h: torch.Tensor, cfg, entry: Params, pos: int, kind: str, ms=None) -> torch.Tensor:
    """One token of attention; writes its K/V row into ``entry`` (a group's
    views of the step's fresh cache) in place and returns the block output.

    ``local_attn`` keeps a ring of ``w`` rows: the row goes to slot
    ``pos % w`` and the ``min(pos + 1, w)`` rows from slot 0 are live (RoPE
    was applied at insert, so their order does not matter).  On a model
    axis the rank attends with its query heads over the KV heads they need
    (under ``quant_kv`` the row-dot kernel scores only that slab)."""
    b = h.shape[0]
    q, k, v = _qkv(p, h, cfg, ms)
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
    with obs.span("model.attention"):
        valid = torch.full((b,), live, dtype=torch.int32, device=h.device)
        if "k_scale" in entry:  # int8 KV cache (PIMSAB adaptive precision)
            kq, ks = quantize_kv(k, KV_SPEC)
            vq, vs = quantize_kv(v, KV_SPEC)
            for n, new in (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs)):
                _write_row(entry[n], new, slot)
            kq, vq, ks, vs = _local_kv((entry["k"], entry["v"], entry["k_scale"], entry["v_scale"]), cfg, ms,
                                       q.shape[2])
            out = decode_attention_int8(q, kq, vq, ks, vs, valid, KV_SPEC)
        else:
            _write_row(entry["k"], k, slot)
            _write_row(entry["v"], v, slot)
            out = decode_attention(q, *_local_kv((entry["k"], entry["v"]), cfg, ms, q.shape[2]), valid)
    return _attn_out(p, out, cfg, ms)


def _mla_decode(p: Params, h: torch.Tensor, cfg, entry: Params, pos: int) -> torch.Tensor:
    """One token of latent attention: writes its latent row into ``entry``
    (a group's views of the step's fresh cache) in place, expands the live
    rows through ``wkv_b`` and attends over them (no weight absorption)."""
    b = h.shape[0]
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=h.device)
    q = _mla_query(p, h, cfg, posb)
    t = entry["c_kv"].shape[1]
    # past the cache's end the last row is overwritten, as attn's K/V
    slot, live = min(max(pos, 0), t - 1), min(pos + 1, t)
    with obs.span("model.mla.latent"):
        c_kv, k_pe = _mla_latent(p, h, cfg, posb)
        _write_row(entry["c_kv"], c_kv, slot)
        _write_row(entry["k_pe"], k_pe, slot)
        k, v = _mla_expand(p, entry["c_kv"][:, :live], entry["k_pe"][:, :live], cfg)
    with obs.span("model.attention"):
        out = decode_attention(q, k, v)
    return linear(p["wo"], out.reshape(b, 1, -1))


def _cross_decode(p: Params, hx: torch.Tensor, cfg, entry: Params, ms=None) -> torch.Tensor:
    """One token of cross-attention over the cached encoder K/V."""
    b, _, d = hx.shape
    xq = tp_linear(p["wq"], hx, ms, d, cfg.q_dim).reshape(b, 1, -1, cfg.resolved_head_dim)
    out = decode_attention(xq, *_local_kv((entry["cross_k"], entry["cross_v"]), cfg, ms, xq.shape[2]))
    return _attn_out(p, out, cfg, ms)


def decode_step(params: Params, cfg: ModelConfig, cache: Params, tokens: torch.Tensor,
                flags: RunFlags = DEFAULT_FLAGS, rules: Any = None) -> Tuple[Params, torch.Tensor]:
    """tokens: (B, 1).  Returns (new_cache, logits (B, vocab)).

    The given cache is left as it was: the step clones each cache leaf once,
    writes the new K/V rows into the clones and copies each recurrent
    block's new state over its clone.  ``cache["pos"]`` is read once, on the
    host (see :func:`init_cache`).  Under ``rules`` the tokens are the
    global batch's, the cache this rank's shard (as :func:`prefill` returns
    it) and the logits the global ones.  The leaves ``cache["seq_sharded"]``
    names hold this rank's rows: the step gathers them over the model axis,
    runs, and keeps this rank's rows of the new cache."""
    shard, ms = _shard_of(cfg, rules, tokens.shape[0])
    if shard is None:
        return _decode_step(params, cfg, cache, tokens, flags, None)
    new_cache, logits = _decode_step(params, cfg, cache, shard.take({"t": tokens})["t"], flags, shard, ms)
    return new_cache, collectives.gather_rows(logits, shard)


def _decode_step(params: Params, cfg: ModelConfig, cache: Params, tokens: torch.Tensor, flags: RunFlags,
                 shard: Optional[sharding.BatchShard], ms=None) -> Tuple[Params, torch.Tensor]:
    pos = int(cache["pos"])
    x = _embed_tokens(params, tokens, cfg, ms)
    seq = cache.get("seq_sharded", {})
    blocks = {key: {n: (collectives.all_gather_dim(leaf, 2, ms.tp, ms.group) if n in seq.get(key, ()) else
                        leaf.clone()) for n, leaf in entry.items()}
              for key, entry in cache["blocks"].items()}
    for gi in range(cfg.pattern_groups()):
        gp, gc = _group(params["blocks"], gi), _group(blocks, gi)
        for i, kind in enumerate(cfg.block_pattern):
            key = f"{i:02d}_{kind}"
            p, entry = gp[key], gc[key]
            h = rmsnorm(p["ln1"], x, cfg.norm_eps)
            if kind in MLA_KINDS:
                y = _mla_decode(p["attn"], h, cfg, entry, pos)
            elif kind in ("attn", "local_attn"):
                y = _attn_decode(p["attn"], h, cfg, entry, pos, kind, ms)
            else:
                y, st = _MIXER_APPLY[kind](p["mixer"], h, cfg, entry, ms=ms)
                for n, leaf in st.items():
                    entry[n].copy_(leaf)
            x = x + y
            if "cross" in p:
                x = x + _cross_decode(p["cross"], rmsnorm(p["lnx"], x, cfg.norm_eps), cfg, entry, ms)
            if "ffn" in p:
                y2, _ = _ffn_apply(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg, flags, shard, ms)
                x = x + y2
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = _lm_head(params, x, cfg, ms)[:, 0]
    new = {"pos": _host_pos(pos + 1), "blocks": blocks}
    for key, names in seq.items():
        for n in names:
            leaf = blocks[key][n]
            c = leaf.shape[2] // ms.tp
            blocks[key][n] = leaf.narrow(2, ms.index * c, c).clone()
    if seq:
        new["seq_sharded"] = seq
    return new, logits
