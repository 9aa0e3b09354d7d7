"""Shared model building blocks of the PyTorch port: the port's copy of the
JAX package's ``models/common.py`` (norms, RoPE, SwiGLU, initializers, the
quantized linear layers and the training loss).

:func:`quant_linear` is one int8 product when the spec fits one slice pair
(:func:`int_matmul`) and otherwise goes through ``api.matmul`` over
:class:`~repro_torch.kernels.api.SlicedTensor` operands; both run the
bit-sliced GEMM kernel.  :func:`quant_linear_relu` runs ``relu(x @ W)`` as one traced
Program over that kernel and the relu kernel.

:func:`tp_linear` is a linear layer on a "model" axis wider than one: from
the shape of the rank's weight it runs column-parallel (its output columns),
row-parallel (its slice of the contraction, partial sums added over the
axis) or replicated.  A quantized row-parallel linear (:func:`quant_linear`
with a model shard) takes each row's scale over the axis before quantizing
and adds the int32 accumulators before dequantizing, so it gives the
unsharded result bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives
from repro_torch.kernels import api
from repro_torch.kernels.api import PrecisionSpec, SlicedTensor
from repro_torch.kernels.bitslice_matmul import bitslice_matmul

Params = Dict[str, Any]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def dtype_of(cfg) -> torch.dtype:
    """The torch dtype named by ``cfg.dtype``."""
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(gen: Optional[torch.Generator], d_in: int, d_out: int, dtype: torch.dtype,
               scale: Optional[float] = None, *, lead: tuple = (), device: Any) -> torch.Tensor:
    """A ``(*lead, d_in, d_out)`` normal weight times ``scale`` (default
    ``1/sqrt(d_in)``), drawn in float32 from ``gen`` on ``device`` (nothing
    is drawn on the meta device) and cast to ``dtype``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return (torch.randn((*lead, d_in, d_out), generator=gen, dtype=torch.float32, device=device) * scale).to(dtype)


def linear_init(gen: Optional[torch.Generator], d_in: int, d_out: int, dtype: torch.dtype,
                bias: bool = False, *, lead: tuple = (), device: Any) -> Params:
    p: Params = {"w": dense_init(gen, d_in, d_out, dtype, lead=lead, device=device)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=dtype, device=device)
    return p


# ---------------------------------------------------------------------------
# RMSNorm, RoPE, SwiGLU
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, dtype: torch.dtype, *, lead: tuple = (), device: Any) -> Params:
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * p["scale"]


def rope_freqs(head_dim: int, theta: float, device: Any = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: ``(..., S, H, hd)``; positions: broadcastable to ``(..., S)``."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., :, None, None].to(torch.float32) * freqs  # (..., S, 1, hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate.to(torch.float32)).to(gate.dtype) * up


def cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor, vocab: int) -> Tuple[torch.Tensor, int]:
    """(summed token cross-entropy in float32, token count): JAX's
    ``softmax_cross_entropy`` is the sum over the count (``loss_fn`` divides,
    over the global count under sharding rules).  The logits of the padded
    vocabulary (ids ≥ ``vocab``) are masked by subtracting 1e9.  No label is
    masked, so every token counts."""
    lf = logits.to(torch.float32)
    if lf.shape[-1] > vocab:
        mask = torch.zeros(lf.shape[-1], dtype=torch.float32, device=lf.device)
        mask.narrow(0, vocab, lf.shape[-1] - vocab).fill_(1e9)  # one op on every device, meta included
        lf = lf - mask
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].to(torch.int64))[..., 0]
    nll = logz - gold
    return torch.sum(nll), nll.numel()


def _saturate_int8(x: torch.Tensor) -> torch.Tensor:
    """Float → int8 as XLA converts: values outside int8 saturate to −128 or
    127 (a torch cast wraps them: 200.0 → −56)."""
    return torch.clamp(x, -128, 127).to(torch.int8)


def quantize_weight(w: torch.Tensor, bits: int = 8) -> Params:
    """Symmetric per-output-channel integer quantization of a
    ``(..., d_in, d_out)`` weight: ``{"w_q": int8, "w_scale": float32}``.
    Above 8 bits the int8 values saturate, as the JAX package's do."""
    wf = w.to(torch.float32)
    qmax = 2 ** (bits - 1) - 1
    scale = api.absmax_scale(wf, -2, qmax)
    w_q = _saturate_int8(torch.clamp(torch.round(wf / scale), -qmax - 1, qmax))
    return {"w_q": w_q, "w_scale": scale}


def _act_scale(xf: torch.Tensor, bits: int, ms=None) -> torch.Tensor:
    """Each row's symmetric quantization scale.  With ``ms`` (a
    ``dist.sharding.ModelShard``) ``xf`` is this rank's slice of each row and
    the scale is the whole row's: the max of the slices' scales over the
    model axis (a scale grows with its absmax)."""
    return collectives.all_reduce_max(api.absmax_scale(xf, -1, 2 ** (bits - 1) - 1), ms)


def _dynamic_act_quant(x: torch.Tensor, bits: int, ms=None):
    """Per-row symmetric quantization of activations: (int8 values, scale);
    ``ms`` as in :func:`_act_scale`."""
    qmax = 2 ** (bits - 1) - 1
    xf = x.to(torch.float32)
    scale = _act_scale(xf, bits, ms)
    x_q = _saturate_int8(torch.clamp(torch.round(xf / scale), -qmax - 1, qmax))
    return x_q, scale


def int_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int8 ``(..., K)`` × int8 ``(K, N)`` → int32 ``(..., N)``: one slice
    pair of the bit-sliced GEMM (``bitslice_matmul`` with one slice per
    operand and no shift), which the JAX package computes outside any Pallas
    kernel.  The kernel on the card, its plain version on the CPU."""
    lead, k = x_q.shape[:-1], x_q.shape[-1]
    out = bitslice_matmul(x_q.reshape(1, -1, k).to(torch.int8), w_q.reshape(1, k, -1).to(torch.int8))
    return out.reshape(*lead, w_q.shape[1])


def quant_linear(p: Params, x: torch.Tensor, spec: PrecisionSpec = PrecisionSpec.int8, ms=None) -> torch.Tensor:
    """Bit-sliced integer linear: dynamic activation quantization and int32
    accumulation.

    A spec that fits one slice pair (the int8 default) is one int8 product;
    wider specs go through ``api.matmul`` over ``SlicedTensor`` operands,
    which splits into slices, skips the all-zero ones and recombines with
    shifts.

    With ``ms`` (a ``dist.sharding.ModelShard``) the linear is row-parallel:
    ``x`` is this rank's slice of each row's contraction and ``p`` the
    matching rows.  Each row's scale is taken over the model axis and the
    int32 accumulators are summed over it before dequantizing, so the result
    is the unsharded one bit for bit.
    """
    lead = x.shape[:-1]
    if spec.single_pass:
        x_q, x_scale = _dynamic_act_quant(x, spec.act_bits, ms)
        acc = int_matmul(x_q, p["w_q"])
    else:
        xf = x.reshape(-1, x.shape[-1]).to(torch.float32)
        x_scale = _act_scale(xf, spec.act_bits, ms)
        x_st = SlicedTensor.quantize(xf, spec, scale=x_scale)
        w_st = SlicedTensor.from_int(p["w_q"].to(torch.int32), spec.weight_bits, slice_bits=spec.slice_bits)
        acc = api.matmul(dataclasses.replace(x_st, scale=None), w_st).reshape(*lead, -1)
        x_scale = x_scale.reshape(*lead, 1)
    acc = collectives.reduce_from_model(acc, ms)
    out = acc.to(torch.float32) * x_scale * p["w_scale"]
    if "b" in p:
        out = out + p["b"].to(torch.float32)
    return out.to(x.dtype)


def linear(p: Params, x: torch.Tensor, spec: Optional[PrecisionSpec] = None, ms=None) -> torch.Tensor:
    """Quantized (bit-sliced) if the parameters are quantized, else a plain
    float product.  ``ms`` (a ``dist.sharding.ModelShard``) makes it
    row-parallel: the partial products of this rank's slice of the
    contraction are summed over the model axis, then the bias is added."""
    if "w_q" in p:
        return quant_linear(p, x, spec or PrecisionSpec.int8, ms)
    out = collectives.reduce_from_model(x @ p["w"], ms)
    if "b" in p:
        out = out + p["b"]
    return out


def tp_linear(p: Params, x: torch.Tensor, ms, d_in: int, d_out: int,
              spec: Optional[PrecisionSpec] = None) -> torch.Tensor:
    """:func:`linear` of a ``(d_in, d_out)`` layer on the model axis of
    ``ms`` (a ``dist.sharding.ModelShard``; None runs :func:`linear`).

    The rank's weight tells the layout.  Column-sharded: ``x`` whole, the
    output this rank's columns.  Row-sharded: ``x`` this rank's slice of the
    contraction (or whole, then sliced here), the output whole (the partial
    sums added over the axis).  Replicated: ``x`` and the output whole (the
    rules shard a layer's input dim exactly when they shard the output dim
    of the layer that feeds it)."""
    if ms is None:
        return linear(p, x, spec)
    k, n = (p["w_q"] if "w_q" in p else p["w"]).shape[-2:]
    if n != d_out:
        return linear(p, collectives.copy_to_model(x, ms), spec)
    if k == d_in:
        return linear(p, x, spec)
    if x.shape[-1] == d_in:
        x = collectives.copy_to_model(x, ms).narrow(-1, ms.start(d_in), k)
    return linear(p, x, spec, ms)


def tp_gathered(x: torch.Tensor, ms, d: int) -> torch.Tensor:
    """``x`` whole along its last dim of global size ``d``: gathered over the
    model axis when this rank holds a slice of it."""
    return x if ms is None or x.shape[-1] == d else collectives.gather_from_model(x, -1, ms)


def _matmul_relu_chain(x_st: SlicedTensor, w_st: SlicedTensor) -> torch.Tensor:
    # scale-less operands: the integer accumulator feeds relu directly
    return api.relu(api.matmul(x_st, w_st))


_matmul_relu = api.trace(_matmul_relu_chain, name="quant_linear_relu")


def quant_linear_relu(p: Params, x: torch.Tensor, spec: Optional[PrecisionSpec] = None) -> torch.Tensor:
    """``relu(x @ W)`` over a quantized weight, as one traced Program.

    The matmul → relu chain runs in the raw integer domain through the
    Program's cached Executor and is dequantized afterwards: the scales are
    positive, so they factor out of relu.  Unquantized parameters, a bias
    (relu does not commute with ``+ b``) or an input without values (a trace
    placeholder or a meta tensor) take the eager composition instead.
    """
    spec = spec or PrecisionSpec.int8
    if "w_q" not in p or "b" in p or api.static_value(x) is None:
        return torch.clamp_min(linear(p, x, spec), 0)
    lead = x.shape[:-1]
    x_st = SlicedTensor.quantize(x.reshape(-1, x.shape[-1]), spec)
    x_raw = SlicedTensor(  # scale-less view that keeps the zero-slice metadata
        slices=x_st.slices, slice_bits=x_st.slice_bits,
        orig_bits=x_st.orig_bits, zero_slices=x_st.zero_slices,
    )
    w_st = SlicedTensor.from_int(p["w_q"].to(torch.int32), spec.weight_bits,
                                 slice_bits=spec.slice_bits)
    raw = _matmul_relu(x_raw, w_st)
    out = raw.to(torch.float32) * x_st.scale.reshape(-1, 1) * p["w_scale"].reshape(1, -1)
    return out.reshape(*lead, -1).to(x.dtype)


def maybe_quantize_tree(params: Params, cfg, path: str = "") -> Params:
    """The serving form of a parameter tree: every linear ``{"w": ...}``
    leaf-dict (2-D, or 3-D stacked over pattern groups) becomes ``{"w_q":
    int8, "w_scale": float32}`` (plus its ``"b"``), quantized per group at
    the config's ``weight_bits``.  Embedding and normalization weights stay
    high-precision (they are gathered, not multiplied)."""
    if not cfg.quant.enabled:
        return params
    spec = PrecisionSpec.from_quant_config(cfg.quant)
    skip = ("embed", "norm", "scale", "lambda", "conv", "gate_bias", "router")

    def rec(node, path):
        if isinstance(node, dict):
            if "w" in node and node["w"].ndim in (2, 3) and not any(s in path for s in skip):
                q = quantize_weight(node["w"], spec.weight_bits)
                if "b" in node:
                    q["b"] = node["b"]
                return q
            return {k: rec(v, f"{path}/{k}") for k, v in node.items()}
        return node

    return rec(params, path)
