"""Quantized (bit-sliced) linear layers of the PyTorch port: the port's copy
of the linear part of the JAX package's ``models/common.py``.

:func:`quant_linear` is one int8 product when the spec fits one slice pair
(:func:`int_matmul`) and otherwise goes through ``api.matmul`` over
:class:`~repro_torch.kernels.api.SlicedTensor` operands; both run the
bit-sliced GEMM kernel.  :func:`quant_linear_relu` runs ``relu(x @ W)`` as one traced
Program over that kernel and the relu kernel.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.kernels import api
from repro_torch.kernels.api import PrecisionSpec, SlicedTensor
from repro_torch.kernels.bitslice_matmul import bitslice_matmul

Params = Dict[str, Any]


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


def _dynamic_act_quant(x: torch.Tensor, bits: int):
    """Per-row symmetric quantization of activations: (int8 values, scale)."""
    qmax = 2 ** (bits - 1) - 1
    xf = x.to(torch.float32)
    scale = api.absmax_scale(xf, -1, qmax)
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


def quant_linear(p: Params, x: torch.Tensor, spec: PrecisionSpec = PrecisionSpec.int8) -> torch.Tensor:
    """Bit-sliced integer linear: dynamic activation quantization and int32
    accumulation.

    A spec that fits one slice pair (the int8 default) is one int8 product;
    wider specs go through ``api.matmul`` over ``SlicedTensor`` operands,
    which splits into slices, skips the all-zero ones and recombines with
    shifts.
    """
    if spec.single_pass:
        x_q, x_scale = _dynamic_act_quant(x, spec.act_bits)
        acc = int_matmul(x_q, p["w_q"])
        out = acc.to(torch.float32) * x_scale * p["w_scale"]
    else:
        lead = x.shape[:-1]
        x_st = SlicedTensor.quantize(x.reshape(-1, x.shape[-1]), spec)
        w_st = SlicedTensor.from_int(
            p["w_q"].to(torch.int32), spec.weight_bits,
            slice_bits=spec.slice_bits, scale=p["w_scale"].reshape(-1),
        )
        out = api.matmul(x_st, w_st).reshape(*lead, -1)
    if "b" in p:
        out = out + p["b"].to(torch.float32)
    return out.to(x.dtype)


def linear(p: Params, x: torch.Tensor, spec: Optional[PrecisionSpec] = None) -> torch.Tensor:
    """Quantized (bit-sliced) if the parameters are quantized, else a plain
    float product."""
    if "w_q" in p:
        return quant_linear(p, x, spec or PrecisionSpec.int8)
    out = x @ p["w"]
    if "b" in p:
        out = out + p["b"]
    return out


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
