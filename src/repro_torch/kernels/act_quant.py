"""The activation quantize of the quantized linear, one pass over each row.

:func:`act_quant` computes, for each row of ``x (..., K)``, the symmetric
scale ``max(max|x| / qmax, 1e-8)`` (``qmax = 2**(bits-1) - 1``) and the row
quantized to int8, ``clamp(round(x / scale), -qmax - 1, qmax)``: what
``models.common._dynamic_act_quant`` computes without a model shard.  For
CUDA tensors it launches ``csrc/act_quant.cu``, which reads the row once and
writes int8 once where the PyTorch chain makes ~11 passes, and gives the
chain's values bit for bit; for CPU tensors it runs the plain version (that
chain, ``api.act_quant_plain``); for ``meta`` tensors the card's checks,
then ``meta`` outputs.  Every device refuses what the card refuses.

Non-finite rows: a row with a NaN gets a NaN scale and one with an infinity
(and no NaN) an infinite scale, as the chain's; the int8 values of such a
row are unspecified where ``x / scale`` is NaN (the chain casts NaN to int8,
which is undefined too).

It is not a registry kernel: the JAX package has no Pallas kernel for it (XLA
fuses the same jnp ops), so there is nothing to pair it with and no pimsab
lowering.  :func:`act_quant_takes` says which calls it takes: bfloat16,
float16 or float32 rows of at most ``act_quant_max_k`` elements at 2 to 8
bits.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.api import (
    act_quant_plain,
    count_launch,
    kernel_device,
    meta_operands,
    note_kernel_work,
    noting_work,
    plain_scope,
)

ACT_QUANT_VPT = 4             # csrc/act_quant.cu: VPT, 16-byte vectors a thread holds
ACT_QUANT_MAX_THREADS = 1024  # MAX_THREADS
_SUFFIX = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32"}


def act_quant_max_k(dtype: torch.dtype) -> int:
    """The longest row the kernel holds in registers: VPT 16-byte vectors
    for each of a block's threads (32768 bfloat16 or float16, 16384
    float32)."""
    return ACT_QUANT_MAX_THREADS * ACT_QUANT_VPT * (16 // dtype.itemsize)


def act_quant_takes(x: torch.Tensor, bits: int) -> bool:
    """Whether :func:`act_quant` takes a quantize of ``x`` at ``bits``: a
    dtype it reads, 2 to 8 bits, and a row of 1 to ``act_quant_max_k``
    elements."""
    return x.dtype in _SUFFIX and 2 <= bits <= 8 and 0 < x.shape[-1] <= act_quant_max_k(x.dtype)


def act_quant_plan(k: int, dtype: torch.dtype) -> int:
    """Threads of the block that quantizes a row of ``k`` elements: enough
    warps that each thread holds at most VPT of the row's 16-byte vectors."""
    vectors = k // (16 // dtype.itemsize)
    return 32 * max(1, -(-vectors // (32 * ACT_QUANT_VPT)))


def act_quant_bytes(m: int, k: int, itemsize: int) -> int:
    """Bytes of one call: the input read once, the int8 values and the
    float32 scales written once."""
    return m * k * (itemsize + 1) + 4 * m


def act_quant(x: torch.Tensor, bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x_q int8 (..., K), scale float32 (..., 1))`` of each row of ``x``;
    the CUDA kernel for CUDA tensors; for ``meta`` ones the card's checks,
    then ``meta`` outputs."""
    meta = meta_operands(x)
    dev = x.device if meta else kernel_device(x)
    if x.dtype not in _SUFFIX:
        raise TypeError(f"the activation quantize reads bfloat16, float16 or float32, got {x.dtype}")
    if not act_quant_takes(x, bits):
        raise ValueError(f"the activation quantize takes 2 to 8 bits and rows of 1 to "
                         f"{act_quant_max_k(x.dtype)} elements, got {bits} bits and {x.shape[-1]}")
    k = x.shape[-1]
    m = x.numel() // k
    if dev.type != "cpu" and m >= 2**31:
        raise ValueError(f"{m} rows exceed the kernel's grid")
    if m and noting_work():
        # no multiply-adds: the dry run's operations count products
        note_kernel_work("act_quant", 0, act_quant_bytes(m, k, x.element_size()))
    if dev.type == "cpu":
        with plain_scope():
            return act_quant_plain(x, bits)
    x_q = torch.empty(x.shape, dtype=torch.int8, device=dev)
    scale = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=dev)
    if m == 0 or meta:
        return x_q, scale
    rows = x.reshape(m, k)
    if rows.stride(-1) != 1:
        rows = rows.contiguous()
    _build.launch(f"act_quant_{_SUFFIX[x.dtype]}", dev, rows.data_ptr(), rows.stride(0), x_q.data_ptr(),
                  scale.data_ptr(), m, k, 2 ** (bits - 1) - 1, act_quant_plan(k, x.dtype))
    count_launch("act_quant")
    return x_q, scale
