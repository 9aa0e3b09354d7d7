"""Elementwise map kernels (add / relu) of the PyTorch port.

Mirrors the JAX package's ``kernels/ewise.py``.  One wrapper,
:func:`_ewise`, launches ``csrc/ewise.cu`` (replacing the Pallas
``_add_kernel`` and ``_relu_kernel``) for CUDA tensors and runs the plain
version for CPU tensors.  Operands are flattened; the result keeps the first
operand's shape and dtype, and an int32 add wraps.  On the card the kernel
takes int32 and float32.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.api import count_launch, kernel_device, register_kernel


def _ewise_plain(op: str, x: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The elementwise kernel's plain version."""
    if op == "add":
        return x + y
    return torch.maximum(x, torch.zeros_like(x))


def _ewise(op: str, x: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x + y`` (op ``"add"``) or ``max(x, 0)`` (op ``"relu"``), keeping
    dtype; the CUDA kernel for CUDA tensors."""
    operands = (x,) if op == "relu" else (x, y)
    dev = kernel_device(*operands)
    if dev.type == "cpu":
        return _ewise_plain(op, x, y)
    suffix = _build.entry_suffix(*operands)
    operands = [t.contiguous() for t in operands]
    out = torch.empty_like(operands[0])
    n = out.numel()
    if n == 0:
        return out
    name = "ewise_add" if op == "add" else "relu"
    _build.launch(f"{name}_{suffix}", dev, *(t.data_ptr() for t in operands), out.data_ptr(), n)
    count_launch(name)
    return out


@register_kernel("ewise_add", oracle=ref.ewise_add_ref)
def ewise_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x + y, matching shapes; ``y`` is cast to ``x``'s dtype first."""
    if x.shape != y.shape:
        raise ValueError(f"shapes differ: {tuple(x.shape)} vs {tuple(y.shape)}")
    return _ewise("add", x, y.to(x.dtype))


@register_kernel("relu", oracle=ref.relu_ref)
def relu(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0)."""
    return _ewise("relu", x)
