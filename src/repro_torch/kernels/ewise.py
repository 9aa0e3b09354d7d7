"""Elementwise map kernels (add / relu) of the PyTorch port.

Mirrors the JAX package's ``kernels/ewise.py``.  One wrapper,
:func:`_ewise`, launches ``csrc/ewise.cu`` (replacing the Pallas
``_add_kernel`` and ``_relu_kernel``) for CUDA tensors and runs the plain
version for CPU tensors.  The kernel walks the operands' storage in order,
so dense operands of one layout (contiguous, or the channels-last views that
``conv2d`` returns) are read where they lie and the result keeps that
layout, as the plain version's does; the result keeps the first operand's
shape and dtype, and an int32 add wraps.  On the card the kernel takes int32
and float32.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.api import count_launch, kernel_device, register_kernel


def _ewise_plain(op: str, x: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The elementwise kernel's plain version."""
    if op == "add":
        return x + y
    return torch.maximum(x, torch.zeros_like(x))


EWISE_THREADS = 128  # csrc/ewise.cu: THREADS


def walks_in_storage_order(operands: Sequence[torch.Tensor]) -> bool:
    """Whether the kernel may walk the operands' storage in order: the first
    is dense (contiguous or channels-last) and all share its strides, so one
    storage offset holds one element of each, and ``torch.empty_like`` of the
    first gives a result laid out the same way."""
    first = operands[0]
    dense = first.is_contiguous() or first.is_contiguous(memory_format=torch.channels_last)
    return dense and all(t.stride() == first.stride() for t in operands[1:])


def ewise_plan(n: int, ptrs: Sequence[int]) -> Tuple[bool, int]:
    """Launch plan of ``csrc/ewise.cu`` for ``n`` 4-byte elements at addresses
    ``ptrs`` (operands and result): ``(vec, blocks)``.  16-byte vectors need
    every address 16-byte aligned; their grid gives each thread one vector
    and one more thread the ``n % 4`` tail, the scalar grid one element a
    thread (at most 2**34 int32 on an 80 GB card: within CUDA's grid)."""
    if all(p % 16 == 0 for p in ptrs):
        return True, max(1, -(-(n // 4 + (n % 4 > 0)) // EWISE_THREADS))
    return False, max(1, -(-n // EWISE_THREADS))


def _ewise(op: str, x: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x + y`` (op ``"add"``) or ``max(x, 0)`` (op ``"relu"``), keeping
    dtype; the CUDA kernel for CUDA tensors.  Operands that
    :func:`walks_in_storage_order` are read where they lie and the result
    takes their layout; others are copied to contiguous first."""
    operands = (x,) if op == "relu" else (x, y)
    dev = kernel_device(*operands)
    if dev.type == "cpu":
        return _ewise_plain(op, x, y)
    suffix = _build.entry_suffix(*operands)
    if not walks_in_storage_order(operands):
        operands = [t.contiguous() for t in operands]
    out = torch.empty_like(operands[0])
    n = out.numel()
    if n == 0:
        return out
    ptrs = [t.data_ptr() for t in (*operands, out)]
    vec, blocks = ewise_plan(n, ptrs)
    name = "ewise_add" if op == "add" else "relu"
    _build.launch(f"{name}_{suffix}", dev, *ptrs, n, int(vec), blocks)
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
