"""H-tree reduction kernel of the PyTorch port: ``(N, D) → (D,)`` summed
over N in the H-tree's order, adjacent pairs first.

Mirrors the JAX package's ``kernels/htree_reduce.py``.  One wrapper,
:func:`_htree`, launches ``csrc/htree_reduce.cu`` (replacing the Pallas
``_kernel``) for CUDA tensors and runs the plain version, the adjacent-pair
loop of ``ref.htree_reduce_ref``, for CPU tensors.  The order is the tree's
on both, so float32 and bfloat16 sums are bit-equal to the JAX package's
(each bfloat16 partial rounded to bfloat16) and int32 sums wrap.  N must be
a power of two; the kernels take float32, bfloat16 and int32, and so does
the wrapper on either device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.api import count_launch, kernel_device, register_kernel

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int32: "i32"}

_htree_plain = ref.htree_reduce_ref


def _htree(x: torch.Tensor) -> torch.Tensor:
    """Tree sum of the rows of ``x (N, D)`` → ``(D,)``; the CUDA kernel for
    CUDA tensors."""
    dev = kernel_device(x)
    if x.dtype not in _SUFFIX:
        raise TypeError(f"htree_reduce takes {sorted(map(str, _SUFFIX))} operands, got {x.dtype}")
    if dev.type == "cpu":
        return _htree_plain(x)
    n, d = x.shape
    if n < 1 or n & (n - 1):
        raise ValueError(f"the H-tree needs a power-of-two count of lanes, got {n}")
    if n * d >= 2**31:
        raise ValueError(f"extent {n * d} exceeds the kernels' 32-bit index range")
    x = x.contiguous()
    out = torch.empty((d,), dtype=x.dtype, device=dev)
    if d == 0:
        return out
    _build.launch(f"htree_reduce_{_SUFFIX[x.dtype]}", dev, x.data_ptr(), out.data_ptr(), n, d)
    count_launch("htree_reduce")
    return out


@register_kernel("htree_reduce", oracle=ref.htree_reduce_ref)
def htree_reduce(x: torch.Tensor) -> torch.Tensor:
    """x: (N, D) → (D,), N a power of two."""
    if x.dim() != 2:
        raise ValueError(f"htree_reduce takes (N, D) lanes, got shape {tuple(x.shape)}")
    return _htree(x)
