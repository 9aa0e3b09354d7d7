"""H-tree reduction kernel of the PyTorch port: ``(N, D) → (D,)`` summed
over N in the H-tree's order, adjacent pairs first.

Mirrors the JAX package's ``kernels/htree_reduce.py``.  One wrapper,
:func:`_htree`, launches ``csrc/htree_reduce.cu`` (replacing the Pallas
``_kernel``) for CUDA tensors and runs the plain version, the adjacent-pair
loop of ``ref.htree_reduce_ref``, for CPU tensors.  The order is the tree's
on both, so float32 and bfloat16 sums are bit-equal to the JAX package's
(each bfloat16 partial rounded to bfloat16) and int32 sums wrap.  N must be
a power of two; the kernels take float32, bfloat16 and int32, and so does
the wrapper on either device.  The kernel splits each column into chunks
of the tree; :func:`htree_plan` lays out its launch.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.api import count_launch, kernel_device, register_kernel

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int32: "i32"}

_htree_plain = ref.htree_reduce_ref

HTREE_THREADS = 256     # csrc/htree_reduce.cu: CHUNK_THREADS
HTREE_MAX_CHUNKS = 32   # csrc/htree_reduce.cu: MAX_CHUNKS
# threads the grid aims at: half of one H100's resident threads (132 SMs ×
# 2048), which leaves a thread 32 rows at (256, 65536) in float32 or int32
HTREE_TARGET_THREADS = 132 * 1024


def htree_plan(n: int, d: int, ptr: int, itemsize: int = 4) -> Tuple[int, bool, int]:
    """Launch plan of ``csrc/htree_reduce.cu`` for a contiguous ``(n, d)``
    matrix of ``itemsize``-byte elements at address ``ptr`` (``n`` a power
    of two): ``(chunks, vec, blocks)``.  Each column's ``n`` rows split into
    ``chunks`` aligned subtrees of ``n // chunks`` rows, one a thread;
    ``vec`` gives a thread the 16 bytes of ``16 // itemsize`` neighbouring
    columns with one load a row, which needs ``d`` a multiple of them and a
    16-byte aligned base; the chunks double while the grid stays within
    HTREE_TARGET_THREADS (and a block keeps at least 8 column groups);
    ``blocks`` cover the column groups."""
    lanes = 16 // itemsize
    vec = d % lanes == 0 and ptr % 16 == 0
    groups = d // lanes if vec else d
    chunks = 1
    while 2 * chunks <= min(n, HTREE_MAX_CHUNKS) and 2 * chunks * groups <= HTREE_TARGET_THREADS:
        chunks *= 2
    cols = HTREE_THREADS // chunks
    return chunks, vec, max(1, -(-groups // cols))


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
    chunks, vec, blocks = htree_plan(n, d, x.data_ptr(), x.element_size())
    _build.launch(f"htree_reduce_{_SUFFIX[x.dtype]}", dev, x.data_ptr(), out.data_ptr(), n, d, chunks, int(vec), blocks)
    count_launch("htree_reduce")
    return out


@register_kernel("htree_reduce", oracle=ref.htree_reduce_ref)
def htree_reduce(x: torch.Tensor) -> torch.Tensor:
    """x: (N, D) → (D,), N a power of two."""
    if x.dim() != 2:
        raise ValueError(f"htree_reduce takes (N, D) lanes, got shape {tuple(x.shape)}")
    return _htree(x)
