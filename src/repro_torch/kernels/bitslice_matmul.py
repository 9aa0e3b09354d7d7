"""The bit-sliced integer matmul of the PyTorch port.

Mirrors the JAX package's ``kernels/bitslice_matmul.py``: the registry
kernel ``bitslice_matmul`` computes

    Σ_{(s,t) in active_pairs} (x[s] @ w[t]) << (slice_bits·(s+t))

for ``(Sx, M, K)`` int8 × ``(Sw, K, N)`` int8 slice stacks → ``(M, N)``
int32, wrapping mod 2**32.  Its one wrapper, :func:`_bitslice_gemm`,
launches ``csrc/bitslice_gemm.cu`` (replacing the Pallas ``_kernel``) for
CUDA tensors and runs the plain version for CPU tensors.  The pair list it
hands the kernel is exactly ``api.active_pairs(Sx, Sw, skip)``: a skipped
pair is never launched.  Unlike the Pallas wrapper, M, N and K need not divide
any block size; the kernel masks the ragged edges.
"""
from __future__ import annotations

import threading
from typing import Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.api import (
    active_pairs,
    bitslice_matmul_oracle,
    count_launch,
    kernel_device,
    register_kernel,
)

MAX_PAIRS = 1024   # the kernel's parameter block holds this many pairs
MAX_SLICES = 64    # slices per operand (the kernel's slice-usage masks)

Pairs = Tuple[Tuple[int, int], ...]

# The pair list of the most recent kernel launch on this thread, in the order
# the kernel was given it.
_launched = threading.local()


def launched_pairs() -> Pairs:
    """The (s, t) pairs the most recent CUDA launch of the bit-sliced GEMM on
    this thread was given (``()`` before any)."""
    return getattr(_launched, "pairs", ())


# The kernel's plain version: the shifted int32 products of exactly ``pairs``.
_bitslice_plain = ref.bitslice_pairs_ref


def _bitslice_gemm(x: torch.Tensor, w: torch.Tensor, slice_bits: int, pairs: Pairs) -> torch.Tensor:
    """``Σ_{(s,t) in pairs} (x[s] @ w[t]) << (slice_bits·(s+t))`` of int8
    slice stacks, int32 wrapping; the CUDA kernel for CUDA tensors."""
    dev = kernel_device(x, w)
    if dev.type == "cpu":
        return _bitslice_plain(x, w, slice_bits, pairs)
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"the bit-sliced GEMM takes int8 slice stacks, got {x.dtype} and {w.dtype}")
    (sx, m, k), (sw, _, n) = x.shape, w.shape
    if max(sx, sw) > MAX_SLICES or len(pairs) > MAX_PAIRS:
        raise ValueError(f"the kernel takes at most {MAX_SLICES} slices per operand and "
                         f"{MAX_PAIRS} pairs, got {sx}, {sw} slices and {len(pairs)} pairs")
    for t in (x, w):
        if max(t.shape) >= 2**31:
            raise ValueError(f"shape {tuple(t.shape)} exceeds the kernel's index range")
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty((m, n), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    # sorted by diagonal: the kernel shifts each diagonal's sum once per K tile
    order = tuple(sorted(pairs, key=lambda p: (p[0] + p[1], p)))
    x_words = int(k % 4 == 0 and x.data_ptr() % 4 == 0)
    _build.launch("bitslice_gemm_i8", dev, x.data_ptr(), w.data_ptr(), out.data_ptr(),
                  m, n, k, sx, sw, slice_bits, x_words,
                  bytes(s for s, _ in order), bytes(t for _, t in order), len(order))
    count_launch("bitslice_matmul")
    _launched.pairs = order
    return out


@register_kernel("bitslice_matmul", oracle=bitslice_matmul_oracle)
def bitslice_matmul(
    x_slices: torch.Tensor,
    w_slices: torch.Tensor,
    *,
    slice_bits: int = 8,
    skip: Pairs = (),
) -> torch.Tensor:
    """(Sx, M, K) int8 × (Sw, K, N) int8 → (M, N) int32.

    ``skip`` lists (s, t) slice pairs known to contribute zero (PIMSAB
    zero-bit skipping); they are never launched: the kernel's pair list is
    exactly ``api.active_pairs(Sx, Sw, skip)``.
    """
    sx, m, k = x_slices.shape
    sw, k2, n = w_slices.shape
    if k != k2:
        raise ValueError(f"inner dimensions differ: {tuple(x_slices.shape)} @ {tuple(w_slices.shape)}")
    return _bitslice_gemm(x_slices, w_slices, slice_bits, active_pairs(sx, sw, skip))
