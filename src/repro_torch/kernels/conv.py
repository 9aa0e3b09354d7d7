"""The DL-network layer set (conv / pool / integer gemm) of the PyTorch port.

Mirrors the JAX package's ``kernels/conv.py``.  Two kernels carry it, each
behind one wrapper that launches the CUDA kernel for CUDA tensors and runs
the plain version for CPU tensors:

* :func:`_gemm` — ``csrc/int_gemm.cu``, replacing the Pallas ``_dot_kernel``:
  ``conv2d`` is ``ref.im2col`` (glue, as in the JAX package) followed by this
  GEMM, and ``int_matmul`` is the GEMM alone.
* :func:`_pool_rows` — ``csrc/pool_reduce.cu``, replacing
  ``_pool_sum_kernel`` and ``_pool_max_kernel``: a row sum or row max over
  the ``ref.pool_patches`` window matrix.  The integer floor-divide of the
  averages stays outside the kernel (``ref._pool_mean``).

On the card the kernels take int32 and float32; integer inputs are cast to
int32 and float inputs to float32 first, as the JAX kernels do.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.api import count_launch, kernel_device, register_kernel

# ---------------------------------------------------------------------------
# GEMM (replaces conv.py:_dot_kernel)
# ---------------------------------------------------------------------------


def _gemm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The GEMM kernel's plain version: an int32 product wraps on the CPU."""
    return x @ w


def _gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``(M, K) @ (K, N)`` of two int32 or two float32 matrices, int32
    accumulation wrapping; the CUDA kernel for CUDA tensors."""
    dev = kernel_device(x, w)
    if dev.type == "cpu":
        return _gemm_plain(x, w)
    suffix = _build.entry_suffix(x, w)
    (m, k), (k2, n) = x.shape, w.shape
    if k != k2:
        raise ValueError(f"inner dimensions differ: {tuple(x.shape)} @ {tuple(w.shape)}")
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    if out.numel() == 0:
        return out
    _build.launch(f"int_gemm_{suffix}", dev, x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k)
    count_launch("gemm")
    return out


# ---------------------------------------------------------------------------
# row reductions (replace conv.py:_pool_sum_kernel / _pool_max_kernel)
# ---------------------------------------------------------------------------


def _pool_rows_plain(p: torch.Tensor, op: str) -> torch.Tensor:
    """The pool kernel's plain version (sums stay in the input dtype, so an
    int32 sum wraps)."""
    if op == "sum":
        return torch.sum(p, dim=1, dtype=p.dtype)
    return torch.amax(p, dim=1)


POOL_THREADS = 256  # csrc/pool_reduce.cu: THREADS


def pool_plan(rows: int, k: int, ptr: int) -> Tuple[int, bool, int]:
    """Launch plan of ``csrc/pool_reduce.cu`` for a contiguous ``(rows, k)``
    matrix at address ``ptr``: ``(lanes, vec, blocks)``.  ``lanes`` (a power
    of two, at most a warp) share a row, sized so that they cover it with one
    16-byte vector each; ``vec`` selects 16-byte loads, which need every row
    16-byte aligned; ``blocks`` give each group of lanes one row (rows <
    2**31, as ``_build.entry_suffix`` checks: within CUDA's grid)."""
    lanes = 1
    while lanes < 32 and 4 * lanes < k:
        lanes *= 2
    vec = k % 4 == 0 and ptr % 16 == 0
    return lanes, vec, max(1, -(-rows // (POOL_THREADS // lanes)))


def _pool_rows(p: torch.Tensor, op: str) -> torch.Tensor:
    """Row ``op`` (``"sum"`` or ``"max"``) of a ``(P, K)`` window matrix, in
    its dtype; the CUDA kernel for CUDA tensors."""
    dev = kernel_device(p)
    if dev.type == "cpu":
        return _pool_rows_plain(p, op)
    suffix = _build.entry_suffix(p)
    rows, k = p.shape
    if op == "max" and k == 0:
        raise ValueError("max over an empty window")
    p = p.contiguous()
    out = torch.empty((rows,), dtype=p.dtype, device=dev)
    if rows == 0:
        return out
    lanes, vec, blocks = pool_plan(rows, k, p.data_ptr())
    _build.launch(f"pool_{op}_{suffix}", dev, p.data_ptr(), out.data_ptr(), rows, k, lanes, int(vec), blocks)
    count_launch(f"pool_{op}")
    return out


# ---------------------------------------------------------------------------
# registered kernels
# ---------------------------------------------------------------------------


@register_kernel("conv2d", oracle=ref.conv2d_ref)
def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    stride: int = 1,
    padding: int = 0,
    x_bits: Optional[int] = None,
    w_bits: Optional[int] = None,
) -> torch.Tensor:
    """(N, C, H, W) × (OC, C, KH, KW) → (N, OC, OH, OW) via im2col + GEMM.

    Integer inputs accumulate in int32 (wrapping), float inputs in float32.
    ``x_bits``/``w_bits`` are simulator-lowering hints, ignored here.
    """
    del x_bits, w_bits
    n, c, h, hw = x.shape
    oc, c2, kh, kw = w.shape
    if c != c2:
        raise ValueError(f"input has {c} channels, weight expects {c2}")
    acc = ref.acc_dtype(x)
    oh, ow = ref.conv2d_out_hw(h, hw, kh, kw, stride, padding)
    patches = ref.im2col(x.to(acc), kh, kw, stride, padding)   # (N·OH·OW, C·KH·KW)
    wm = w.to(acc).reshape(oc, c * kh * kw).T                  # (C·KH·KW, OC)
    out = _gemm(patches, wm)
    return out.reshape(n, oh, ow, oc).permute(0, 3, 1, 2)


@register_kernel("int_matmul", oracle=ref.int_matmul_ref)
def int_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    x_bits: Optional[int] = None,
    w_bits: Optional[int] = None,
) -> torch.Tensor:
    """(M, K) × (K, N) raw-integer matmul, int32 accumulation (wrapping)."""
    del x_bits, w_bits
    return _gemm(x.to(torch.int32), w.to(torch.int32))


@register_kernel("maxpool2d", oracle=ref.maxpool2d_ref)
def maxpool2d(x: torch.Tensor, *, window: int = 2, stride: Optional[int] = None) -> torch.Tensor:
    """(N, C, H, W) → (N, C, OH, OW) window max (no padding), keeping dtype."""
    s = stride or window
    n, c, h, w = x.shape
    oh, ow = ref.conv2d_out_hw(h, w, window, window, s, 0)
    out = _pool_rows(ref.pool_patches(x, window, s), "max")
    return out.reshape(n, c, oh, ow)


@register_kernel("avgpool2d", oracle=ref.avgpool2d_ref)
def avgpool2d(x: torch.Tensor, *, window: int = 2) -> torch.Tensor:
    """(N, C, H, W) → (N, C, OH, OW) window average, stride == window;
    integer inputs floor-divide by the window count."""
    n, c, h, w = x.shape
    oh, ow = ref.conv2d_out_hw(h, w, window, window, window, 0)
    patches = ref.pool_patches(x, window, window).to(ref.acc_dtype(x))
    s = _pool_rows(patches, "sum")
    return ref._pool_mean(s, window * window).reshape(n, c, oh, ow)


@register_kernel("global_avgpool", oracle=ref.global_avgpool_ref)
def global_avgpool(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) → (N, C) spatial average (integer: floor-divide by H·W)."""
    n, c, h, w = x.shape
    s = _pool_rows(x.reshape(n * c, h * w).to(ref.acc_dtype(x)), "sum")
    return ref._pool_mean(s, h * w).reshape(n, c)
