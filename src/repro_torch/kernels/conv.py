"""The DL-network layer set (conv / pool / integer gemm) of the PyTorch port.

Mirrors the JAX package's ``kernels/conv.py``.  Two kernels carry it, each
behind one wrapper that launches the CUDA kernel for CUDA tensors and runs
the plain version for CPU tensors:

* :func:`_gemm` — ``csrc/int_gemm.cu``, replacing the Pallas ``_dot_kernel``:
  ``conv2d`` is ``ref.im2col`` (glue, as in the JAX package) followed by this
  GEMM against the weight in its own ``(OC, C·KH·KW)`` layout, and
  ``int_matmul`` is the GEMM alone with B as ``(K, N)``.  For int32,
  :func:`gemm_plan` picks an int8 tensor-core digit kernel or, at M <= 16,
  a split-K kernel for small M.
* :func:`_pool_rows` — ``csrc/pool_reduce.cu``, replacing
  ``_pool_sum_kernel`` and ``_pool_max_kernel``: a row sum or row max over
  the ``ref.pool_patches`` window matrix.  The integer floor-divide of the
  averages stays outside the kernel (``ref._pool_mean``).

On the card the kernels take int32 and float32; integer inputs are cast to
int32 and float inputs to float32 first, as the JAX kernels do.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.api import count_launch, kernel_device, register_kernel

# ---------------------------------------------------------------------------
# GEMM (replaces conv.py:_dot_kernel)
# ---------------------------------------------------------------------------


def _gemm_plain(x: torch.Tensor, w: torch.Tensor, b_layout: str = "kn") -> torch.Tensor:
    """The GEMM kernel's plain version: an int32 product wraps on the CPU."""
    return x @ (w.T if b_layout == "nk" else w)


GEMM_TILE = (64, 64, 32)       # csrc/int_gemm.cu: TBM, TBN, TBK
GEMM_K_CHUNK = 8192            # K a tile block may sum: 4 pairs · 8192 · 255² < 2**31
GEMM_TARGET_BLOCKS = 2 * 132   # tile blocks resident on one H100 (2 a SM)
GEMM_MIN_SPLIT_K = 256         # the shortest K range a split is given
GEMM_SMALL_M = 16              # M up to which a (K, N) B takes the small-M kernel
GEMM_SMALL_THREADS = 128       # csrc/int_gemm.cu: SMALL_THREADS
GEMM_SMALL_MAX_K = 256         # csrc/int_gemm.cu: SMALL_MAX_K
GEMM_SMALL_MIN_K = 32          # the shortest K range of a small-M split
GEMM_SMALL_TARGET_THREADS = 132 * 512


class GemmPlan(NamedTuple):
    """Launch plan of the int32 kernels of ``csrc/int_gemm.cu``."""

    path: str      # "tile" (tensor-core digits) or "small" (M <= 16, B (K, N))
    a_vec: bool    # 16-byte copies of A's rows (tile path)
    b_vec: bool    # 16-byte copies of B's rows
    splits: int    # K ranges, each added into a zeroed C when more than one
    k_chunk: int   # K of each range


def gemm_plan(m: int, n: int, k: int, b_layout: str, ptrs: Tuple[int, int]) -> GemmPlan:
    """Launch plan of the int32 GEMM ``(m, k) @ B`` for contiguous operands
    at addresses ``ptrs = (A, B)``, B ``(k, n)`` (``"kn"``) or ``(n, k)``
    (``"nk"``).

    M <= 16 with a ``(k, n)`` B takes the small-M kernel: a thread a group
    of four columns (16-byte loads where ``n % 4 == 0`` and B is 16-byte
    aligned) or one, K split into ranges of at most GEMM_SMALL_MAX_K (the A
    rows a block stages) so that the grid holds about
    GEMM_SMALL_TARGET_THREADS.  Everything else takes the tensor-core tile
    kernel: 64 × 64 tiles of C, 16-byte copies of a row-major operand whose
    rows are all 16-byte aligned, and K split into ranges of whole K tiles
    when the tiles alone do not fill GEMM_TARGET_BLOCKS, each range at least
    GEMM_MIN_SPLIT_K long and never longer than GEMM_K_CHUNK, past which a
    digit-pair accumulator could overflow."""
    if b_layout not in ("kn", "nk"):
        raise ValueError(f"B's layout is 'kn' or 'nk', got {b_layout!r}")
    a_ptr, b_ptr = ptrs
    if m <= GEMM_SMALL_M and b_layout == "kn":
        vec = n % 4 == 0 and b_ptr % 16 == 0
        blocks_n = max(1, -(-(n // 4 if vec else n) // GEMM_SMALL_THREADS))
        splits = -(-GEMM_SMALL_TARGET_THREADS // (blocks_n * GEMM_SMALL_THREADS))
        splits = max(1, min(splits, -(-k // GEMM_SMALL_MIN_K)), -(-k // GEMM_SMALL_MAX_K))
        k_chunk = max(1, -(-k // splits))
        return GemmPlan("small", False, vec, max(1, -(-k // k_chunk)), k_chunk)
    tm, tn, tk = GEMM_TILE
    tiles = -(-m // tm) * -(-n // tn)
    k_tiles = -(-k // tk)
    splits = max(1, min(GEMM_TARGET_BLOCKS // tiles, -(-k // GEMM_MIN_SPLIT_K)), -(-k // GEMM_K_CHUNK))
    k_chunk = max(1, -(-k_tiles // splits)) * tk
    splits = max(1, -(-k // k_chunk))
    a_vec = k % 4 == 0 and a_ptr % 16 == 0
    b_vec = b_layout == "nk" and k % 4 == 0 and b_ptr % 16 == 0
    return GemmPlan("tile", a_vec, b_vec, splits, k_chunk)


GEMM_F32_TILE = (128, 64, 16)     # csrc/int_gemm.cu: FBM, FBN, FBK
GEMM_F32_STAGES = 2               # csrc/int_gemm.cu: F_STAGES
GEMM_F32_TARGET_BLOCKS = 2 * 132  # 128-thread float32 blocks resident on one H100 (2 a SM)
GEMM_F32_MIN_SPLIT_K = 256        # the shortest K range a float32 split is given


class GemmF32Plan(NamedTuple):
    """Launch plan of the float32 kernel of ``csrc/int_gemm.cu``."""

    b_vec: bool    # 16-byte copies of a (K, N) B's rows
    splits: int    # K ranges; more than one go to a workspace added in order
    k_chunk: int   # K of each range, a multiple of the K tile


def gemm_f32_plan(m: int, n: int, k: int, b_layout: str, ptrs: Tuple[int, int]) -> GemmF32Plan:
    """Launch plan of the float32 GEMM ``(m, k) @ B`` for contiguous operands
    at addresses ``ptrs = (A, B)``, B ``(k, n)`` (``"kn"``) or ``(n, k)``
    (``"nk"``).

    128 × 64 tiles of C; K split into ranges of whole K tiles when the tiles
    alone do not fill GEMM_F32_TARGET_BLOCKS, each range at least
    GEMM_F32_MIN_SPLIT_K long.  The splits' partial tiles are added in
    split order by a second kernel (no float atomics), so a result has the
    same bits on every run.  A ``(k, n)`` B takes 16-byte copies when ``n %
    4 == 0`` and B is 16-byte aligned; A and an ``(n, k)`` B are transposed
    on their way into shared memory by 4-byte copies."""
    if b_layout not in ("kn", "nk"):
        raise ValueError(f"B's layout is 'kn' or 'nk', got {b_layout!r}")
    tm, tn, tk = GEMM_F32_TILE
    tiles = -(-m // tm) * -(-n // tn)
    splits = max(1, min(GEMM_F32_TARGET_BLOCKS // max(tiles, 1), -(-k // GEMM_F32_MIN_SPLIT_K)))
    k_tiles = -(-k // tk)
    k_chunk = max(1, -(-k_tiles // splits)) * tk
    splits = max(1, -(-k // k_chunk))
    b_vec = b_layout == "kn" and n % 4 == 0 and ptrs[1] % 16 == 0
    return GemmF32Plan(b_vec, splits, k_chunk)


def _gemm(x: torch.Tensor, w: torch.Tensor, b_layout: str = "kn") -> torch.Tensor:
    """``(M, K) @ B`` of two int32 or two float32 matrices, B ``(K, N)``
    (``"kn"``) or ``(N, K)`` (``"nk"``, read as its transpose), int32
    accumulation wrapping; the CUDA kernel for CUDA tensors."""
    dev = kernel_device(x, w)
    if dev.type == "cpu":
        return _gemm_plain(x, w, b_layout)
    suffix = _build.entry_suffix(x, w)
    if b_layout not in ("kn", "nk"):
        raise ValueError(f"B's layout is 'kn' or 'nk', got {b_layout!r}")
    (m, k), (k2, n) = x.shape, (w.shape[::-1] if b_layout == "nk" else w.shape)
    if k != k2:
        raise ValueError(f"inner dimensions differ: {tuple(x.shape)} @ {tuple(w.shape)} ({b_layout})")
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    if out.numel() == 0:
        return out
    nk = int(b_layout == "nk")
    if suffix == "f32":
        p = gemm_f32_plan(m, n, k, b_layout, (x.data_ptr(), w.data_ptr()))
        ws = torch.empty((p.splits, m, n), dtype=torch.float32, device=dev) if p.splits > 1 else None
        _build.launch("int_gemm_f32", dev, x.data_ptr(), w.data_ptr(), out.data_ptr(),
                      None if ws is None else ws.data_ptr(), m, n, k, nk, int(p.b_vec), p.splits, p.k_chunk)
    else:
        p = gemm_plan(m, n, k, b_layout, (x.data_ptr(), w.data_ptr()))
        _build.launch("int_gemm_i32", dev, x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, nk,
                      int(p.path == "small"), int(p.a_vec), int(p.b_vec), p.splits, p.k_chunk)
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
    wm = w.to(acc).reshape(oc, c * kh * kw)                    # (OC, C·KH·KW): no copy
    out = _gemm(patches, wm, "nk")
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
