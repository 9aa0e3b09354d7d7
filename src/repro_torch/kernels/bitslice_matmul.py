"""The bit-sliced integer matmul of the PyTorch port.

Mirrors the JAX package's ``kernels/bitslice_matmul.py``: the registry
kernel ``bitslice_matmul`` computes

    Σ_{(s,t) in active_pairs} (x[s] @ w[t]) << (slice_bits·(s+t))

for ``(Sx, M, K)`` int8 × ``(Sw, K, N)`` int8 slice stacks → ``(M, N)``
int32, wrapping mod 2**32.  Its one wrapper, :func:`_bitslice_gemm`,
launches ``csrc/bitslice_gemm.cu`` (replacing the Pallas ``_kernel``) for
CUDA tensors and runs the plain version for CPU tensors.  The pair list it
hands the kernel is exactly ``api.active_pairs(Sx, Sw, skip)``: a skipped
pair is never launched.  :func:`bitslice_plan` picks the kernel's path: int8
tensor cores (``mma.sync``) for every ``PrecisionSpec`` preset, ``__dp4a``
for the rest.  Unlike the Pallas wrapper, M, N and K need not divide any
block size; the kernel masks the ragged edges.

:func:`grouped_matmul` is the same kernel's tensor-core tile over groups of
rows, each against its own weight (a mixture of experts' routed rows), in
one launch; it counts its launches as ``grouped_matmul``.

:func:`dequant_matmul` and :func:`grouped_dequant_matmul` are the
quantized linear's product of one slice pair with its dequantize in the
tensor-core path's epilogue: the int32 sums leave the kernel as
``(acc.to(float32) * x_scale * w_scale (+ bias.to(float32))).to(dtype)``
(``api.dequant_plain``, the chain they replace, which their plain versions
run), bit for bit.  They count their launches as ``bitslice_matmul`` and
``grouped_matmul``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.api import (
    active_pairs,
    bitslice_matmul_oracle,
    count_launch,
    dequant_plain,
    kernel_device,
    launch_record,
    meta_operands,
    note_executed_pairs,
    note_kernel_work,
    noting_work,
    plain_scope,
    register_kernel,
)

MAX_PAIRS = 1024   # the kernel's parameter block holds this many pairs
MAX_SLICES = 64    # slices per operand (the kernel's slice-usage masks)

# the tensor-core path (csrc/bitslice_gemm.cu, namespace tc)
BITSLICE_MMA_BK = 128         # BK: bytes of K a shared-memory stage holds
BITSLICE_MMA_STAGES = 3       # STAGES
BITSLICE_FOLD_LP = 2**17 - 1  # FOLD_LP: K · pairs a diagonal's s32 accumulator may sum
BITSLICE_NARROW_N = 32        # N up to which the narrow tile is taken
# (BM, BN, WM): output tile and the rows of a warp's 32-column share
BITSLICE_MMA_TILES = {"narrow": (128, 32, 32), "square": (128, 128, 64), "square_2x2": (64, 128, 32)}
# the dequantizing epilogue's output and bias dtypes (DT_*; 0: no bias)
DTYPE_CODES = {torch.float32: 1, torch.bfloat16: 2, torch.float16: 3}

Pairs = Tuple[Tuple[int, int], ...]
ONE_PAIR: Pairs = ((0, 0),)  # a single-pass product: one slice each, no shift
ONE_PAIR_FOLD_K = BITSLICE_FOLD_LP // BITSLICE_MMA_BK * BITSLICE_MMA_BK  # bitslice_plan's fold_k for it


class BitslicePlan(NamedTuple):
    """Launch plan of ``csrc/bitslice_gemm.cu``."""

    path: str                   # "mma" (int8 tensor cores) or "dp4a"
    x_slices: Tuple[int, ...]   # slices some computed pair reads, low to high
    w_slices: Tuple[int, ...]
    shifts: Tuple[int, ...]     # mma: slice_bits·(s+t) of local diagonal i + j
    tile: Optional[str]         # mma: a key of BITSLICE_MMA_TILES
    fold_k: int                 # mma: K a block sums in s32 between folds into out
    w_vec: bool                 # mma: 16-byte copies of w rows (else 4-byte)
    x_words: bool               # dp4a: x read in 4-byte words


def bitslice_plan(sx: int, sw: int, m: int, n: int, k: int, slice_bits: int, pairs: Pairs,
                  ptrs: Tuple[int, int]) -> BitslicePlan:
    """Launch plan of the bit-sliced GEMM of ``(sx, m, k)`` × ``(sw, k, n)``
    contiguous int8 stacks at addresses ``ptrs = (x, w)`` over ``pairs``
    (the tensor-core path always takes BITSLICE_MMA_STAGES stages).

    Pairs whose shift ``slice_bits·(s+t)`` is 32 or more add 0 mod 2**32
    and are not computed.  The tensor-core path takes the computed pairs
    when they are all pairs of at most two x slices and two w slices (with
    equal gaps in the 2 × 2 case, so that local diagonal i + j is one
    diagonal s + t), K % 16 == 0, x 16-byte aligned, N % 4 == 0 and w
    4-byte aligned; everything else takes ``__dp4a``.  A block of the
    tensor-core path sums at most ``fold_k`` of K in its s32 accumulators,
    the largest multiple of BITSLICE_MMA_BK with ``fold_k · p`` <=
    BITSLICE_FOLD_LP for p pairs a diagonal (|x·w| <= 2**14, so every
    accumulator stays exact), then folds them into its output tile."""
    x_ptr, w_ptr = ptrs
    live = [(s, t) for s, t in pairs if slice_bits * (s + t) < 32]
    xs, ws = tuple(sorted({s for s, _ in live})), tuple(sorted({t for _, t in live}))
    dp4a = BitslicePlan("dp4a", xs, ws, (), None, 0, False, k % 4 == 0 and x_ptr % 4 == 0)
    if (not live or len(xs) > 2 or len(ws) > 2 or set(live) != {(s, t) for s in xs for t in ws}
            or (len(xs) == len(ws) == 2 and xs[1] - xs[0] != ws[1] - ws[0])
            or k % 16 or x_ptr % 16 or n % 4 or w_ptr % 4):
        return dp4a
    nx, nw = len(xs), len(ws)
    shifts = tuple(slice_bits * (xs[min(e, nx - 1)] + ws[e - min(e, nx - 1)]) for e in range(nx + nw - 1))
    per_diagonal = 2 if nx == nw == 2 else 1
    fold_k = BITSLICE_FOLD_LP // per_diagonal // BITSLICE_MMA_BK * BITSLICE_MMA_BK
    tile = "narrow" if n <= BITSLICE_NARROW_N else "square_2x2" if nx == nw == 2 else "square"
    return BitslicePlan("mma", xs, ws, shifts, tile, fold_k, n % 16 == 0 and w_ptr % 16 == 0, False)

# The pair list of the most recent kernel launch on this thread, in the order
# the kernel was given it.
_launched = launch_record()


def launched_pairs() -> Pairs:
    """The (s, t) pairs the most recent CUDA launch of the bit-sliced GEMM on
    this thread was given (``()`` before any)."""
    return getattr(_launched, "pairs", ())


def launched_path() -> Optional[str]:
    """The path (``"mma"`` or ``"dp4a"``) of the most recent CUDA launch of
    the bit-sliced GEMM on this thread (None before any)."""
    return getattr(_launched, "path", None)


# The kernel's plain version: the shifted int32 products of exactly ``pairs``.
_bitslice_plain = ref.bitslice_pairs_ref


def bitslice_work(x_shape, w_shape, slice_bits: int, pairs: Pairs, itemsize: int = 1) -> Tuple[int, int]:
    """(operations, bytes) of one call: two operations (multiply, add) per
    product of each computed pair; each slice a computed pair reads, read
    once, and the int32 output written once.  A pair whose shift is 32 or
    more adds 0 mod 2**32 and is not computed."""
    (_, m, k), (_, _, n) = x_shape, w_shape
    live = [(s, t) for s, t in pairs if slice_bits * (s + t) < 32]
    nbytes = (len({s for s, _ in live}) * m * k + len({t for _, t in live}) * k * n) * itemsize + 4 * m * n
    return 2 * m * k * n * len(live), nbytes


def _bitslice_gemm(x: torch.Tensor, w: torch.Tensor, slice_bits: int, pairs: Pairs) -> torch.Tensor:
    """``Σ_{(s,t) in pairs} (x[s] @ w[t]) << (slice_bits·(s+t))`` of int8
    slice stacks, int32 wrapping; the CUDA kernel for CUDA tensors; for
    ``meta`` ones the card's checks, then a ``meta`` output."""
    meta = meta_operands(x, w)
    dev = x.device if meta else kernel_device(x, w)
    (sx, m, k), (sw, _, n) = x.shape, w.shape
    if m * n and noting_work():
        note_kernel_work("bitslice_matmul", *bitslice_work(x.shape, w.shape, slice_bits, pairs, x.element_size()))
    if dev.type == "cpu":
        with plain_scope():
            return _bitslice_plain(x, w, slice_bits, pairs)
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"the bit-sliced GEMM takes int8 slice stacks, got {x.dtype} and {w.dtype}")
    if max(sx, sw) > MAX_SLICES or len(pairs) > MAX_PAIRS:
        raise ValueError(f"the kernel takes at most {MAX_SLICES} slices per operand and "
                         f"{MAX_PAIRS} pairs, got {sx}, {sw} slices and {len(pairs)} pairs")
    for t in (x, w):
        if max(t.shape) >= 2**31:
            raise ValueError(f"shape {tuple(t.shape)} exceeds the kernel's index range")
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty((m, n), dtype=torch.int32, device=dev)
    if out.numel() == 0 or meta:
        return out
    # sorted by diagonal: the kernel sums each diagonal in one accumulator
    order = tuple(sorted(pairs, key=lambda p: (p[0] + p[1], p)))
    plan = bitslice_plan(sx, sw, m, n, k, slice_bits, order, (x.data_ptr(), w.data_ptr()))
    if plan.path == "mma":
        xp = [x.data_ptr() + s * m * k for s in plan.x_slices]
        wp = [w.data_ptr() + t * k * n for t in plan.w_slices]
        shifts = plan.shifts + (0,) * (3 - len(plan.shifts))
        _build.launch("bitslice_gemm_mma", dev, xp[0], xp[-1], wp[0], wp[-1], out.data_ptr(), m, n, k,
                      len(xp), len(wp), *shifts, int(plan.tile == "narrow"), int(plan.w_vec),
                      plan.fold_k // BITSLICE_MMA_BK)
    else:
        _build.launch("bitslice_gemm_i8", dev, x.data_ptr(), w.data_ptr(), out.data_ptr(),
                      m, n, k, sx, sw, slice_bits, int(plan.x_words),
                      bytes(s for s, _ in order), bytes(t for _, t in order), len(order))
    count_launch("bitslice_matmul")
    _launched.pairs, _launched.path = order, plan.path
    return out


def grouped_plan(k: int, n: int, w_ptr: int) -> Tuple[int, int]:
    """(16-byte copies of w rows, K tiles between folds) of the grouped
    product: one slice pair, so ``fold_k`` as :func:`bitslice_plan` takes it
    for one pair a diagonal."""
    return int(n % 16 == 0 and w_ptr % 16 == 0), BITSLICE_FOLD_LP // BITSLICE_MMA_BK


def grouped_work(rows: int, k: int, n: int, groups: int) -> Tuple[int, int]:
    """(operations, bytes) of one grouped call: two operations a product of
    each row with its group's weight; the rows, every group's weight and
    the int32 output once (the offsets' few bytes not counted)."""
    return 2 * rows * k * n, rows * k + groups * k * n + 4 * rows * n


def _grouped_plain(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """The grouped product's plain version: each group's rows through the
    bit-sliced GEMM's plain version (one pair, no shift)."""
    out = torch.empty((x.shape[0], w.shape[2]), dtype=torch.int32, device=x.device)
    bounds = offsets.tolist()
    for e in range(w.shape[0]):
        lo, hi = bounds[e], bounds[e + 1]
        out[lo:hi] = _bitslice_plain(x[None, lo:hi], w[e:e + 1], 8, ((0, 0),))
    return out


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """``out[r] = x[r] @ w[e]`` for the rows ``offsets[e] <= r <
    offsets[e + 1]`` of group ``e``: int8 ``x (R, K)`` sorted by group ×
    int8 ``w (E, K, N)`` → int32 ``(R, N)``, with ``offsets (E + 1,)`` int32
    on ``x``'s device (0 first, nondecreasing, R last).  On the card one
    launch of ``csrc/bitslice_gemm.cu``'s grouped tensor-core path, which
    never reads the offsets on the host; on the CPU the plain version; on
    ``meta`` the card's checks, then a ``meta`` output.  Every device refuses
    what the card refuses: K % 16 != 0, N % 4 != 0.  Not a registry kernel:
    the JAX package multiplies experts with ``jnp.einsum``, outside Pallas."""
    meta = meta_operands(x, w, offsets)
    dev = x.device if meta else kernel_device(x, w, offsets)
    (r, k), (e, k2, n) = x.shape, w.shape
    if x.dtype != torch.int8 or w.dtype != torch.int8 or offsets.dtype != torch.int32:
        raise TypeError(f"the grouped product takes int8 rows and weights and int32 offsets, got {x.dtype}, "
                        f"{w.dtype} and {offsets.dtype}")
    if k != k2 or tuple(offsets.shape) != (e + 1,):
        raise ValueError(f"shapes {tuple(x.shape)} @ {tuple(w.shape)} with offsets {tuple(offsets.shape)}")
    if k % 16 or n % 4 or max(r * k, r * n, e * k * n) >= 2**31:
        raise ValueError(f"the grouped product takes K % 16 == 0, N % 4 == 0 and operands under 2**31 "
                         f"elements, got R={r}, K={k}, N={n}, E={e}")
    if r and noting_work():
        note_kernel_work("grouped_matmul", *grouped_work(r, k, n, e))
    if dev.type == "cpu":
        with plain_scope():
            return _grouped_plain(x, w, offsets)
    x, w, offsets = x.contiguous(), w.contiguous(), offsets.contiguous()
    out = torch.empty((r, n), dtype=torch.int32, device=dev)
    if out.numel() == 0 or meta:
        return out
    w_vec, fold_tiles = grouped_plan(k, n, w.data_ptr())
    _build.launch("bitslice_gemm_grouped", dev, x.data_ptr(), w.data_ptr(), offsets.data_ptr(), out.data_ptr(),
                  r, n, k, e, w_vec, fold_tiles)
    count_launch("grouped_matmul")
    return out


def dequant_work(rows: int, k: int, n: int, groups: int, out_itemsize: int, bias_itemsize: int) -> Tuple[int, int]:
    """(operations, bytes) of one call with the dequantizing epilogue (one
    pair; ``groups`` weights, 1 for K4): two operations a product (the
    epilogue's few a output not counted); the rows, the weights, the scales
    and the bias read once, the output written once at its dtype."""
    nbytes = rows * k + groups * k * n + 4 * rows + groups * n * (4 + bias_itemsize) + rows * n * out_itemsize
    return 2 * rows * k * n, nbytes


def _dequant_checks(x: torch.Tensor, w: torch.Tensor, x_scale: torch.Tensor, w_scale: torch.Tensor,
                    bias: Optional[torch.Tensor], out_dtype: torch.dtype, groups: int) -> None:
    """What the epilogue refuses, on every device: operand dtypes; scales
    and a bias of other sizes than the rows and ``groups`` × N; K % 16, N %
    4, K past one fold (``fold_k`` of one pair), a dimension past 2**31."""
    if x.dtype != torch.int8 or w.dtype != torch.int8 or x_scale.dtype != torch.float32 or \
            w_scale.dtype != torch.float32:
        raise TypeError(f"the dequantizing GEMM takes int8 operands and float32 scales, got {x.dtype}, {w.dtype}, "
                        f"{x_scale.dtype} and {w_scale.dtype}")
    if out_dtype not in DTYPE_CODES or (bias is not None and bias.dtype not in DTYPE_CODES):
        raise TypeError(f"the dequantizing GEMM writes and adds float32, bfloat16 or float16, got {out_dtype} and "
                        f"{None if bias is None else bias.dtype}")
    (r, k), n = x.shape, w.shape[-1]
    if x_scale.numel() != r or w_scale.numel() != groups * n or (bias is not None and bias.numel() != groups * n):
        raise ValueError(f"scales of {x_scale.numel()} and {w_scale.numel()} and a bias of "
                         f"{None if bias is None else bias.numel()} elements for {r} rows and {groups} x {n} columns")
    if k % 16 or n % 4 or k > ONE_PAIR_FOLD_K or max(r, k, n) >= 2**31:
        raise ValueError(f"the dequantizing GEMM takes K % 16 == 0, N % 4 == 0, K <= {ONE_PAIR_FOLD_K} (one "
                         f"fold) and dimensions under 2**31, got M={r}, K={k}, N={n}")


def dequant_matmul_takes(x_q: torch.Tensor, w_q: torch.Tensor) -> bool:
    """Whether :func:`dequant_matmul` takes ``x_q (..., K) @ w_q (K, N)``
    where they lie: int8 operands that :func:`bitslice_plan` sends to the
    tensor cores as one pair (K % 16, N % 4, x 16-byte and w 4-byte
    aligned), K within one fold."""
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8 or w_q.dim() != 2 or x_q.shape[-1] != w_q.shape[0]:
        return False
    k, n = w_q.shape
    plan = bitslice_plan(1, 1, x_q.numel() // max(k, 1), n, k, 8, ONE_PAIR, (x_q.data_ptr(), w_q.data_ptr()))
    return plan.path == "mma" and k <= plan.fold_k


def dequant_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor, w_scale: torch.Tensor,
                   bias: Optional[torch.Tensor] = None, out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """int8 ``x_q (M, K)`` × int8 ``w_q (K, N)`` → ``(M, N)`` of
    ``out_dtype`` (float32, bfloat16 or float16), dequantized by each row's
    scale (``x_scale``, M float32), each column's (``w_scale``, N float32)
    and ``bias`` (N, float32, bfloat16 or float16) where given: the chain
    ``api.dequant_plain`` on K4's int32 sums, bit for bit.  On the card one
    launch of the tensor-core path with its dequantizing epilogue; on the
    CPU the plain product and the chain; on ``meta`` the card's checks, then
    a ``meta`` output.  Every device refuses what the card refuses
    (:func:`_dequant_checks`); the card also operands off the path's
    alignment."""
    operands = (x_q, w_q, x_scale, w_scale) + (() if bias is None else (bias,))
    meta = meta_operands(*operands)
    dev = x_q.device if meta else kernel_device(*operands)
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"shapes {tuple(x_q.shape)} @ {tuple(w_q.shape)}")
    _dequant_checks(x_q, w_q, x_scale, w_scale, bias, out_dtype, 1)
    (m, k), n = x_q.shape, w_q.shape[1]
    if m * n and noting_work():
        note_kernel_work("bitslice_matmul", *dequant_work(
            m, k, n, 1, out_dtype.itemsize, 0 if bias is None else bias.element_size()))
    if dev.type == "cpu":
        with plain_scope():
            acc = _bitslice_plain(x_q[None], w_q[None], 8, ONE_PAIR)
            return dequant_plain(acc, x_scale.reshape(m, 1), w_scale.reshape(1, n), bias, out_dtype)
    x, w = x_q.contiguous(), w_q.contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if out.numel() == 0 or meta:
        return out
    plan = bitslice_plan(1, 1, m, n, k, 8, ONE_PAIR, (x.data_ptr(), w.data_ptr()))
    if plan.path != "mma":
        raise ValueError("the dequantizing GEMM takes x 16-byte and w 4-byte aligned")
    xs, ws, b = x_scale.contiguous(), w_scale.contiguous(), None if bias is None else bias.contiguous()
    _build.launch("bitslice_gemm_mma_dequant", dev, x.data_ptr(), w.data_ptr(), out.data_ptr(), xs.data_ptr(),
                  ws.data_ptr(), None if b is None else b.data_ptr(), DTYPE_CODES[out_dtype],
                  0 if b is None else DTYPE_CODES[b.dtype], m, n, k, int(plan.tile == "narrow"), int(plan.w_vec),
                  plan.fold_k // BITSLICE_MMA_BK)
    count_launch("bitslice_matmul")
    _launched.pairs, _launched.path = ONE_PAIR, plan.path
    return out


def _grouped_dequant_plain(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor, x_scale: torch.Tensor,
                           w_scale: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """The grouped product's plain version, then the chain with each row's
    group's column scales."""
    e, n = w.shape[0], w.shape[2]
    rows_scale = torch.repeat_interleave(w_scale.reshape(e, n), offsets[1:] - offsets[:-1], dim=0)
    return dequant_plain(_grouped_plain(x, w, offsets), x_scale.reshape(-1, 1), rows_scale, None, out_dtype)


def grouped_dequant_matmul(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor, x_scale: torch.Tensor,
                           w_scale: torch.Tensor, out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """:func:`grouped_matmul` with the dequantizing epilogue: each row of
    group ``e`` times ``w[e]``, dequantized by the row's scale (``x_scale``,
    R float32) and group ``e``'s column scales (``w_scale``, E × N float32),
    written as ``out_dtype``: the chain ``api.dequant_plain`` on the grouped
    int32 sums with each row's group's scales, bit for bit.  No bias: no
    expert linear has one.  Devices and refusals as :func:`grouped_matmul`'s
    and :func:`dequant_matmul`'s."""
    operands = (x, w, offsets, x_scale, w_scale)
    meta = meta_operands(*operands)
    dev = x.device if meta else kernel_device(*operands)
    if offsets.dtype != torch.int32:
        raise TypeError(f"the grouped product takes int32 offsets, got {offsets.dtype}")
    if w.dim() != 3 or x.shape[-1] != w.shape[1] or tuple(offsets.shape) != (w.shape[0] + 1,):
        raise ValueError(f"shapes {tuple(x.shape)} @ {tuple(w.shape)} with offsets {tuple(offsets.shape)}")
    _dequant_checks(x, w, x_scale, w_scale, None, out_dtype, w.shape[0])
    (r, k), (e, _, n) = x.shape, w.shape
    if r and noting_work():
        note_kernel_work("grouped_matmul", *dequant_work(r, k, n, e, out_dtype.itemsize, 0))
    if dev.type == "cpu":
        with plain_scope():
            return _grouped_dequant_plain(x, w, offsets, x_scale, w_scale, out_dtype)
    x, w, offsets = x.contiguous(), w.contiguous(), offsets.contiguous()
    out = torch.empty((r, n), dtype=out_dtype, device=dev)
    if out.numel() == 0 or meta:
        return out
    w_vec, fold_tiles = grouped_plan(k, n, w.data_ptr())
    xs, ws = x_scale.contiguous(), w_scale.contiguous()
    _build.launch("bitslice_gemm_grouped_dequant", dev, x.data_ptr(), w.data_ptr(), offsets.data_ptr(),
                  out.data_ptr(), xs.data_ptr(), ws.data_ptr(), DTYPE_CODES[out_dtype], r, n, k, e, w_vec,
                  fold_tiles)
    count_launch("grouped_matmul")
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
    pairs = active_pairs(sx, sw, skip)
    note_executed_pairs(pairs)
    return _bitslice_gemm(x_slices, w_slices, slice_bits, pairs)
