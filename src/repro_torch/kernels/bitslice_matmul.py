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
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.api import (
    active_pairs,
    bitslice_matmul_oracle,
    count_launch,
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

Pairs = Tuple[Tuple[int, int], ...]


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
