"""Integer attention decode kernels of the PyTorch port: q·Kᵀ scores, the
fixed-point row softmax, p·V, the single-token decode projection and the
KV-cache append.

Mirrors the JAX package's ``kernels/attention.py``.  Five wrappers, each
launching its kernel of ``csrc/attention.cu`` for CUDA tensors and running
its plain version for CPU tensors:

* :func:`_qk` — ``(M, D) × (T, D)ᵀ → (M, T)`` int32 (replaces ``_qk_kernel``);
* :func:`_softmax` — the bit-exact fixed-point row softmax (replaces
  ``_softmax_kernel``), held to the oracle's exact floor division;
* :func:`_pv` — ``((M, T) · (T, Dv)) >> shift`` (replaces ``_pv_kernel``);
* :func:`_gemv` — ``(M, K) · (K,) → (M,)`` int32 (replaces ``_gemv_kernel``);
* :func:`_kv_append` — the cache with its selected rows replaced, a new
  tensor in the cache's dtype (replaces ``_kv_append_kernel``).

Operands are int8 or int32 (the selector also bool); int8 operands reach
the kernels as int8 and are widened in registers.  Everything is integer:
int32 arithmetic wraps, every ``>>`` is arithmetic.  Every kernel takes a
launch plan computed here: q·Kᵀ and the decode GEMV share one row-dot
kernel (:func:`rowdot_plan`); the softmax, p·V and KV append have
:func:`softmax_plan`, :func:`pv_plan` and :func:`kv_plan`.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.api import count_launch, kernel_device, register_kernel

# the card's element types: int8 (and bool, for the selector) as 1 byte, int32 as 4
_BYTES = {torch.int8: 1, torch.int32: 4}
_SEL_BYTES = {**_BYTES, torch.bool: 1}
# a row sum of exponentials (each at most 2^F) fits int32 below this many columns
SOFTMAX_MAX_COLS = 1 << (31 - ref.SOFTMAX_F)

# csrc/attention.cu's row-dot constants (q·Kᵀ and the decode GEMV)
ROWDOT_MAX_WARPS = 8      # RD_MAX_WARPS: warps of a block, at most
ROWDOT_UNROLL = 8         # RD_UNROLL: 16-byte weight loads a lane has in flight, at most
ROWDOT_GROUP = 8          # RD_GROUP: queries a block accumulates (grid y takes the groups)
ROWDOT_XREG_CHUNKS = 16   # RD_XREG_CHUNKS: activation chunks a lane keeps in registers
# chunks a lane aims at (scripts/torch_rowdot_variants.py: on the card 2–4
# beat 1 and 5–19), the blocks a grid aims at (one per SM of an H100), and
# the grid's cap, above which each block walks an equal number of steps
ROWDOT_TARGET_ITERS = 4
ROWDOT_TARGET_BLOCKS = 132
ROWDOT_MAX_BLOCKS = 132 * 32

# csrc/attention.cu's softmax constants
SOFTMAX_ROW_WARPS = 8         # SM_ROW_WARPS: rows path, a warp a row
SOFTMAX_CLUSTER_THREADS = 256  # SMC_THREADS: threads of a cluster-path block
SOFTMAX_CLUSTER_ELEMS = 16    # SMC_ELEMS: scores a thread keeps in registers
SOFTMAX_MAX_CLUSTER = 16      # SMC_MAX_CLUSTER: blocks of a row's cluster
# rows up to this many columns take the rows kernel (a warp a row)
SOFTMAX_ROW_MAX_COLS = 512
# scores a cluster-path thread aims at: T = 32768 spreads over 16 blocks
SOFTMAX_TARGET_ELEMS = 8
SOFTMAX_MAX_GRID_Y = 65535    # rows of clusters in flight (grid y)

# csrc/attention.cu's p·V constants
PV_THREADS = 256        # PV_THREADS
PV_UNROLL = 4           # PV_UNROLL: value rows a packed-path thread has in flight
PV_MAX_GROUP = 4        # PV_MAX_GROUP: queries a block accumulates
PV_PACKED_MAX_DV = 256  # PV_PACKED_MAX_DV
# blocks along T the plan aims at: one per SM of an H100
PV_TARGET_BLOCKS = 132

# csrc/attention.cu's kv_append constants
KV_THREADS = 256        # KV_THREADS
KV_MAX_GRID = 132 * 32  # the generic kernel's grid-stride cap (repro_grid)


class RowdotPlan(NamedTuple):
    """Launch plan of the row dot ``out[i][r] = Σ_j a[i][j]·w[r][j]`` of
    ``csrc/attention.cu`` (q·Kᵀ and the decode GEMV)."""

    vec: bool    # the row-dot kernel (16-byte chunks); else the generic kernel
    lanes: int   # lanes of a warp on one row (1 to 32, a power of two)
    split: int   # warps on one row (a power of two; lanes is 32 when above 1)
    warps: int   # warps of a block
    unroll: int  # 16-byte weight loads a lane issues before its first multiply (1, 2, 4, 8)
    group: int   # queries a block accumulates: 1, or ROWDOT_GROUP with grid y over the groups
    blocks: int  # grid x; above the rows' steps, a grid-stride loop

    @property
    def span(self) -> int:
        """Threads on one row."""
        return self.lanes * self.split

    @property
    def rows_per_step(self) -> int:
        """Rows a block takes at a step of its grid-stride loop."""
        return 32 * self.warps // self.span


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def rowdot_plan(rows: int, k: int, nq: int, w_bytes: int, a_bytes: int, ptrs: Tuple[int, int]) -> RowdotPlan:
    """Launch plan of ``a (nq, k) · w (rows, k)ᵀ`` for contiguous operands of
    ``a_bytes`` and ``w_bytes`` bytes an element (1 or 4) at ``ptrs = (w,
    a)``: q·Kᵀ with w the (T, D) cache and a the (M, D) queries, the decode
    GEMV with w the (M, K) weight and a its one (K,) activation (nq = 1).

    The row-dot kernel (``vec``) takes both operands int8 or both int32,
    16-byte rows (k · bytes % 16 == 0, k > 0) and both bases 16-byte
    aligned; everything else the generic kernels (qk_generic a thread a row,
    gemv_generic a warp a row), whose grids the C entries size as before, so
    their plan holds only ``vec`` and ``group``.  On the row-dot kernel, a
    row of C 16-byte chunks gets ``span = lanes · split`` threads, each on
    the chunks ``slot + i · span``:

    * a row of at most 32 chunks gets a lane a chunk (D = 64: 4 lanes, 8
      rows a warp), so that a warp load reads whole rows, one contiguous run
      (on the card 1 or 2 lanes a row were faster warm by ~0.06 µs and slower
      cold by 0.10–0.16); a longer row starts at the least power of two that
      leaves a lane at most ROWDOT_TARGET_ITERS chunks (K = 896: 16 lanes, 4
      chunks; K = 4864: 128 threads, 4 warps, 3 chunks), or 2 with a group
      of queries, so their chunks fit ROWDOT_XREG_CHUNKS registers; at most
      a block;
    * it doubles, up to C's power of two and a block, while the grid would
      hold fewer than ROWDOT_TARGET_BLOCKS blocks of ROWDOT_MAX_WARPS warps;
      then the block's warps halve, down to one row a block, until it does
      (on the card fewer blocks were at times faster warm, by at most
      0.15 µs, and slower cold, by up to 0.7 µs);
    * a lane issues all its loads at once (``unroll`` ≥ its chunks) up to
      ROWDOT_UNROLL, and keeps its activation chunks (of each of ``group``
      queries) in registers while ``group · unroll`` ≤ ROWDOT_XREG_CHUNKS;
      past that it streams them beside the weights with ``unroll`` at
      ROWDOT_UNROLL;
    * the grid gives each block one step of rows, up to ROWDOT_MAX_BLOCKS;
      past that each block walks an equal number of steps (a grid-stride
      loop).

    Plans are cached on their inputs (the bases only by their alignment):
    a decode step is host-bound, and computing one costs microseconds."""
    w_ptr, a_ptr = ptrs
    return _rowdot_plan(rows, k, nq, w_bytes, a_bytes, (w_ptr | a_ptr) % 16 == 0)


@functools.lru_cache(maxsize=4096)
def _rowdot_plan(rows: int, k: int, nq: int, w_bytes: int, a_bytes: int, aligned: bool) -> RowdotPlan:
    group = 1 if nq <= 1 else ROWDOT_GROUP
    row_bytes = k * w_bytes
    if not (w_bytes == a_bytes and k > 0 and row_bytes % 16 == 0 and aligned):
        return RowdotPlan(False, 0, 0, 0, 0, group, 0)
    chunks = row_bytes // 16
    top = 32 * ROWDOT_MAX_WARPS
    target = min(ROWDOT_TARGET_ITERS, ROWDOT_XREG_CHUNKS // group)
    span = _pow2_ceil(chunks) if chunks <= 32 else min(top, _pow2_ceil(-(-chunks // target)))
    while span < min(top, _pow2_ceil(chunks)) and -(-rows // (top // span)) < ROWDOT_TARGET_BLOCKS:
        span *= 2
    warps = ROWDOT_MAX_WARPS
    split = max(1, span // 32)
    while warps > split and -(-rows // (32 * warps // span)) < ROWDOT_TARGET_BLOCKS:
        warps //= 2
    iters = -(-chunks // span)
    unroll = min(ROWDOT_UNROLL, _pow2_ceil(iters))
    if group * unroll > ROWDOT_XREG_CHUNKS:
        unroll = ROWDOT_UNROLL
    steps = -(-rows // (32 * warps // span))
    blocks = -(-steps // -(-steps // ROWDOT_MAX_BLOCKS))
    return RowdotPlan(True, min(span, 32), split, warps, unroll, group, blocks)


class SoftmaxPlan(NamedTuple):
    """Launch plan of the fixed-point softmax of ``csrc/attention.cu``."""

    cluster: int           # blocks of a row's cluster; 0: the rows kernel, a warp a row
    chunks_per_block: int  # 16-byte chunks of the row a cluster block takes
    regs: bool             # the chunks stay in registers (else re-read from L2)
    vec: bool              # 16-byte loads and stores
    blocks: int            # rows path: blocks; cluster path: rows in flight (grid y)


def softmax_plan(r: int, t: int, x_bytes: int, ptr: int) -> SoftmaxPlan:
    """Launch plan of the softmax of a contiguous ``(r, t)`` matrix of
    ``x_bytes``-byte scores (1 or 4) at address ``ptr``.

    Rows of at most SOFTMAX_ROW_MAX_COLS columns take a warp each,
    SOFTMAX_ROW_WARPS rows a block.  A longer row takes a thread-block
    cluster: its 16-byte chunks (4 int32 or 16 int8 scores) split over
    ``cluster`` blocks, as many as give a thread about SOFTMAX_TARGET_ELEMS
    scores and at most SOFTMAX_MAX_CLUSTER; ``regs`` when a block's chunks
    fit its threads' registers (SOFTMAX_CLUSTER_ELEMS scores a thread), else
    each pass loops over them.  ``vec`` (16-byte loads and stores) needs a
    16-byte aligned base and ``t`` a multiple of a chunk.  Cached, as
    :func:`rowdot_plan` is, on the base's alignment only."""
    return _softmax_plan(r, t, x_bytes, ptr % 16 == 0)


@functools.lru_cache(maxsize=4096)
def _softmax_plan(r: int, t: int, x_bytes: int, aligned: bool) -> SoftmaxPlan:
    if t <= SOFTMAX_ROW_MAX_COLS:
        return SoftmaxPlan(0, 0, False, False, max(1, -(-r // SOFTMAX_ROW_WARPS)))
    per_chunk = 16 // x_bytes
    chunks = -(-t // per_chunk)
    cluster = min(SOFTMAX_MAX_CLUSTER, max(1, -(-t // (SOFTMAX_CLUSTER_THREADS * SOFTMAX_TARGET_ELEMS))))
    per_block = -(-chunks // cluster)
    cluster = -(-chunks // per_block)
    regs = per_block <= SOFTMAX_CLUSTER_THREADS * (SOFTMAX_CLUSTER_ELEMS // per_chunk)
    vec = aligned and t % per_chunk == 0
    return SoftmaxPlan(cluster, per_block, regs, vec, min(r, SOFTMAX_MAX_GRID_Y))


class PvPlan(NamedTuple):
    """Launch plan of the p·V kernel of ``csrc/attention.cu``."""

    packed: bool         # the packed kernel (16-byte value loads, every thread on a row)
    group: int           # queries a block accumulates (1, 2 or 4); grid y takes the groups
    rows_per_step: int   # rows of T a block's threads cover at once
    rows_per_block: int  # rows of T a block takes, a multiple of rows_per_step
    blocks: int          # grid x: blocks along T, each writing one row of partial sums
    npad: int            # words of a block's partial sums: m·dv rounded up to 4


def pv_plan(m: int, t: int, dv: int, p_bytes: int, v_bytes: int, ptrs: Tuple[int, int]) -> PvPlan:
    """Launch plan of ``(m, t) · (t, dv)`` for contiguous ``p_bytes``- and
    ``v_bytes``-byte operands (1 or 4) at addresses ``ptrs = (p, v)``.

    The packed kernel takes int32 p and int8 v whose rows split into 16-byte
    pieces, ``dv // 16`` of them dividing a warp's 32 lanes (dv 16 to
    PV_PACKED_MAX_DV), v 16-byte aligned: a block then covers PV_THREADS //
    (dv // 16) rows at a step, every thread on one.  The generic kernel
    takes the rest: PV_THREADS // min(dv, PV_THREADS) rows at a step, a
    thread a column.  A block accumulates ``group`` queries (1, 2, else
    PV_MAX_GROUP); T is split into as many steps a block as leave about
    PV_TARGET_BLOCKS blocks.  Cached on v's alignment, not its address."""
    _, v_ptr = ptrs
    return _pv_plan(m, t, dv, p_bytes, v_bytes, v_ptr % 16 == 0)


@functools.lru_cache(maxsize=4096)
def _pv_plan(m: int, t: int, dv: int, p_bytes: int, v_bytes: int, v_aligned: bool) -> PvPlan:
    lanes = dv // 16
    packed = (p_bytes == 4 and v_bytes == 1 and dv % 16 == 0 and 0 < dv <= PV_PACKED_MAX_DV
              and 32 % lanes == 0 and v_aligned)
    group = m if m <= 2 else PV_MAX_GROUP
    rows_per_step = PV_THREADS // lanes if packed else PV_THREADS // min(dv, PV_THREADS)
    steps = -(-t // rows_per_step)
    per_block = max(1, -(-steps // PV_TARGET_BLOCKS))
    blocks = max(1, -(-steps // per_block))
    return PvPlan(packed, group, rows_per_step, per_block * rows_per_step, blocks, -(-(m * dv) // 4) * 4)


class KvPlan(NamedTuple):
    """Launch plan of the KV-cache append of ``csrc/attention.cu``."""

    vec: bool    # a 16-byte chunk a thread (int8, D % 16 == 0, aligned); else an element a thread
    blocks: int


def kv_plan(t: int, d: int, cache_bytes: int, new_bytes: int, ptrs: Tuple[int, int, int]) -> KvPlan:
    """Launch plan of appending to a contiguous ``(t, d)`` cache of
    ``cache_bytes``-byte elements a ``new_bytes``-byte row, with ``ptrs =
    (cache, new, out)``.

    An int8 cache and row with 16-byte rows (D % 16 == 0) and every base
    16-byte aligned take the vector kernel, one chunk (its selector byte
    beside it) a thread, KV_THREADS a block; the rest the generic kernel,
    an element a thread, grid-stride over at most KV_MAX_GRID blocks.
    Cached on the bases' alignment, not their addresses."""
    cache_ptr, new_ptr, out_ptr = ptrs
    return _kv_plan(t, d, cache_bytes, new_bytes, (cache_ptr | new_ptr | out_ptr) % 16 == 0)


@functools.lru_cache(maxsize=4096)
def _kv_plan(t: int, d: int, cache_bytes: int, new_bytes: int, aligned: bool) -> KvPlan:
    n = t * d
    if cache_bytes == 1 and new_bytes == 1 and d % 16 == 0 and aligned:
        return KvPlan(True, max(1, -(-(n // 16) // KV_THREADS)))
    return KvPlan(False, max(1, min(-(-n // KV_THREADS), KV_MAX_GRID)))


# the p·V kernel's ticket, one per device: a zeroed int32 that every launch
# leaves at zero.  Allocated at the device's first eager call, before any
# graph capture; serves one stream at a time.
_pv_tickets: Dict[int, torch.Tensor] = {}


def _pv_ticket(dev: torch.device) -> torch.Tensor:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    ticket = _pv_tickets.get(index)
    if ticket is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("attention_pv allocates its ticket at its first eager call on a device: "
                               "call it once before capturing a CUDA graph")
        ticket = torch.zeros(1, dtype=torch.int32, device=torch.device("cuda", index))
        _pv_tickets[index] = ticket
    return ticket


def _elem_bytes(t: torch.Tensor, table=_BYTES) -> int:
    if t.dtype not in table:
        raise TypeError(f"the attention kernels take {sorted(map(str, table))} operands, got {t.dtype}")
    return table[t.dtype]


def _index_range(*extents: int) -> None:
    for n in extents:
        if n >= 2**31:
            raise ValueError(f"extent {n} exceeds the kernels' 32-bit index range")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


_qk_plain = ref.attention_qk_ref
_gemv_plain = ref.decode_gemv_ref
_kv_append_plain = ref.kv_append_ref


def _softmax_plain(x: torch.Tensor, sigma: int) -> torch.Tensor:
    """The softmax kernel's plain version at range-reduction shift ``sigma``."""
    return ref.softmax_fixedpoint_ref(x, in_frac=sigma + ref.SOFTMAX_F - ref.SOFTMAX_K)


def _pv_plain(p: torch.Tensor, v: torch.Tensor, shift: int) -> torch.Tensor:
    return ref.attention_pv_ref(p, v, shift=shift)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _qk(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``q (M, D) · k (T, D)ᵀ → (M, T)`` int32; the CUDA kernel for CUDA
    tensors (the row dot of :func:`rowdot_plan`, or the generic kernel)."""
    dev = kernel_device(q, k)
    if dev.type == "cpu":
        return _qk_plain(q, k)
    qb, kb = _elem_bytes(q), _elem_bytes(k)
    (m, d), (t, _) = q.shape, k.shape
    _index_range(m * t, t * d, m * d)
    q, k = q.contiguous(), k.contiguous()
    out = torch.empty((m, t), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    plan = rowdot_plan(t, d, m, kb, qb, (k.data_ptr(), q.data_ptr()))
    _build.launch("attention_qk", dev, q.data_ptr(), k.data_ptr(), out.data_ptr(), m, t, d, qb, kb, int(plan.vec),
                  plan.lanes, plan.split, plan.warps, plan.unroll, plan.group, plan.blocks)
    count_launch("attention_qk")
    return out


def _softmax(x: torch.Tensor, sigma: int) -> torch.Tensor:
    """Fixed-point softmax of the rows of ``x (R, T)`` at range-reduction
    shift ``sigma`` → int32; the CUDA kernel for CUDA tensors."""
    dev = kernel_device(x)
    if dev.type == "cpu":
        return _softmax_plain(x, sigma)
    xb = _elem_bytes(x)
    r, t = x.shape
    _index_range(r * t)
    x = x.contiguous()
    out = torch.empty((r, t), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    plan = softmax_plan(r, t, xb, x.data_ptr())
    _build.launch("softmax_fixedpoint", dev, x.data_ptr(), out.data_ptr(), r, t, sigma, xb, plan.cluster,
                  plan.chunks_per_block, int(plan.regs), int(plan.vec), plan.blocks)
    count_launch("softmax_fixedpoint")
    return out


def _pv(p: torch.Tensor, v: torch.Tensor, shift: int) -> torch.Tensor:
    """``(p (M, T) · v (T, Dv)) >> shift → (M, Dv)`` int32; the CUDA kernel
    for CUDA tensors, one launch that ends on the device's ticket
    (:func:`_pv_ticket`), so calls on one device go to one stream at a time."""
    dev = kernel_device(p, v)
    if dev.type == "cpu":
        return _pv_plain(p, v, shift)
    pb, vb = _elem_bytes(p), _elem_bytes(v)
    (m, t), (_, dv) = p.shape, v.shape
    _index_range(m * t, t * dv)
    p, v = p.contiguous(), v.contiguous()
    out = torch.empty((m, dv), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    if t == 0:
        return out.zero_()
    plan = pv_plan(m, t, dv, pb, vb, (p.data_ptr(), v.data_ptr()))
    _index_range(plan.blocks * plan.npad)
    partial = torch.empty((plan.blocks, plan.npad), dtype=torch.int32, device=dev)
    ticket = _pv_ticket(dev)
    # a shift outside [0, 31] fills with the sign, as XLA and PyTorch do (C++
    # leaves it undefined): an arithmetic >> 31
    sh = shift if 0 <= shift <= 31 else 31
    _build.launch("attention_pv", dev, p.data_ptr(), v.data_ptr(), partial.data_ptr(), ticket.data_ptr(),
                  out.data_ptr(), m, t, dv, sh, pb, vb, int(plan.packed), plan.group, plan.rows_per_block,
                  plan.blocks, plan.npad)
    count_launch("attention_pv")
    return out


def _gemv(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``w (M, K) · x (K,) → (M,)`` int32; the CUDA kernel for CUDA
    tensors (the row dot of :func:`rowdot_plan`, or the generic kernel)."""
    dev = kernel_device(w, x)
    if dev.type == "cpu":
        return _gemv_plain(w, x)
    wb, xb = _elem_bytes(w), _elem_bytes(x)
    m, k = w.shape
    _index_range(m * k)
    w, x = w.contiguous(), x.contiguous()
    out = torch.empty((m,), dtype=torch.int32, device=dev)
    if m == 0:
        return out
    plan = rowdot_plan(m, k, 1, wb, xb, (w.data_ptr(), x.data_ptr()))
    _build.launch("decode_gemv", dev, w.data_ptr(), x.data_ptr(), out.data_ptr(), m, k, wb, xb, int(plan.vec),
                  plan.lanes, plan.split, plan.warps, plan.unroll, plan.group, plan.blocks)
    count_launch("decode_gemv")
    return out


def _kv_append(cache: torch.Tensor, new: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """A new ``(T, D)`` cache: ``cache`` with the rows where ``onehot`` is
    nonzero set to ``new`` in the cache's dtype; the CUDA kernel for CUDA
    tensors."""
    dev = kernel_device(cache, new, onehot)
    if dev.type == "cpu":
        return _kv_append_plain(cache, new, onehot)
    cb, nb, sb = _elem_bytes(cache), _elem_bytes(new), _elem_bytes(onehot, _SEL_BYTES)
    t, d = cache.shape
    _index_range(t * d)
    cache, new, onehot = cache.contiguous(), new.contiguous(), onehot.contiguous()
    out = torch.empty_like(cache)
    if out.numel() == 0:
        return out
    ptrs = (cache.data_ptr(), new.data_ptr(), out.data_ptr())
    plan = kv_plan(t, d, cb, nb, ptrs)
    _build.launch("kv_append", dev, ptrs[0], ptrs[1], onehot.data_ptr(), ptrs[2], t, d, cb, nb, sb,
                  int(plan.vec), plan.blocks)
    count_launch("kv_append")
    return out


# ---------------------------------------------------------------------------
# registered kernels
# ---------------------------------------------------------------------------


@register_kernel("attention_qk", oracle=ref.attention_qk_ref)
def attention_qk(
    q: torch.Tensor, k: torch.Tensor, *,
    q_bits: Optional[int] = None, k_bits: Optional[int] = None,
    out_bits: Optional[int] = None,
) -> torch.Tensor:
    """(M, D) query block × (T, D) key cache → (M, T) int32 scores q·Kᵀ.
    The bit-width hints are the simulator lowering's and are ignored here."""
    del q_bits, k_bits, out_bits
    d, d2 = q.shape[1], k.shape[1]
    if d != d2:
        raise ValueError(f"query width {d} != key width {d2}")
    return _qk(q, k)


@register_kernel("softmax_fixedpoint", oracle=ref.softmax_fixedpoint_ref)
def softmax_fixedpoint(
    x: torch.Tensor, *, in_frac: int, in_bits: Optional[int] = None,
) -> torch.Tensor:
    """Bit-exact fixed-point row softmax of (R, T) integers with ``in_frac``
    fraction bits → int32 probabilities with ``SOFTMAX_F`` fraction bits,
    the oracle's recipe shift for shift.  Rows longer than
    ``SOFTMAX_MAX_COLS`` (2^25) are refused: their sum of exponentials can
    leave int32."""
    del in_bits
    sigma = ref.softmax_sigma(in_frac)
    if x.dim() != 2:
        raise ValueError(f"softmax_fixedpoint takes (R, T) scores, got shape {tuple(x.shape)}")
    if x.shape[1] >= SOFTMAX_MAX_COLS:
        raise ValueError(f"softmax_fixedpoint rows are limited to {SOFTMAX_MAX_COLS - 1} columns, "
                         f"got {x.shape[1]}")
    return _softmax(x, sigma)


@register_kernel("attention_pv", oracle=ref.attention_pv_ref)
def attention_pv(
    p: torch.Tensor, v: torch.Tensor, *, shift: int = ref.SOFTMAX_F,
    p_bits: Optional[int] = None, v_bits: Optional[int] = None,
) -> torch.Tensor:
    """(M, T) probabilities × (T, Dv) value cache → (M, Dv) int32, the int32
    accumulator arithmetically shifted right by ``shift`` after the full
    sum."""
    del p_bits, v_bits
    t, t2 = p.shape[1], v.shape[0]
    if t != t2:
        raise ValueError(f"probability length {t} != value rows {t2}")
    return _pv(p, v, int(shift))


@register_kernel("decode_gemv", oracle=ref.decode_gemv_ref)
def decode_gemv(
    w: torch.Tensor, x: torch.Tensor, *,
    w_bits: Optional[int] = None, x_bits: Optional[int] = None,
) -> torch.Tensor:
    """(M, K) weights × (K,) activation → (M,) int32, the single-token
    decode projection (wrapping).  The bit-width hints are the simulator
    lowering's and are ignored here."""
    del w_bits, x_bits
    if w.dim() != 2 or tuple(x.shape) != (w.shape[1],):
        raise ValueError(f"decode_gemv takes (M, K) weights and a (K,) activation, got "
                         f"{tuple(w.shape)} and {tuple(x.shape)}")
    return _gemv(w, x)


@register_kernel("kv_append", oracle=ref.kv_append_ref)
def kv_append(cache: torch.Tensor, new: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """(T, D) cache with the rows selected by the nonzero entries of the
    (T,) ``onehot`` replaced by the (D,) ``new`` row (all-zero selector →
    an unchanged copy).  Returns a new tensor in the cache's dtype."""
    t, d = cache.shape
    if tuple(new.shape) != (d,):
        raise ValueError(f"new row has shape {tuple(new.shape)}, the cache rows ({d},)")
    if tuple(onehot.shape) != (t,):
        raise ValueError(f"selector has shape {tuple(onehot.shape)}, the cache ({t},) rows")
    return _kv_append(cache, new, onehot)
