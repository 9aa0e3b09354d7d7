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
int32 arithmetic wraps, every ``>>`` is arithmetic.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.api import count_launch, kernel_device, register_kernel

# the card's element types: int8 (and bool, for the selector) as 1 byte, int32 as 4
_BYTES = {torch.int8: 1, torch.int32: 4}
_SEL_BYTES = {**_BYTES, torch.bool: 1}
# cache rows per block of the p·V partial pass
PV_CHUNK = 256
# a row sum of exponentials (each at most 2^F) fits int32 below this many columns
SOFTMAX_MAX_COLS = 1 << (31 - ref.SOFTMAX_F)


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
    tensors."""
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
    _build.launch("attention_qk", dev, q.data_ptr(), k.data_ptr(), out.data_ptr(), m, t, d, qb, kb)
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
    _build.launch("softmax_fixedpoint", dev, x.data_ptr(), out.data_ptr(), r, t, sigma, xb)
    count_launch("softmax_fixedpoint")
    return out


def _pv(p: torch.Tensor, v: torch.Tensor, shift: int) -> torch.Tensor:
    """``(p (M, T) · v (T, Dv)) >> shift → (M, Dv)`` int32; the CUDA kernel
    for CUDA tensors."""
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
    chunks = -(-t // PV_CHUNK)
    _index_range(chunks * m * dv)
    partial = torch.empty((chunks, m, dv), dtype=torch.int32, device=dev)
    # a shift outside [0, 31] fills with the sign, as XLA and PyTorch do (C++
    # leaves it undefined): an arithmetic >> 31
    sh = shift if 0 <= shift <= 31 else 31
    _build.launch("attention_pv", dev, p.data_ptr(), v.data_ptr(), partial.data_ptr(),
                  out.data_ptr(), m, t, dv, PV_CHUNK, sh, pb, vb)
    count_launch("attention_pv")
    return out


def _gemv(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``w (M, K) · x (K,) → (M,)`` int32; the CUDA kernel for CUDA
    tensors."""
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
    _build.launch("decode_gemv", dev, w.data_ptr(), x.data_ptr(), out.data_ptr(), m, k, wb, xb)
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
    _build.launch("kv_append", dev, cache.data_ptr(), new.data_ptr(), onehot.data_ptr(),
                  out.data_ptr(), t, d, cb, nb, sb)
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
