"""RG-LRU linear recurrence kernel of the PyTorch port:
``h_t = a_t · h_{t-1} + b_t`` over T, from ``h0``.

Mirrors the JAX package's ``kernels/rglru_scan.py``.  One wrapper,
:func:`_scan`, launches ``csrc/rglru_scan.cu`` (replacing the Pallas
``_kernel``) for CUDA tensors and runs the plain version for CPU tensors.

The Pallas body computes ``a·h + b`` as one fused multiply-add, rounded
once; a multiply then an add differs by up to 1 ulp a step, and the chain
carries it on.  So the kernel calls ``__fmaf_rn`` and the plain version
computes an exact fma on the CPU (:func:`fma_f32`): the card, the CPU and
the JAX package's body agree bit for bit.  Subnormals are kept on the card
(no flush to zero) and by the plain version; XLA on the CPU flushes them,
so there the JAX body differs once a chain reaches one.  The registry's
oracle is the JAX package's associative scan (``ref.rglru_scan_ref``),
which sums in another order.  float32 only, on either device.  The kernel
takes a launch plan computed here (:func:`rglru_plan`).

The scan is differentiable (:class:`_RGLRUScan`, used by the registered
wrapper whenever an operand needs a gradient).  The JAX package has no
backward kernel: it differentiates its associative scan.  Here the backward
is the reverse recurrence, a second hand-written kernel of the same source
(``rglru_scan_bwd_f32``, launched by :func:`_scan_bwd`) with its plain
version (:func:`_scan_bwd_plain`): given ``g_t = ∂L/∂h_t``, the carried
gradient is ``d_{T-1} = g_{T-1}``, ``d_t = fma(a_{t+1}, d_{t+1}, g_t)``;
then ``∂b_t = d_t``, ``∂a_t = d_t · h_{t-1}`` (``h_{-1} = h0``) and
``∂h0 = a_0 · d_0``, each product rounded once, so the card and the CPU
agree bit for bit here too.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.api import count_launch, kernel_device, register_kernel


# csrc/rglru_scan.cu's constants
SCAN_THREADS = 32  # SCAN_THREADS: one warp a channel group
SCAN_GROUP = 32    # SCAN_GROUP: channels a group
SCAN_STEPS = 32    # SCAN_STEPS: steps of T a stage
SCAN_STAGES = 4    # SCAN_STAGES: stages of the shared-memory ring


class ScanPlan(NamedTuple):
    """Launch plan of the RG-LRU scan of ``csrc/rglru_scan.cu``."""

    group: int   # channels a group: one warp, one b, contiguous w
    steps: int   # steps of T a stage
    stages: int  # stages of the ring, all but one in flight
    vec: bool    # 16-byte copies (else 4-byte ones)
    blocks: int  # one a group: B · ceil(W / group)


def rglru_plan(bsz: int, t: int, w: int, ptrs: Tuple[int, int]) -> ScanPlan:
    """Launch plan of the scan of contiguous ``(bsz, t, w)`` float32 ``a``
    and ``b`` at addresses ``ptrs = (a, b)``.

    A group is SCAN_GROUP channels of one row of B (fewer when W is
    narrower), so a group never spans two rows; the last group of a row may
    be ragged.  16-byte copies need every group to start on a 4-channel
    boundary and a, b 16-byte aligned: W and the group multiples of 4."""
    del t  # every group walks all of T
    group = max(1, min(SCAN_GROUP, w))
    vec = w % 4 == 0 and group % 4 == 0 and all(p % 16 == 0 for p in ptrs)
    return ScanPlan(group, SCAN_STEPS, SCAN_STAGES, vec, bsz * -(-w // group))


def fma_f32(a: torch.Tensor, h: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a·h + b`` of float32 tensors rounded once to float32.

    The product is exact in float64 (24 + 24 bits); the sum is rounded to
    odd in float64 (its TwoSum error ``e`` moves an even result one ulp
    towards the exact sum), and a float64 rounded to odd rounds to float32
    as the exact sum would, since 53 ≥ 24 + 2."""
    p = a.double() * h.double()
    bd = b.double()
    s = p + bd
    bv = s - p
    e = (p - (s - bv)) + (bd - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, float("inf"), float("-inf")).to(s.dtype)
    s = torch.where((e != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _scan_plain(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: the recurrence step by step, each step one
    exact fma."""
    out = torch.empty_like(a)
    h = h0
    for t in range(a.shape[1]):
        h = fma_f32(a[:, t], h, b[:, t])
        out[:, t] = h
    return out


def _scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t·h_{t-1} + b_t`` over axis 1 of ``a, b (B, T, W)`` from
    ``h0 (B, W)``; the CUDA kernel for CUDA tensors."""
    dev = kernel_device(a, b, h0)
    if any(t.dtype != torch.float32 for t in (a, b, h0)):
        raise TypeError(f"rglru_scan takes float32 operands, got {a.dtype}, {b.dtype}, {h0.dtype}")
    if dev.type == "cpu":
        return _scan_plain(a, b, h0)
    bsz, t, w = a.shape
    if a.numel() >= 2**31:
        raise ValueError(f"extent {a.numel()} exceeds the kernels' 32-bit index range")
    a, b, h0 = a.contiguous(), b.contiguous(), h0.contiguous()
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    plan = rglru_plan(bsz, t, w, (a.data_ptr(), b.data_ptr()))
    _build.launch("rglru_scan_f32", dev, a.data_ptr(), b.data_ptr(), h0.data_ptr(), out.data_ptr(),
                  bsz, t, w, plan.group, int(plan.vec), plan.blocks)
    count_launch("rglru_scan")
    return out


def _scan_bwd_plain(a: torch.Tensor, h0: torch.Tensor, hs: torch.Tensor, g: torch.Tensor,
                    need_h0: bool) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The backward kernel's plain version: the reverse recurrence step by
    step, each carried step one exact fma, each product rounded once.
    Returns ``(∂a, ∂b, ∂h0 or None)``."""
    da, db = torch.empty_like(a), torch.empty_like(a)
    t_len = a.shape[1]
    if t_len == 0:
        return da, db, torch.zeros_like(h0) if need_h0 else None
    d = g[:, t_len - 1].clone()
    for t in range(t_len - 1, -1, -1):
        if t < t_len - 1:
            d = fma_f32(a[:, t + 1], d, g[:, t])
        db[:, t] = d
        da[:, t] = d * (hs[:, t - 1] if t > 0 else h0)
    return da, db, a[:, 0] * d if need_h0 else None


def _scan_bwd(a: torch.Tensor, h0: torch.Tensor, hs: torch.Tensor, g: torch.Tensor,
              need_h0: bool) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The gradients of :func:`_scan` given ``g = ∂L/∂hs``: ``(∂a, ∂b, ∂h0
    or None)`` from ``a``, ``h0`` and the forward's ``hs``; the CUDA kernel
    for CUDA tensors, in one launch."""
    dev = kernel_device(a, h0, hs, g)
    if any(t.dtype != torch.float32 for t in (a, h0, hs, g)):
        raise TypeError(f"rglru_scan's backward takes float32 operands, got {a.dtype}, {h0.dtype}, "
                        f"{hs.dtype}, {g.dtype}")
    if dev.type == "cpu":
        return _scan_bwd_plain(a, h0, hs, g, need_h0)
    bsz, t, w = a.shape
    if a.numel() >= 2**31:
        raise ValueError(f"extent {a.numel()} exceeds the kernels' 32-bit index range")
    a, h0, hs, g = a.contiguous(), h0.contiguous(), hs.contiguous(), g.contiguous()
    da, db = torch.empty_like(a), torch.empty_like(a)
    if a.numel() == 0:
        return da, db, torch.zeros_like(h0) if need_h0 else None
    dh0 = torch.empty_like(h0) if need_h0 else None
    plan = rglru_plan(bsz, t, w, (a.data_ptr(), hs.data_ptr(), h0.data_ptr(), g.data_ptr()))
    _build.launch("rglru_scan_bwd_f32", dev, a.data_ptr(), hs.data_ptr(), h0.data_ptr(), g.data_ptr(),
                  da.data_ptr(), db.data_ptr(), None if dh0 is None else dh0.data_ptr(),
                  bsz, t, w, plan.group, int(plan.vec), plan.blocks)
    count_launch("rglru_scan_bwd")
    return da, db, dh0


class _RGLRUScan(torch.autograd.Function):
    """:func:`_scan` with its gradient (:func:`_scan_bwd`).  The forward
    saves ``a``, ``h0`` and ``hs``; ``b`` is not needed."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
        hs = _scan(a, b, h0)
        ctx.save_for_backward(a, h0, hs)
        return hs

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a, h0, hs = ctx.saved_tensors
        need_a, need_b, need_h0 = ctx.needs_input_grad
        da, db, dh0 = _scan_bwd(a, h0, hs, g, need_h0)
        return da if need_a else None, db if need_b else None, dh0


@register_kernel("rglru_scan", oracle=ref.rglru_scan_ref)
def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """a, b: (B, T, W) fp32; h0: (B, W).  Returns hs: (B, T, W),
    differentiable in all three."""
    if a.dim() != 3 or b.shape != a.shape or tuple(h0.shape) != (a.shape[0], a.shape[2]):
        raise ValueError(f"rglru_scan takes a, b (B, T, W) and h0 (B, W), got {tuple(a.shape)}, "
                         f"{tuple(b.shape)} and {tuple(h0.shape)}")
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad or h0.requires_grad):
        return _RGLRUScan.apply(a, b, h0)
    return _scan(a, b, h0)
