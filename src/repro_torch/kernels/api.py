"""Kernel registry and public kernel wrappers of the PyTorch port.

The port's counterpart of the registry part of the JAX package's
``kernels/api.py``: each kernel module registers its implementation with
:func:`register_kernel`, paired with its plain oracle from
:mod:`repro_torch.kernels.ref`, and the public wrappers below all go through
:func:`dispatch`.

Dispatch goes by the device of the operands.  On CUDA tensors an
implementation launches its hand-written kernel (``csrc/``) or raises; on CPU
tensors it runs the kernel's plain PyTorch version.  Nothing falls back from
one to the other.  Each kernel launch adds one to a per-kernel counter
(:func:`launch_counts`, :func:`reset_launch_counts`), so a run can show which
kernels it went through.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional

import torch

__all__ = [
    "KernelDef",
    "register_kernel",
    "get_kernel",
    "registered_kernels",
    "dispatch",
    "resolve_device",
    "kernel_device",
    "count_launch",
    "launch_counts",
    "reset_launch_counts",
    "ewise_add",
    "relu",
    "conv2d",
    "maxpool2d",
    "avgpool2d",
    "global_avgpool",
    "int_matmul",
]


@dataclass(frozen=True)
class KernelDef:
    """One registered kernel: its implementation (CUDA kernel on the card,
    plain version on the CPU) and its oracle."""

    name: str
    impl: Callable[..., Any]
    oracle: Callable[..., Any]


_REGISTRY: Dict[str, KernelDef] = {}
_registry_lock = threading.Lock()


def register_kernel(name: str, *, oracle: Callable[..., Any]):
    """Decorator: pair a kernel implementation with its plain oracle.
    Registration is idempotent per name (last wins)."""

    def deco(fn: Callable[..., Any]) -> Callable[..., Any]:
        with _registry_lock:
            _REGISTRY[name] = KernelDef(name=name, impl=fn, oracle=oracle)
        return fn

    return deco


_bootstrapped = False


def _ensure_registered() -> None:
    # Kernel modules self-register on import; importing them lazily avoids an
    # import cycle (they import this module for the decorator).
    global _bootstrapped
    if _bootstrapped:
        return
    import repro_torch.kernels.conv  # noqa: F401
    import repro_torch.kernels.ewise  # noqa: F401

    _bootstrapped = True


def get_kernel(name: str) -> KernelDef:
    """The :class:`KernelDef` registered under ``name``."""
    _ensure_registered()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"no kernel {name!r} registered; have {sorted(_REGISTRY)}") from None


def registered_kernels() -> Mapping[str, KernelDef]:
    """A copy of the registry (tests enumerate it)."""
    _ensure_registered()
    return dict(_REGISTRY)


# ---------------------------------------------------------------------------
# devices
# ---------------------------------------------------------------------------


def resolve_device(device: Any = "cuda") -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (the default of every
    entry point) raises when CUDA is absent: the CPU runs only when the
    caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for, but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', not {str(dev)!r}")
    return dev


def kernel_device(*tensors: torch.Tensor) -> torch.device:
    """The one device all operands of a kernel lie on (CPU or CUDA); raises
    on mixed or other devices."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"kernel operands lie on different devices: {sorted(map(str, devs))}")
    (dev,) = devs
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"repro_torch kernels run on 'cuda' or 'cpu', not {str(dev)!r}")
    return dev


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------

_launches: Dict[str, int] = {}
_launch_lock = threading.Lock()


def count_launch(kernel: str) -> None:
    """Called by a kernel wrapper right after it launched ``kernel``."""
    with _launch_lock:
        _launches[kernel] = _launches.get(kernel, 0) + 1


def launch_counts() -> Dict[str, int]:
    """Launches per kernel since the last :func:`reset_launch_counts`."""
    with _launch_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _launch_lock:
        _launches.clear()


# ---------------------------------------------------------------------------
# dispatch and the public wrappers
# ---------------------------------------------------------------------------


def dispatch(name: str, *args, **kwargs):
    """Run kernel ``name`` on the device its tensor operands lie on: its
    kernel wrappers launch the hand-written kernel for CUDA tensors and run
    the plain version for CPU ones (see :func:`kernel_device`)."""
    return get_kernel(name).impl(*args, **kwargs)


def ewise_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Elementwise ``x + y`` (matching shapes; ``y`` is cast to ``x``'s
    dtype, int32 wraps)."""
    return dispatch("ewise_add", x, y)


def relu(x: torch.Tensor) -> torch.Tensor:
    """Elementwise ``max(x, 0)``."""
    return dispatch("relu", x)


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    stride: int = 1,
    padding: int = 0,
    x_bits: Optional[int] = None,
    w_bits: Optional[int] = None,
) -> torch.Tensor:
    """2-D convolution ``(N, C, H, W) × (OC, C, KH, KW) → (N, OC, OH, OW)``.

    Integer inputs accumulate in int32 (wrapping), float inputs in float32.
    ``x_bits``/``w_bits`` are the simulator lowering's precision hints; they
    do not change the math and are ignored here.
    """
    return dispatch("conv2d", x, w, stride=stride, padding=padding,
                    x_bits=x_bits, w_bits=w_bits)


def maxpool2d(x: torch.Tensor, *, window: int = 2, stride: Optional[int] = None) -> torch.Tensor:
    """Window max pooling ``(N, C, H, W) → (N, C, OH, OW)`` (no padding;
    ``stride`` defaults to ``window``)."""
    return dispatch("maxpool2d", x, window=window, stride=stride)


def avgpool2d(x: torch.Tensor, *, window: int = 2) -> torch.Tensor:
    """Window average pooling, stride == window; integer inputs floor-divide
    by the window count."""
    return dispatch("avgpool2d", x, window=window)


def global_avgpool(x: torch.Tensor) -> torch.Tensor:
    """Global spatial average ``(N, C, H, W) → (N, C)``; integer inputs
    floor-divide by H·W."""
    return dispatch("global_avgpool", x)


def int_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    x_bits: Optional[int] = None,
    w_bits: Optional[int] = None,
) -> torch.Tensor:
    """Raw-integer ``(M, K) @ (K, N)`` with int32 accumulation (wrapping)."""
    return dispatch("int_matmul", x, w, x_bits=x_bits, w_bits=w_bits)

