"""PyTorch and CUDA port of the ``repro`` package, for NVIDIA Hopper.

The port keeps the JAX package's layout and names (``repro_torch.kernels``,
``repro_torch.models``) and imports nothing from it: what it shares with the
JAX package, it keeps as its own copy.  Every Pallas kernel on a ported path
is replaced by a CUDA C++ kernel written for ``sm_90a``
(``repro_torch/kernels/csrc``); a tensor on the CPU runs the kernel's plain
PyTorch version instead.
"""
