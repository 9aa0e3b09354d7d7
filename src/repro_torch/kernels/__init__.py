"""Kernel package of the PyTorch port — the public surface is
:mod:`repro_torch.kernels.api`."""
