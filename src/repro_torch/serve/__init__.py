"""Serving of the PyTorch port: the integer attention decode programs
(:mod:`repro_torch.serve.pimsab_step`)."""
