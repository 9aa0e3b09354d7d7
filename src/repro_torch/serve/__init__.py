"""Serving of the PyTorch port: the batched LLM engine
(:mod:`repro_torch.serve.engine`) and the integer attention decode programs
(:mod:`repro_torch.serve.pimsab_step`)."""
