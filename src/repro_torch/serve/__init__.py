"""Serving of the PyTorch port: the batched LLM engine
(:mod:`repro_torch.serve.engine`), the integer attention decode programs
(:mod:`repro_torch.serve.pimsab_step`) and the continuous-batching
scheduler over them (:mod:`repro_torch.serve.scheduler`)."""
from repro_torch.serve import scheduler  # noqa: F401
