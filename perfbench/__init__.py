"""The benchmark of ``repro_torch`` on one NVIDIA H100: one command runs one
cell (a model configuration under a traffic mix) for a fixed window and
prints one JSON line (``perfbench/run.py``)."""
