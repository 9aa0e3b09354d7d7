"""The port's data pipeline (``data/pipeline.py``, a copy of the JAX
package's: numpy and the standard library only)."""
